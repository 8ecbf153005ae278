"""The port's convergence plots and widgets against the JAX package's.

Both packages run ``test_torch_slice.CONFIG`` (3 iterations, tracking at
its default) under matplotlib's Agg backend with a ``ConvergencePlots``
fed by the simulation's callback: the port's traces hold the JAX
package's at the port's per-iteration bars (t_rad and t_inner 2.2e-4,
W 1e-3, emitted luminosity 1e-3), and each writes one frame a callback.
``plot_convergence`` draws the stored history, and
``StandardTARDISWorkflow(show_convergence_plots=True)`` runs and draws it
(without the flag, and in ``SimpleTARDISWorkflow``, nothing is drawn).
The widgets' tables equal the JAX widgets' tables on the same data: the
shell info from the same arrays and from the same HDF file, the line info
from the same last-interaction rows; their ipywidgets layouts build
headless.
"""

import copy

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tardis_torch.atomic.convert import (  # noqa: E402
    atom_data_from_arrays,
    atom_data_to_arrays,
)
from tardis_torch.config.reader import config_from_dict as torch_config  # noqa: E402
from tardis_torch.simulation.base import Simulation as TorchSimulation  # noqa: E402
from tardis_torch.visualization import convergence as torch_convergence  # noqa: E402
from tardis_torch.visualization import widgets as torch_widgets  # noqa: E402
from tardis_tpu.config.reader import config_from_dict  # noqa: E402
from tardis_tpu.simulation.base import Simulation  # noqa: E402
from tardis_tpu.visualization import convergence  # noqa: E402
from tardis_tpu.visualization import widgets  # noqa: E402

from tests.test_torch_analysis import rows_as_port_result  # noqa: E402
from tests.test_torch_slice import CONFIG  # noqa: E402

torch.set_num_threads(2)

VIZ_CONFIG = copy.deepcopy(CONFIG)
del VIZ_CONFIG["montecarlo"]["tracking"]
T_RAD_RTOL = 2.2e-4
W_RTOL = 1e-3
L_RTOL = 1e-3


def _port_atom(atom):
    return atom_data_from_arrays(atom_data_to_arrays(atom))


@pytest.fixture(scope="module")
def runs(atom_data_prepared, tmp_path_factory):
    """Both packages' simulations with a ConvergencePlots on their
    callback, each writing frames to its own directory."""
    out = {}
    for package in ("jax", "torch"):
        frames = tmp_path_factory.mktemp(f"frames_{package}")
        if package == "jax":
            sim = Simulation.from_config(
                config_from_dict(copy.deepcopy(VIZ_CONFIG)),
                atom_data=atom_data_prepared)
            cp = convergence.ConvergencePlots(frame_dir=str(frames))
        else:
            sim = TorchSimulation.from_config(
                torch_config(copy.deepcopy(VIZ_CONFIG)),
                atom_data=_port_atom(atom_data_prepared), device="cpu")
            cp = torch_convergence.ConvergencePlots(frame_dir=str(frames))
        sim.add_callback(cp.update)
        with torch.no_grad():
            sim.run_convergence()
            sim.run_final()
        out[package] = (sim, cp, frames)
    return out


def test_convergence_traces_match_jax(runs):
    (sim_j, cp_j, frames_j), (sim, cp, frames) = runs["jax"], runs["torch"]
    # two convergence iterations and the final one call back
    assert cp.iterations == cp_j.iterations == [0, 1, 2]
    np.testing.assert_array_equal(cp.v_mid, cp_j.v_mid)
    assert cp.l_requested == cp_j.l_requested
    for name, rtol in (("t_rad_traces", T_RAD_RTOL), ("w_traces", W_RTOL),
                       ("t_inner_trace", T_RAD_RTOL),
                       ("l_emitted_trace", L_RTOL)):
        ours, theirs = getattr(cp, name), getattr(cp_j, name)
        assert len(ours) == len(theirs) == 3, name
        np.testing.assert_allclose(ours, theirs, rtol=rtol, err_msg=name)
    names = sorted(p.name for p in frames.iterdir())
    assert names == sorted(p.name for p in frames_j.iterdir()) == [
        "convergence_001.png", "convergence_002.png", "convergence_003.png"]
    axes = cp.figure.axes
    assert len(axes) == 4
    assert len(axes[0].lines) == len(cp.t_rad_traces)
    assert axes[1].get_ylabel() == cp_j.figure.axes[1].get_ylabel() == "W"


def test_plot_convergence(runs, tmp_path):
    (sim_j, _, _), (sim, _, _) = runs["jax"], runs["torch"]
    path = tmp_path / "convergence.png"
    fig = torch_convergence.plot_convergence(sim, save_path=str(path))
    fig_j = convergence.plot_convergence(sim_j)
    assert path.stat().st_size > 0
    for ax, ax_j in zip(fig.axes, fig_j.axes, strict=True):
        assert len(ax.lines) == len(ax_j.lines)
        assert ax.get_ylabel() == ax_j.get_ylabel()
    np.testing.assert_allclose(fig.axes[2].lines[0].get_ydata(),
                               fig_j.axes[2].lines[0].get_ydata(),
                               rtol=T_RAD_RTOL)
    empty = copy.copy(sim)
    empty.history = []
    with pytest.raises(ValueError, match="no iteration history"):
        torch_convergence.plot_convergence(empty)


@pytest.mark.parametrize("workflow, plots", (("standard", True),
                                             ("standard", False),
                                             ("simple", None)))
def test_workflow_draws_the_plots_when_asked(atom_data_prepared, monkeypatch,
                                             workflow, plots):
    """StandardTARDISWorkflow(show_convergence_plots=True) runs and draws
    the plots once, after the final iteration; without the flag, and in
    SimpleTARDISWorkflow, which has none, nothing is drawn."""
    from tardis_torch.workflows.simple import (
        SimpleTARDISWorkflow,
        StandardTARDISWorkflow,
    )

    drawn = []
    plot = torch_convergence.plot_convergence
    monkeypatch.setattr(torch_convergence, "plot_convergence",
                        lambda sim, **kw: drawn.append(plot(sim, **kw)))
    cfg = copy.deepcopy(CONFIG)
    cfg["montecarlo"]["iterations"] = 2
    kw = dict(atom_data=_port_atom(atom_data_prepared), device="cpu")
    if workflow == "standard":
        wf = StandardTARDISWorkflow(cfg, show_convergence_plots=plots,
                                    show_progress_bars=False, **kw)
    else:
        wf = SimpleTARDISWorkflow(cfg, **kw)
    wf.run()
    assert wf.completed and len(wf.sim.history) == 1
    assert len(drawn) == (1 if plots else 0)
    if plots:
        assert len(drawn[0].axes[0].lines) == len(wf.sim.history)


def _shell_arrays(d):
    return (d.t_radiative, d.dilution_factor, d.atomic_numbers, d.abundance,
            d.number_density, d.ion_number_density, d.ion_z, d.ion_stage)


def _level_arrays(d):
    return dict(level_number_density=d.level_number_density,
                level_z=d.level_z, level_ion=d.level_ion,
                level_number=d.level_number)


def _assert_same_tables(ours, theirs):
    import pandas as pd

    pd.testing.assert_frame_equal(ours.shells_data(), theirs.shells_data())
    for shell in (1, 7):
        pd.testing.assert_frame_equal(ours.element_count(shell),
                                      theirs.element_count(shell))
        for z in theirs.atomic_numbers[:3]:
            ions = theirs.ion_count(int(z), shell)
            pd.testing.assert_frame_equal(ours.ion_count(int(z), shell),
                                          ions)
            for ion in ions.index[:2]:
                pd.testing.assert_frame_equal(
                    ours.level_count(int(ion), int(z), shell),
                    theirs.level_count(int(ion), int(z), shell))


def test_shell_info_widget_same_arrays(runs):
    (sim_j, _, _), (sim, _, _) = runs["jax"], runs["torch"]
    theirs = widgets.SimulationShellInfo(sim_j)
    ours = torch_widgets.BaseShellInfo(*_shell_arrays(theirs),
                                       **_level_arrays(theirs))
    _assert_same_tables(ours, theirs)
    # the port's own simulation: the same layout, at the per-iteration bars
    own = torch_widgets.SimulationShellInfo(sim)
    for name in ("atomic_numbers", "ion_z", "ion_stage", "level_z",
                 "level_ion", "level_number", "abundance"):
        np.testing.assert_array_equal(getattr(own, name),
                                      getattr(theirs, name), err_msg=name)
    np.testing.assert_allclose(own.t_radiative, theirs.t_radiative,
                               rtol=T_RAD_RTOL)
    np.testing.assert_allclose(own.dilution_factor, theirs.dilution_factor,
                               rtol=W_RTOL)
    np.testing.assert_allclose(own.number_density, theirs.number_density,
                               rtol=1e-14)
    fr = own.ion_count(14, 1).iloc[:, 1].astype(float)
    np.testing.assert_allclose(fr.sum(), 1.0, atol=1e-3)
    layout = torch_widgets.shell_info_from_simulation(sim).display()
    assert type(layout).__name__ == "HBox"


def test_shell_info_widget_from_hdf(runs, tmp_path):
    pytest.importorskip("h5py")
    from tardis_torch.io.hdf import simulation_to_hdf

    _, (sim, _, _) = runs["jax"], runs["torch"]
    path = str(tmp_path / "port.h5")
    simulation_to_hdf(sim, path)
    ours = torch_widgets.shell_info_from_hdf(path)
    theirs = widgets.shell_info_from_hdf(path)
    _assert_same_tables(ours.data, theirs.data)
    own = torch_widgets.SimulationShellInfo(sim)
    np.testing.assert_allclose(ours.data.ion_number_density,
                               own.ion_number_density, rtol=1e-15)
    assert type(ours.display()).__name__ == "HBox"


def test_line_info_widget_same_rows(runs):
    """The port's widget on the JAX run's rows (rebuilt as the port's
    device rows) gives the JAX widget's tables."""
    import pandas as pd

    (sim_j, _, _), (sim, _, _) = runs["jax"], runs["torch"]
    theirs = widgets.LineInfoWidget.from_simulation(sim_j)
    same = copy.copy(sim)
    same.last_transport_result = rows_as_port_result(
        sim_j.last_transport_result, sim_j.state.time_explosion)
    same.spectrum_real = sim_j.spectrum_real
    ours = torch_widgets.LineInfoWidget.from_simulation(same)
    np.testing.assert_array_equal(ours.wavelength, theirs.wavelength)
    for wl in ((500.0, 20000.0), (3000.0, 7000.0)):
        for filter_mode in ("packet_out_nu", "packet_in_nu"):
            species = theirs.get_species_interactions(
                wl, filter_mode=filter_mode)
            pd.testing.assert_frame_equal(
                ours.get_species_interactions(wl, filter_mode=filter_mode),
                species)
            for group_mode in ("both", "exc", "de-exc"):
                kw = dict(wavelength_range=wl, filter_mode=filter_mode,
                          group_mode=group_mode)
                pd.testing.assert_frame_equal(
                    ours.get_last_line_counts(species.index[0], **kw),
                    theirs.get_last_line_counts(species.index[0], **kw))
    own = torch_widgets.LineInfoWidget.from_simulation(sim)
    assert len(own.get_species_interactions((500.0, 20000.0))) > 0
    assert own.plot_spectrum(wavelength_range=(3000.0, 7000.0)) is not None
    assert type(own.display()).__name__ == "VBox"
    no_spectrum = copy.copy(sim)
    no_spectrum.spectrum_real = None
    with pytest.raises(ValueError, match="no spectrum"):
        torch_widgets.LineInfoWidget(no_spectrum)
