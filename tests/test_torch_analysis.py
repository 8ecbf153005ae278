"""The port's analysis package against the JAX package's.

Both packages run ``test_torch_slice.CONFIG`` (2,048 packets, one
convergence iteration, 4,096 in the final one) with last-interaction
tracking at its default (on).

- ``LastLineInteraction`` and ``LineInfo`` fed the same rows (the JAX
  run's, rebuilt as the port's f32 device rows, which give back the JAX
  package's f64 values exactly) give the JAX package's tables exactly, in
  both filter modes and all three group modes, with and without a window.
  From each package's own run the tables are equal on the packets whose
  rows agree (status, type and line ids equal, frequencies within 1e-6).
  Neither reads the per-packet rows on the host: the result's host views
  raise in those tests.
- ``OpacityCalculator`` on the same inputs (the JAX plasma state's tau
  table, t_rad and n_e as numpy) agrees to rtol 1e-10 in every property,
  for both bin scalings and after a change of ``nbins``; on the port's own
  plasma state it takes K3's tau table as the tensor it is.
- ``shell_info_table`` and ``ion_fraction_table`` agree at the port's
  per-iteration bars (t_rad 2.2e-4, W 1e-3, n_e 2e-3).
- ``TARDISHistory`` reads the file the port's ``simulation_to_hdf`` wrote
  into the same frames as the JAX ``TARDISHistory``.
"""

import copy
import dataclasses
import types

import numpy as np
import pytest
import torch

from tardis_torch.analysis.last_interaction import (
    LastLineInteraction as TorchLLI,
)
from tardis_torch.analysis.line_info import LineInfo as TorchLineInfo
from tardis_torch.analysis.opacities import (
    OpacityCalculator as TorchOpacityCalculator,
)
from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.config.reader import config_from_dict as torch_config
from tardis_torch.simulation.base import Simulation as TorchSimulation
from tardis_torch.transport.solver import TransportResult
from tardis_torch.transport.tables import NU_UNIT
from tardis_tpu.analysis.last_interaction import LastLineInteraction
from tardis_tpu.analysis.line_info import LineInfo
from tardis_tpu.analysis.opacities import OpacityCalculator
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.constants import C
from tardis_tpu.simulation.base import Simulation

from tests.test_torch_slice import CONFIG

torch.set_num_threads(2)

ANALYSIS_CONFIG = copy.deepcopy(CONFIG)
ANALYSIS_CONFIG["montecarlo"]["iterations"] = 2
del ANALYSIS_CONFIG["montecarlo"]["tracking"]
OPACITY_RTOL = 1e-10
T_RAD_RTOL = 2.2e-4
W_RTOL = 1e-3
N_E_RTOL = 2e-3
# (start, end) Angstrom; None: no window
WINDOWS = {"all": None, "optical": (3000.0, 7000.0)}
FILTER_MODES = ("packet_out_nu", "packet_in_nu")
GROUP_MODES = ("both", "exc", "de-exc")


@pytest.fixture(scope="module")
def sims(atom_data_prepared):
    ref = Simulation.from_config(config_from_dict(copy.deepcopy(
        ANALYSIS_CONFIG)), atom_data=atom_data_prepared)
    ref.run_convergence()
    ref.run_final()
    port = TorchSimulation.from_config(
        torch_config(copy.deepcopy(ANALYSIS_CONFIG)),
        atom_data=atom_data_from_arrays(
            atom_data_to_arrays(atom_data_prepared)),
        device="cpu")
    with torch.no_grad():
        port.run()
    return ref, port


def rows_as_port_result(res, time_explosion) -> TransportResult:
    """The JAX result's packet outputs and last-interaction rows as the
    port's f32 kernel-unit rows (x U / U rounds back to the f32 value), on
    the CPU."""
    li = res.last_interaction
    sign = np.where(res.output_status == 1, 1.0,
                    np.where(res.output_status == 2, -1.0, 0.0))
    out = np.stack((sign * res.output_nu / NU_UNIT,
                    res.output_energy * res.n_packets), axis=1)
    ct = C * time_explosion
    rows = np.stack((li["type"], li["in_line"], li["out_line"], li["shell"],
                     li["in_nu"] / NU_UNIT, li["r"] / ct), axis=1)
    return TransportResult(
        _out=torch.as_tensor(out.astype(np.float32)),
        j_estimator=None, nu_bar_estimator=None, j_blue_estimator=None,
        edot_lu_estimator=None, time_of_simulation=res.time_of_simulation,
        n_packets=res.n_packets, n_events=0.0, n_immortal=0,
        _lum_cache=(0.0, 0.0, 0.0, 0.0),
        _li=torch.as_tensor(rows.astype(np.float32)), length_unit=ct)


def jax_rows(res, keep):
    """A JAX-package result holding only the ``keep`` packets."""
    return types.SimpleNamespace(
        last_interaction={k: v[keep] for k, v in
                          res.last_interaction.items()},
        output_status=res.output_status[keep],
        output_nu=res.output_nu[keep])


@pytest.fixture(scope="module")
def same_rows(sims):
    ref, port = sims
    res = ref.last_transport_result
    rows = rows_as_port_result(res, ref.state.time_explosion)
    return res, rows, ref.atom_data, port.atom_data


@pytest.fixture
def no_host_rows(monkeypatch):
    """The port result's host views of its per-packet rows raise: the
    analysis must reduce on the rows' device."""
    def refuse(self):
        raise AssertionError("per-packet rows read on the host")

    for name in ("last_interaction", "output_nu", "output_status",
                 "output_energy"):
        monkeypatch.setattr(TransportResult, name, property(refuse))


def _set_window(lli, window):
    if window is not None:
        lli.set_wavelength_range(window[0] * 1e-8, window[1] * 1e-8)
    return lli


def test_rows_round_trip(same_rows):
    """The rebuilt rows give back the JAX package's values exactly."""
    res, rows, _, _ = same_rows
    for key in ("type", "in_line", "out_line", "shell", "in_nu"):
        np.testing.assert_array_equal(rows.last_interaction[key],
                                      res.last_interaction[key], err_msg=key)
    np.testing.assert_array_equal(rows.output_nu, res.output_nu)
    np.testing.assert_array_equal(rows.output_status, res.output_status)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("filter_mode", FILTER_MODES)
def test_last_line_tables_same_rows(same_rows, no_host_rows, filter_mode,
                                    window):
    import pandas as pd

    res, rows, atom, port_atom = same_rows
    ref = _set_window(LastLineInteraction(
        res, atom, packet_filter_mode=filter_mode), WINDOWS[window])
    ours = _set_window(TorchLLI(
        rows, port_atom, packet_filter_mode=filter_mode), WINDOWS[window])
    assert isinstance(ours._mask(), torch.Tensor)
    for name in ("last_line_in", "last_line_out"):
        table = getattr(ours, name)
        assert len(table) > 0, name
        pd.testing.assert_frame_equal(table, getattr(ref, name))
    pd.testing.assert_series_equal(ours.species_counts(),
                                   ref.species_counts())


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("filter_mode", FILTER_MODES)
def test_line_info_same_rows(same_rows, no_host_rows, filter_mode, window):
    import pandas as pd

    res, rows, atom, port_atom = same_rows
    wl = WINDOWS[window] or (500.0, 20000.0)
    ref, ours = LineInfo(res, atom), TorchLineInfo(rows, port_atom)
    species = ref.get_species_interactions(wl, filter_mode=filter_mode)
    pd.testing.assert_frame_equal(
        ours.get_species_interactions(wl, filter_mode=filter_mode), species)
    assert len(species) >= 2
    for sp in species.index[:3]:
        for group_mode in GROUP_MODES:
            kw = dict(wavelength_range=WINDOWS[window],
                      filter_mode=filter_mode, group_mode=group_mode)
            expected = ref.get_last_line_counts(sp, **kw)
            assert expected["No. of packets"].sum() > 0
            pd.testing.assert_frame_equal(
                ours.get_last_line_counts(sp, **kw), expected)
    with pytest.raises(ValueError, match="filter_mode"):
        ours.get_species_interactions(wl, filter_mode="bad")
    with pytest.raises(ValueError, match="group_mode"):
        ours.get_last_line_counts(species.index[0], group_mode="bad")


def test_tables_from_own_runs(sims):
    """Each package's own run: on the packets whose rows agree the tables
    are equal."""
    import pandas as pd

    ref, port = sims
    res_j, res_p = ref.last_transport_result, port.last_transport_result
    li_j, li_p = res_j.last_interaction, res_p.last_interaction

    def close(a, b):
        return np.abs(a - b) <= 1e-6 * np.abs(b)

    agree = ((res_p.output_status == res_j.output_status)
             & close(res_p.output_nu, res_j.output_nu)
             & close(li_p["in_nu"], li_j["in_nu"]))
    for key in ("type", "in_line", "out_line", "shell"):
        agree &= li_p[key] == li_j[key]
    assert agree.mean() >= 0.95, agree.mean()
    keep = torch.as_tensor(agree)
    ours_rows = dataclasses.replace(res_p, _out=res_p._out[keep],
                                    _li=res_p._li[keep])
    for filter_mode in FILTER_MODES:
        for window in WINDOWS.values():
            ours = _set_window(TorchLLI(ours_rows, port.atom_data,
                                        packet_filter_mode=filter_mode),
                               window)
            theirs = _set_window(LastLineInteraction(
                jax_rows(res_j, agree), ref.atom_data,
                packet_filter_mode=filter_mode), window)
            for name in ("last_line_in", "last_line_out"):
                pd.testing.assert_frame_equal(getattr(ours, name),
                                              getattr(theirs, name))
    sp = LineInfo(jax_rows(res_j, agree), ref.atom_data) \
        .get_species_interactions((500.0, 20000.0)).index[0]
    for group_mode in GROUP_MODES:
        pd.testing.assert_frame_equal(
            TorchLineInfo(ours_rows, port.atom_data).get_last_line_counts(
                sp, group_mode=group_mode),
            LineInfo(jax_rows(res_j, agree), ref.atom_data)
            .get_last_line_counts(sp, group_mode=group_mode))


def test_untracked_run_is_refused(sims):
    _, port = sims
    res = port.last_transport_result
    untracked = dataclasses.replace(res, _li=None)
    with pytest.raises(ValueError, match="last-interaction tracking"):
        TorchLLI(untracked, port.atom_data)


OPACITY_PROPERTIES = ("nu_bins", "kappa_exp", "kappa_thom", "kappa_thom_grid",
                      "kappa_tot", "planck_kappa", "planck_delta_tau",
                      "planck_tau")


@pytest.mark.parametrize("bin_scaling", ("log", "linear"))
def test_opacity_calculator_same_inputs(sims, bin_scaling):
    """On the JAX simulation itself (its host tau table, t_rad and n_e as
    numpy): every property within 1e-10, before and after nbins changes
    (which drops the caches)."""
    ref, _ = sims
    assert isinstance(ref.plasma_state.tau_sobolev, np.ndarray)
    theirs = OpacityCalculator(ref, nbins=80, bin_scaling=bin_scaling)
    ours = TorchOpacityCalculator(ref, nbins=80, bin_scaling=bin_scaling)
    for nbins in (80, 40):
        ours.nbins = theirs.nbins = nbins
        assert ours.kappa_exp.shape == (nbins, ref.state.no_of_shells)
        assert (ours.kappa_exp > 0).any()
        for name in OPACITY_PROPERTIES:
            np.testing.assert_allclose(getattr(ours, name),
                                       getattr(theirs, name),
                                       rtol=OPACITY_RTOL, err_msg=name)
    ours.bin_scaling = "cubic"
    with pytest.raises(ValueError, match="bin_scaling"):
        ours.nu_bins


def test_opacity_calculator_reads_the_device_table(sims):
    """On the port's own plasma state the tau table is taken as the tensor
    it is: equal to the same table given as numpy, and within 1e-10 of the
    JAX package on that table."""
    _, port = sims
    ps = port.plasma_state
    assert isinstance(ps.tau_sobolev, torch.Tensor)
    ours = TorchOpacityCalculator(port)
    copied = types.SimpleNamespace(
        state=port.state, atom_data=port.atom_data,
        plasma_state=types.SimpleNamespace(
            tau_sobolev=ps.tau_sobolev.numpy(),
            electron_densities=ps.electron_densities))
    theirs = OpacityCalculator(copied)
    assert ours.kappa_exp.shape == (300, port.state.no_of_shells)
    np.testing.assert_array_equal(ours.kappa_exp,
                                  TorchOpacityCalculator(copied).kappa_exp)
    for name in OPACITY_PROPERTIES:
        np.testing.assert_allclose(getattr(ours, name), getattr(theirs, name),
                                   rtol=OPACITY_RTOL, err_msg=name)
    with pytest.raises(ValueError, match="plasma state"):
        TorchOpacityCalculator(types.SimpleNamespace(plasma_state=None))


def test_shell_info_table(sims):
    from tardis_torch.analysis.shell_info import shell_info_table
    from tardis_tpu.analysis.shell_info import shell_info_table as ref_table

    ref, port = sims
    ours, theirs = shell_info_table(port), ref_table(ref)
    assert list(ours.columns) == list(theirs.columns)
    assert ours.index.name == theirs.index.name == "shell"
    rtol = {"t_rad[K]": T_RAD_RTOL, "t_electron[K]": T_RAD_RTOL,
            "w": W_RTOL, "n_e[1/cm3]": N_E_RTOL}
    for col in ours.columns:
        np.testing.assert_allclose(ours[col], theirs[col],
                                   rtol=rtol.get(col, 1e-14), err_msg=col)


@pytest.mark.parametrize("z", (8, 14, 20))
def test_ion_fraction_table(sims, z):
    from tardis_torch.analysis.shell_info import ion_fraction_table
    from tardis_tpu.analysis.shell_info import (
        ion_fraction_table as ref_fractions,
    )

    ref, port = sims
    ours, theirs = ion_fraction_table(port, z), ref_fractions(ref, z)
    assert list(ours.columns) == list(theirs.columns)
    np.testing.assert_allclose(ours.to_numpy(), theirs.to_numpy(),
                               rtol=N_E_RTOL, atol=1e-12)
    np.testing.assert_allclose(ours.sum(axis=1), 1.0, rtol=1e-12)
    with pytest.raises(ValueError, match="not in simulation"):
        ion_fraction_table(port, 26)


def test_tardis_history_reads_the_port_file(sims, tmp_path):
    pytest.importorskip("h5py")
    import matplotlib
    import pandas as pd

    matplotlib.use("Agg")

    from tardis_torch.analysis.history import TARDISHistory as TorchHistory
    from tardis_torch.io.hdf import simulation_to_hdf
    from tardis_tpu.analysis.history import TARDISHistory

    _, port = sims
    path = str(tmp_path / "port.h5")
    simulation_to_hdf(port, path)
    ours, theirs = TorchHistory(path), TARDISHistory(path)
    np.testing.assert_array_equal(ours.iterations, theirs.iterations)
    assert len(ours.iterations) == len(port.history) == 1
    for name, args in (("load_t_rads", ()), ("load_ws", (0,)),
                       ("load_electron_densities", ()),
                       ("load_luminosities", ())):
        frame = getattr(ours, name)(*args)
        pd.testing.assert_frame_equal(frame, getattr(theirs, name)(*args))
    np.testing.assert_array_equal(ours.load_t_inner(), theirs.load_t_inner())
    np.testing.assert_array_equal(ours.load_t_rads()["iter000"],
                                  port.history[0].t_radiative)
    assert len(ours.plot_t_rads().lines) == len(port.history)
    with pytest.raises(KeyError, match="no iteration history"):
        TorchHistory(path, name="nothing")
