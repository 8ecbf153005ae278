"""The port's six visualization modules against the JAX package's.

One finished port simulation (``test_plasma.BASE_CONFIG`` in macroatom
mode, 2 iterations of 2,048 packets and a final one of 4,096, 3 virtual
packets a record with vpacket logging, last-interaction rows and a
16-event r-packet tracker) feeds both packages' plotters: the JAX classes
are numpy over the result's host arrays, the port's take the same numbers
in torch on the result's device, so every array is compared on the same
run.  Sums taken in another order (bincount against np.histogram, a
cumulative sum of angle steps against a loop) agree within RTOL;
everything else is equal.  The figures are drawn to the Agg backend;
the plotly figures are held call for call under a recording stub of
``plotly.graph_objects`` that the tests put in ``sys.modules`` (plotly is
not installed).  Mirrors ``tests/test_analysis_viz.py`` and
``tests/test_sdec_vpackets.py``; the SDEC virtual mode also runs on a
continuum run with type-3 virtual packets
(``test_torch_continuum_vpackets.py``'s problem).
"""

import copy
import sys
from types import ModuleType, SimpleNamespace

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tardis_torch.atomic.convert import (  # noqa: E402
    atom_data_from_arrays,
    atom_data_to_arrays,
)
from tardis_torch.config.reader import config_from_dict  # noqa: E402
from tardis_torch.simulation.base import Simulation  # noqa: E402
from tardis_torch.visualization import (  # noqa: E402
    custom_abundance,
    grotrian,
    lineid,
    liv,
    rpacket,
    sdec,
)
from tardis_tpu.config.reader import (  # noqa: E402
    config_from_dict as jax_config,
)
from tardis_tpu.model.state import SimulationState as JaxState  # noqa: E402
from tardis_tpu.visualization import custom_abundance as j_custom  # noqa
from tardis_tpu.visualization import grotrian as j_grotrian  # noqa: E402
from tardis_tpu.visualization import lineid as j_lineid  # noqa: E402
from tardis_tpu.visualization import liv as j_liv  # noqa: E402
from tardis_tpu.visualization import rpacket as j_rpacket  # noqa: E402
from tardis_tpu.visualization import sdec as j_sdec  # noqa: E402

from tests.test_plasma import BASE_CONFIG  # noqa: E402

torch.set_num_threads(2)

# sums of up to ~1e3 f64 terms in another order (measured: 5.1e-12)
RTOL = 1e-10
CONFIG = copy.deepcopy(BASE_CONFIG)
CONFIG["plasma"]["line_interaction_type"] = "macroatom"
CONFIG["montecarlo"].update(no_of_packets=2048, last_no_of_packets=4096,
                            no_of_virtual_packets=3, iterations=2,
                            tracking={"track_rpacket": True,
                                      "initial_array_length": 16})
CONFIG["spectrum"]["virtual"] = {"virtual_packet_logging": True}


@pytest.fixture(scope="module")
def sim(atom_data_prepared):
    s = Simulation.from_config(
        config_from_dict(copy.deepcopy(CONFIG)),
        atom_data=atom_data_from_arrays(
            atom_data_to_arrays(atom_data_prepared)),
        device="cpu")
    s.run_convergence()
    s.run_final()
    return s


def _same_components(a, b):
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=0.0,
                                   err_msg=k)


@pytest.mark.parametrize("mode", ["real", "virtual"])
def test_sdec_decomposition_matches_jax(sim, mode):
    """Every emission and absorption component, in the same order, within
    RTOL of the JAX plotter's on the same result; the components add up to
    the emitted luminosity in range (real) or to the virtual spectrum
    (virtual, within 5%, as the JAX test holds it); the figure draws."""
    edges = sim.spectrum_nu_edges
    p = sdec.SDECPlotter(sim)
    em, ab = p._decompose(edges, mode)
    j_em, j_ab = j_sdec.SDECPlotter(sim)._decompose(edges, mode)
    _same_components(em, j_em)
    _same_components(ab, j_ab)
    assert "photosphere" in em and "e-scattering" in em and ab
    assert [k for k in em if k not in ("photosphere", "e-scattering")]
    total = (sum(em.values()) * np.abs(np.diff(edges))).sum()
    res = sim.last_transport_result
    if mode == "real":
        in_rng = ((res.output_nu >= edges.min())
                  & (res.output_nu < edges.max()) & res.emitted_mask)
        want = res.output_energy[in_rng].sum() / res.time_of_simulation
        np.testing.assert_allclose(total, want, rtol=1e-6)
    else:
        np.testing.assert_allclose(
            total, res.virt_energy_hist.sum() / res.time_of_simulation,
            rtol=0.05)
    plt.close(p.generate_plot_mpl(packets_mode=mode))


@pytest.mark.parametrize("species,nelements", [
    (["Si"], None), (["Si II", "Ca", "S I-III"], None), (None, 1),
    (None, 3)])
def test_sdec_filter_and_topn_match_jax(sim, species, nelements):
    """Species filters and top-N folding: the port's components equal the
    JAX plotter's; a filter keeps only its species, top-N folds the rest
    into "other"."""
    edges = sim.spectrum_nu_edges
    filt = sdec._parse_species_list(species)
    assert filt == j_sdec._parse_species_list(species)
    em, ab = sdec.SDECPlotter(sim)._decompose(edges, "real", filt, nelements)
    j_em, j_ab = j_sdec.SDECPlotter(sim)._decompose(edges, "real", filt,
                                                     nelements)
    _same_components(em, j_em)
    _same_components(ab, j_ab)
    labels = [k for k in em if k not in ("photosphere", "e-scattering")]
    if species == ["Si"]:
        assert labels and all(k.startswith("Si") for k in labels)
    if nelements == 1:
        assert "other" in em


def test_sdec_flux_mode_options(sim):
    """distance / observed_spectrum / show_modeled_spectrum /
    blackbody_photosphere: the plotted total equals the JAX plotter's
    prepared total over 4 pi d^2, the photosphere curve the analytic
    Planck value; an observed spectrum without a distance is refused."""
    p = sdec.SDECPlotter(sim)
    wl, em_stack, _, labels_e, _, total = p._prep("real", None, None, None)
    j_wl, j_em, _, j_labels, _, j_total = j_sdec.SDECPlotter(sim)._prep(
        "real", None, None, None)
    np.testing.assert_array_equal(wl, j_wl)
    assert labels_e == j_labels
    np.testing.assert_allclose(total, j_total, rtol=RTOL)
    d = 10.0 * 3.0856775814913673e24
    obs = (wl, total / (4.0 * np.pi * d**2))
    fig = p.generate_plot_mpl(packets_mode="real", distance=d,
                              observed_spectrum=obs)
    lines = {ln.get_label(): ln for ln in fig.axes[0].get_lines()}
    assert {"total", "blackbody photosphere", "observed"} <= set(lines)
    np.testing.assert_allclose(lines["total"].get_ydata(), obs[1], rtol=RTOL)
    plt.close(fig)
    np.testing.assert_allclose(
        p._photosphere_luminosity_lambda(np.array([5000.0])),
        j_sdec.SDECPlotter(sim)._photosphere_luminosity_lambda(
            np.array([5000.0])), rtol=RTOL)
    fig = p.generate_plot_mpl(show_modeled_spectrum=False,
                              blackbody_photosphere=False)
    labels = [ln.get_label() for ln in fig.axes[0].get_lines()]
    assert "total" not in labels and "blackbody photosphere" not in labels
    plt.close(fig)
    with pytest.raises(ValueError):
        p.generate_plot_mpl(observed_spectrum=obs)
    with pytest.raises(ValueError):
        p.generate_plot_mpl(distance=0.0)


def test_sdec_virtual_continuum_run():
    """The SDEC virtual mode on a continuum run with virtual packets
    (``TransportSolver.run_iteration`` with the continuum state): its
    type-3 virtual packets (continuum processes) fall in no component, as
    in the JAX package, and the components equal the JAX plotter's."""
    from tardis_torch.transport.solver import TransportSolver

    from tests import test_torch_continuum_vpackets as cv

    prob = cv._problem(cv.CONFIG)
    _, tatom, _, tmacro = cv._macros(prob, False)
    res = TransportSolver("macroatom", vpacket_tracking=True,
                          track_last_interaction=True, mesh=None
                          ).run_iteration(
        prob["tstate"], prob["tps"], tatom, n_packets=cv.N, seed=cv.SEED,
        iteration=0, n_vpackets=cv.N_VPACKETS, spectrum_nu_edges=cv.EDGES,
        need_line_estimators=False, continuum_state=prob["tcont"],
        continuum_macro=tmacro)
    run = SimpleNamespace(last_transport_result=res, atom_data=tatom,
                          state=prob["tstate"],
                          spectrum_nu_edges=cv.EDGES)
    assert (res.vpackets["virt_packet_last_interaction_type"] == 3).any()
    em, ab = sdec.SDECPlotter(run)._decompose(cv.EDGES, "virtual")
    j_em, j_ab = j_sdec.SDECPlotter(run)._decompose(cv.EDGES, "virtual")
    _same_components(em, j_em)
    _same_components(ab, j_ab)
    plt.close(sdec.SDECPlotter(run).generate_plot_mpl(packets_mode="virtual"))


def test_lineid_plotter_styles(sim):
    """The three styles annotate every line with separated labels at the
    JAX plotter's positions; an unknown style is refused."""
    spec = sim.spectrum_real
    wl = 2.99792458e18 / np.asarray(spec.nu)
    y = np.asarray(spec.luminosity_nu)
    lines = [3950.0, 4000.0, 4020.0, 6150.0]
    labels = ["Ca II", "Si II", "S II", "Si II 6355"]
    np.testing.assert_array_equal(lineid._deoverlap(lines, 100.0),
                                  j_lineid._deoverlap(lines, 100.0))
    for style in ("top", "inside", "along"):
        axes = []
        for module in (lineid, j_lineid):
            fig, ax = plt.subplots()
            ax.plot(wl, y)
            module.lineid_plotter(ax, lines, labels, wl, y, style=style)
            axes.append(sorted(a.get_position()[0] for a in ax.texts))
            plt.close(fig)
        assert len(axes[0]) == len(lines) and axes[0] == axes[1]
        assert (np.diff(axes[0]) > 1.0).all()
    fig, ax = plt.subplots()
    with pytest.raises(ValueError):
        lineid.lineid_plotter(ax, lines, labels, wl, y, style="bogus")
    plt.close("all")


LIV_CASES = [
    dict(num_bins=10),
    dict(species_list=["Si"]),
    dict(species_list=["Si II", "S I-III"]),
    dict(nelements=2),
    dict(packet_wvl_range=(3000.0, 7000.0)),
    dict(packets_mode="virtual", num_bins=5),
]


@pytest.mark.parametrize("case", LIV_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_liv_matches_jax(sim, case):
    """Each group's velocities (in packet order), labels and bin edges
    equal the JAX plotter's, for every option; the step plot draws."""
    kw = dict(packets_mode="real", packet_wvl_range=None, species_list=None,
              nelements=None, num_bins=None)
    kw.update(case)
    p = liv.LIVPlotter.from_simulation(sim)
    p._prepare(**kw)
    j = j_liv.LIVPlotter.from_simulation(sim)
    j._prepare(**kw, cmapname="jet")
    assert p._species_name == j._species_name
    assert len(p.plot_data) == len(j.plot_data) >= 1
    for a, b in zip(p.plot_data, j.plot_data):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(p.bin_edges, j.bin_edges)
    x, y = p._step_data(p.plot_data[0], p.bin_edges)
    assert len(x) == len(y) == 2 * (len(p.bin_edges) - 1)
    ax = p.generate_plot_mpl(**{k: v for k, v in case.items()})
    assert len(ax.lines) == len(p.plot_data)
    plt.close(ax.figure)


def test_rpacket_coordinates_match_jax(sim):
    """The packets' (x, y) from the port's cumulative angle sum against
    the JAX plotter's step loop within RTOL of the outer shell's velocity;
    the radius from (x, y) equals the tracked one; padding synchronizes the
    trajectories; the figure and the debug packet log draw."""
    from tardis_torch.io.debug_packets import debug_packet_log

    p = rpacket.RPacketPlotter.from_simulation(sim, no_of_packets=5)
    j = j_rpacket.RPacketPlotter.from_simulation(sim, no_of_packets=5)
    xs, ys, tys = p.get_coordinates_multiple_packets()
    j_xs, j_ys, j_tys = j.get_coordinates_multiple_packets()
    vmax = p._shell_velocities()[-1]
    for q in range(5):
        np.testing.assert_array_equal(tys[q], j_tys[q])
        np.testing.assert_allclose(xs[q], j_xs[q], rtol=0, atol=RTOL * vmax)
        np.testing.assert_allclose(ys[q], j_ys[q], rtol=0, atol=RTOL * vmax)
        r, mu, _ = p._packet_steps(q)
        j_r, j_mu, _ = j._packet_steps(q)
        np.testing.assert_array_equal(r, j_r)
        np.testing.assert_allclose(np.hypot(xs[q], ys[q]), r, rtol=1e-10)
    x1, y1, _ = p.get_coordinates_with_theta_init(*p._packet_steps(1),
                                                  theta0=0.3)
    jx1, jy1, _ = j.get_coordinates_with_theta_init(*j._packet_steps(1),
                                                    theta0=0.3)
    np.testing.assert_allclose(x1, jx1, rtol=0, atol=RTOL * vmax)
    xs, ys, tys, m = p.get_equal_array_size(xs, ys, tys)
    assert all(len(x) == m for x in xs) and m > 1
    plt.close(p.generate_plot_mpl())
    text = debug_packet_log(sim.last_transport_result, [0, 1])
    assert "packet 0:" in text and "packet 1:" in text


def _grotrian_pair(sim, **settings):
    plots = []
    for module in (grotrian, j_grotrian):
        g = module.GrotrianPlot.from_simulation(sim)
        g.max_levels = 12
        for name, value in settings.items():
            setattr(g, name, value)
        g._compute_level_data()
        g._compute_transitions()
        plots.append(g)
    return plots


@pytest.mark.parametrize("settings", [
    {}, {"level_diff_threshold": 0.5},
    {"min_wavelength": 3000.0, "max_wavelength": 6000.0}, {"shell": 0}],
    ids=["default", "merged", "window", "shell0"])
def test_grotrian_matches_jax(sim, settings):
    """The merged ladder, the level map, the population widths and every
    transition's count, mean wavelength and width against the JAX
    plotter's; the diagram draws (linear and log)."""
    g, j = _grotrian_pair(sim, **settings)
    np.testing.assert_allclose(g.merged_energies, j.merged_energies,
                               rtol=RTOL)
    assert g.level_mapping == j.level_mapping
    np.testing.assert_allclose(g.level_widths, j.level_widths, rtol=RTOL)
    for name in ("excite_lines", "deexcite_lines"):
        a, b = getattr(g, name), getattr(j, name)
        assert set(a) == set(b)
        for k in a:
            assert a[k][0] == b[k][0]
            np.testing.assert_allclose(a[k][1:], b[k][1:], rtol=RTOL)
    assert len(g.excite_lines) + len(g.deexcite_lines) >= (
        0 if settings else 1)
    g.y_scale = "log"
    ax = g.display()
    assert "log10" in ax.get_ylabel()
    plt.close(ax.figure)
    with pytest.raises(ValueError):
        g.y_scale = "bad"
    with pytest.raises(ValueError):
        g.shell = 10_000
    with pytest.raises(ValueError):
        g.max_levels = 1


def test_plot_grotrian_wrapper(sim):
    """The one-call wrapper draws the first species' diagram."""
    from tardis_torch.utils.base import species_tuple_to_string

    atom = sim.atom_data
    ax = grotrian.plot_grotrian(sim, species_tuple_to_string(
        (int(atom.species_z[0]), int(atom.species_ion[0]))), max_levels=8)
    assert ax.get_title().startswith("Grotrian")
    plt.close(ax.figure)


def test_custom_abundance_editor_matches_jax(sim, tmp_path):
    """From the port's simulation state and from the config, edits,
    resampling and the CSVY export equal the JAX editor's on the JAX
    package's state of the same config; the file reads back through the
    port's CSVY reader; the plot draws."""
    editors = [custom_abundance.CustomAbundanceEditor.from_simulation(sim),
               j_custom.CustomAbundanceEditor.from_simulation_state(
                   JaxState.from_config(jax_config(copy.deepcopy(CONFIG))))]
    paths = []
    for k, ed in enumerate(editors):
        assert ed.n_shells == sim.state.no_of_shells
        assert ed.check_normalization().all()
        ed.set_abundance("Si", 0.7, shells=[0, 1, 2], normalize=True)
        v0 = ed.velocity[0]
        ed.set_abundance("O", 0.1, velocity_range=(v0, v0 + 1.0),
                         normalize=True)
        ed.resample(12)
        assert ed.n_shells == 12 and ed.check_normalization().all()
        paths.append(ed.to_csvy(str(tmp_path / f"edited{k}.csvy"),
                                t_rad=np.full(12, 9500.0),
                                dilution_factor=np.full(12, 0.4)))
    a, b = editors
    np.testing.assert_array_equal(a.velocity, b.velocity)
    np.testing.assert_array_equal(a.density, b.density)
    assert a.elements == b.elements
    for z in a.elements:
        np.testing.assert_array_equal(a.abundances[z], b.abundances[z])
    assert open(paths[0]).read() == open(paths[1]).read()
    back = custom_abundance.CustomAbundanceEditor.from_csvy(
        paths[0], time_explosion=sim.state.time_explosion)
    assert back.n_shells == 12 and set(back.elements) >= set(a.elements)
    from_cfg = custom_abundance.CustomAbundanceEditor.from_config(
        config_from_dict(copy.deepcopy(CONFIG)))
    np.testing.assert_array_equal(
        from_cfg.density,
        custom_abundance.CustomAbundanceEditor.from_simulation(sim).density)
    ax = a.plot()
    assert len(ax.lines) >= len(a.elements)
    plt.close(ax.figure)


class _Call:
    """What a stub plotly constructor was called with."""

    def __init__(self, kind, kwargs):
        self.kind, self.kwargs = kind, kwargs


def _stub_plotly(monkeypatch):
    """A recording ``plotly.graph_objects`` in ``sys.modules`` (for this
    test only): ``Figure`` records ``add_trace``, ``add_shape``,
    ``add_annotation``, ``update_layout`` and ``frames`` in call order;
    ``Scatter`` and ``Frame`` record their kwargs."""

    class Figure:
        def __init__(self):
            self.calls = []

        def add_trace(self, trace):
            self.calls.append(("add_trace", trace))

        def add_shape(self, **kw):
            self.calls.append(("add_shape", kw))

        def add_annotation(self, **kw):
            self.calls.append(("add_annotation", kw))

        def update_layout(self, **kw):
            self.calls.append(("update_layout", kw))

        @property
        def frames(self):
            return [c[1] for c in self.calls if c[0] == "frames"][-1]

        @frames.setter
        def frames(self, value):
            self.calls.append(("frames", list(value)))

    go = ModuleType("plotly.graph_objects")
    go.Figure = Figure
    go.Scatter = lambda **kw: _Call("Scatter", kw)
    go.Frame = lambda **kw: _Call("Frame", kw)
    package = ModuleType("plotly")
    package.graph_objects = go
    monkeypatch.setitem(sys.modules, "plotly", package)
    monkeypatch.setitem(sys.modules, "plotly.graph_objects", go)
    return go


def _same_record(a, b, atol, where="figure"):
    """``a`` (the port's) against ``b`` (the JAX package's): the same
    structure, call kinds, keys, strings and colours; numbers and arrays
    within RTOL (and ``atol``); no torch.Tensor anywhere in ``a``."""
    assert not isinstance(a, torch.Tensor), where
    if isinstance(b, _Call):
        assert isinstance(a, _Call) and a.kind == b.kind, where
        _same_record(a.kwargs, b.kwargs, atol, f"{where}.{b.kind}")
    elif isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (where, a, b)
        for k in b:
            _same_record(a[k], b[k], atol, f"{where}.{k}")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.shape == b.shape, where
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol,
                                   err_msg=where)
    elif isinstance(b, (list, tuple)):
        assert isinstance(a, (list, tuple)) and len(a) == len(b), where
        for k, (x, y) in enumerate(zip(a, b)):
            _same_record(x, y, atol, f"{where}[{k}]")
    elif isinstance(b, (bool, str, type(None))):
        assert a == b and type(a) is type(b), (where, a, b)
    else:  # a number
        assert isinstance(a, (int, float, np.number)) \
            and not isinstance(a, bool), (where, a)
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol,
                                   err_msg=where)


C_ANGSTROM = 2.99792458e18


def _figures(sim, kind, go):
    """The figure calls of ``kind`` for the port and the JAX package:
    (port figures, JAX figures, atol for coordinates)."""
    if kind == "sdec":
        d = 10.0 * 3.0856775814913673e24
        wl = C_ANGSTROM / sim.spectrum_nu_edges[::-1]
        obs = (wl, np.linspace(1.0, 2.0, wl.size) * 1e-12)
        calls = [dict(), dict(packets_mode="virtual", nelements=2),
                 dict(species_list=["Si II", "Ca"], distance=d,
                      observed_spectrum=obs, show_modeled_spectrum=False),
                 dict(packets_mode="virtual", blackbody_photosphere=False)]
        return ([sdec.SDECPlotter(sim).generate_plot_ply(**kw)
                 for kw in calls],
                [j_sdec.SDECPlotter(sim).generate_plot_ply(**kw)
                 for kw in calls], 0.0)
    if kind == "liv":
        calls = [dict(), dict(num_bins=10, log_scale=True),
                 dict(species_list=["Si II", "S I-III"], cmapname="viridis"),
                 dict(packets_mode="virtual", nelements=2)]
        port = [liv.LIVPlotter(sim).generate_plot_ply(**kw) for kw in calls]
        jax = [j_liv.LIVPlotter(sim).generate_plot_ply(**kw) for kw in calls]
        # onto a figure the caller hands in
        port.append(liv.LIVPlotter(sim).generate_plot_ply(fig=go.Figure()))
        jax.append(j_liv.LIVPlotter(sim).generate_plot_ply(fig=go.Figure()))
        return port, jax, 0.0
    if kind == "grotrian":
        figs = []
        for module in (grotrian, j_grotrian):
            out = []
            for settings in ({}, {"shell": 0}, {"level_diff_threshold": 0.5}):
                g = module.GrotrianPlot.from_simulation(sim)
                g.max_levels = 12
                for name, value in settings.items():
                    setattr(g, name, value)
                out.append(g.display_ply())
            figs.append(out)
        return figs[0], figs[1], 0.0
    p = rpacket.RPacketPlotter.from_simulation(sim, no_of_packets=5)
    j = j_rpacket.RPacketPlotter.from_simulation(sim, no_of_packets=5)
    vmax = p._shell_velocities()[-1]
    return ([p.generate_plot(theme=t) for t in ("light", "dark")],
            [j.generate_plot(theme=t) for t in ("light", "dark")],
            RTOL * vmax)



@pytest.mark.parametrize("kind", ["sdec", "liv", "grotrian", "rpacket"])
def test_plotly_figures_match_jax(sim, monkeypatch, kind):
    """Under a recording plotly stub, each figure makes the JAX package's
    calls in the same order: the same traces, shapes, annotations, frames
    and layout, strings, dicts and colours equal, arrays within RTOL (the
    r-packet coordinates within RTOL of the outer shell's velocity, a
    cumulative sum against a loop); no value handed to plotly is a
    torch.Tensor."""
    go = _stub_plotly(monkeypatch)
    port, jax, atol = _figures(sim, kind, go)
    for k, (a, b) in enumerate(zip(port, jax)):
        assert [c[0] for c in a.calls] == [c[0] for c in b.calls], k
        assert any(c[0] == "add_trace" for c in b.calls)
        _same_record(a.calls, b.calls, atol, f"{kind}[{k}]")
    if kind == "sdec":
        names = [c[1].kwargs["name"] for c in port[2].calls
                 if c[0] == "add_trace"]
        assert "observed" in names and "total" not in names
    if kind == "grotrian":
        assert any(c[0] == "add_annotation" for c in port[0].calls)
    if kind == "rpacket":
        m = len(port[0].frames)
        assert m > 1 and m == max(len(x) for x in rpacket.RPacketPlotter(
            sim, no_of_packets=5).get_coordinates_multiple_packets()[0])
        assert all(len(f.kwargs["data"]) == 2 * 5 for f in port[0].frames)
        legend = [c[1].kwargs["name"] for c in port[0].calls
                  if c[0] == "add_trace" and c[1].kwargs.get("showlegend")]
        assert "Boundary" not in legend and len(legend) == 4


@pytest.mark.parametrize("kw", [
    dict(distance=0.0),
    dict(observed_spectrum=(np.ones(3), np.ones(3)))],
    ids=["distance", "observed_without_distance"])
def test_sdec_plotly_refuses_what_jax_refuses(sim, monkeypatch, kw):
    """A distance <= 0, and an observed spectrum without a distance, are
    refused by both packages' plotly figure."""
    _stub_plotly(monkeypatch)
    for plotter in (sdec.SDECPlotter(sim), j_sdec.SDECPlotter(sim)):
        with pytest.raises(ValueError, match="distance"):
            plotter.generate_plot_ply(**kw)


PLOTLY_CALLS = {
    "sdec": ((sdec, j_sdec), lambda m, s: m.SDECPlotter(s)
             .generate_plot_ply()),
    "liv": ((liv, j_liv), lambda m, s: m.LIVPlotter(s).generate_plot_ply()),
    "rpacket": ((rpacket, j_rpacket), lambda m, s: m.RPacketPlotter(s)
                .generate_plot()),
    "grotrian": ((grotrian, j_grotrian), lambda m, s: m.GrotrianPlot(s)
                 .display_ply()),
}


@pytest.mark.parametrize("kind", list(PLOTLY_CALLS))
def test_plotly_figures_need_plotly(sim, monkeypatch, kind):
    """Without plotly each figure raises ImportError in both packages."""
    monkeypatch.setitem(sys.modules, "plotly", None)
    monkeypatch.setitem(sys.modules, "plotly.graph_objects", None)
    modules, call = PLOTLY_CALLS[kind]
    for module in modules:
        with pytest.raises(ImportError):
            call(module, sim)
