"""The inner-velocity solver and ``get_tau_integ`` against the JAX package.

``get_tau_integ`` on the same inputs (the JAX plasma state's tau table,
t_rad and n_e as numpy) agrees to rtol 1e-10: both sides are f64 and only
the order of the sums differs.  Given the port's own plasma state it
reads K3's tau table as the tensor it is.

``InnerVelocitySolverWorkflow`` runs in both packages on
``test_torch_slice.CONFIG`` with 4 iterations (3 boundary moves) and a
target tau inside the integrated-tau profile: the JAX package's first
Rosseland profile at shell 5.  (The default 2/3 lies above that profile,
whose shell 0 holds 0.24, so the boundary stays; one case holds that in
both packages.)  Both draw the same random bits, so the boundary history
agrees within 1e-6 relative (measured: 1.5e-8), t_rad within 2.2e-4 and
W within 1e-3 per iteration (the port's per-iteration bars), and the
final iteration, which both run on a plasma re-solved on the moved grid,
within the slice's bars (n_e 2e-3, tau 1e-3; measured 1.0e-7 and
2.3e-5).
"""

import copy

import numpy as np
import pytest
import torch

from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.workflows.util import get_tau_integ as torch_tau_integ
from tardis_torch.workflows.v_inner_solver import (
    InnerVelocitySolverWorkflow as TorchVInner,
)
from tardis_tpu.workflows.util import get_tau_integ
from tardis_tpu.workflows.v_inner_solver import InnerVelocitySolverWorkflow

from tests.test_torch_slice import CONFIG

torch.set_num_threads(2)

V_INNER_CONFIG = copy.deepcopy(CONFIG)
V_INNER_CONFIG["montecarlo"]["iterations"] = 4
# last-interaction tracking at its default (on), as on the card
del V_INNER_CONFIG["montecarlo"]["tracking"]
HISTORY_RTOL = 1e-6
T_RAD_RTOL = 2.2e-4
W_RTOL = 1e-3
TAU_INTEG_RTOL = 1e-10


class _Plasma:
    """The parts of a plasma state get_tau_integ reads."""

    def __init__(self, tau, t_rad, n_e):
        self.tau_sobolev = tau
        self.t_rad = t_rad
        self.electron_densities = n_e


def _port_atom(atom):
    return atom_data_from_arrays(atom_data_to_arrays(atom))


@pytest.fixture(scope="module")
def first_solve(atom_data_prepared):
    """The JAX workflow's first plasma solve (host f64 tau table)."""
    wf = InnerVelocitySolverWorkflow(copy.deepcopy(V_INNER_CONFIG),
                                     atom_data=atom_data_prepared)
    wf.solve_plasma()
    return wf.sim


@pytest.fixture(scope="module")
def tau_target(first_solve):
    sim = first_solve
    return float(get_tau_integ(sim.plasma_state, sim.atom_data,
                               sim.state)["rosseland"][5])


def _run(package, atom, tau, config=V_INNER_CONFIG):
    """Run one package's workflow; records whether the final iteration
    started without a plasma state (so it re-solved on the moved grid)."""
    if package == "jax":
        wf = InnerVelocitySolverWorkflow(copy.deepcopy(config),
                                         atom_data=atom, **tau)
    else:
        wf = TorchVInner(copy.deepcopy(config), atom_data=_port_atom(atom),
                         device="cpu", **tau)
    solve_spectrum = wf.solve_spectrum

    def spy():
        wf.final_plasma_was_none = wf.sim.plasma_state is None
        return solve_spectrum()

    wf.solve_spectrum = spy
    return wf.run()


@pytest.fixture(scope="module")
def runs(atom_data_prepared, tau_target):
    tau = {"tau": tau_target}
    return (_run("jax", atom_data_prepared, tau),
            _run("torch", atom_data_prepared, tau))


@pytest.mark.parametrize("bin_size", (10, 7))
def test_tau_integ_same_inputs(first_solve, bin_size):
    sim = first_solve
    ps = sim.plasma_state
    ref = get_tau_integ(ps, sim.atom_data, sim.state, bin_size=bin_size)
    ours = torch_tau_integ(
        _Plasma(np.asarray(ps.tau_sobolev), ps.t_rad,
                ps.electron_densities),
        _port_atom(sim.atom_data), sim.state, bin_size=bin_size)
    assert set(ours) == {"rosseland", "planck"}
    for key in ours:
        assert ours[key].shape == (sim.state.no_of_shells,)
        np.testing.assert_allclose(ours[key], ref[key],
                                   rtol=TAU_INTEG_RTOL, err_msg=key)


def test_tau_integ_reads_the_device_table(atom_data_prepared):
    """On the port's own plasma state the tau table is taken as the
    tensor it is; a numpy copy of it gives the same profiles."""
    wf = TorchVInner(copy.deepcopy(V_INNER_CONFIG),
                     atom_data=_port_atom(atom_data_prepared), device="cpu")
    wf.solve_plasma()
    sim = wf.sim
    ps = sim.plasma_state
    assert isinstance(ps.tau_sobolev, torch.Tensor)
    ours = torch_tau_integ(ps, sim.atom_data, sim.state)
    copied = torch_tau_integ(
        _Plasma(ps.tau_sobolev.numpy(), ps.t_rad, ps.electron_densities),
        sim.atom_data, sim.state)
    ref = get_tau_integ(
        _Plasma(ps.tau_sobolev.numpy(), ps.t_rad, ps.electron_densities),
        atom_data_prepared, sim.state)
    for key in ours:
        np.testing.assert_array_equal(ours[key], copied[key])
        np.testing.assert_allclose(ours[key], ref[key], rtol=TAU_INTEG_RTOL)


def test_boundary_history(runs):
    ref, port = runs
    v0 = ref.sim.config.model.structure.velocity.start
    assert len(port.v_inner_history) == len(ref.v_inner_history) == 3
    np.testing.assert_allclose(port.v_inner_history, ref.v_inner_history,
                               rtol=HISTORY_RTOL)
    # the boundary moved outward every iteration, inside the grid
    assert np.all(np.diff([v0] + port.v_inner_history) > 0)
    assert port.v_inner_history[-1] > 1.1 * v0
    assert port.v_inner_history[-1] < port.sim.state.geometry.v_outer[-1]
    np.testing.assert_allclose(port.sim.state.geometry.v_inner[0],
                               port.v_inner_history[-1], rtol=1e-15)


def test_iteration_history(runs):
    ref, port = runs
    assert len(port.sim.history) == len(ref.sim.history) == 3
    for h_p, h_r in zip(port.sim.history, ref.sim.history):
        np.testing.assert_allclose(h_p.t_radiative, h_r.t_radiative,
                                   rtol=T_RAD_RTOL)
        np.testing.assert_allclose(h_p.dilution_factor, h_r.dilution_factor,
                                   rtol=W_RTOL)
        assert abs(h_p.t_inner / h_r.t_inner - 1) < T_RAD_RTOL


def test_final_iteration(runs):
    """Both final iterations start without a plasma state and re-solve it
    on the moved grid; the state and the spectrum agree at the slice's
    bars."""
    ref, port = runs
    assert ref.final_plasma_was_none and port.final_plasma_was_none
    g_r, g_p = ref.sim.state.geometry, port.sim.state.geometry
    np.testing.assert_allclose(g_p.v_inner, g_r.v_inner, rtol=HISTORY_RTOL)
    np.testing.assert_allclose(port.sim.state.composition.density,
                               ref.sim.state.composition.density, rtol=1e-5)
    ps_r, ps_p = ref.sim.plasma_state, port.sim.plasma_state
    np.testing.assert_allclose(ps_p.t_rad, ps_r.t_rad, rtol=T_RAD_RTOL)
    np.testing.assert_allclose(ps_p.w, ps_r.w, rtol=W_RTOL)
    np.testing.assert_allclose(ps_p.electron_densities,
                               ps_r.electron_densities, rtol=2e-3)
    np.testing.assert_allclose(ps_p.tau_sobolev.numpy(),
                               np.asarray(ps_r.tau_sobolev), rtol=1e-3,
                               atol=1e-12)
    lum_p = port.sim.spectrum_real.luminosity
    lum_r = ref.sim.spectrum_real.luminosity
    assert np.isfinite(port.sim.spectrum_real.luminosity_nu).all()
    assert abs(lum_p / lum_r - 1) < 0.02
    assert port.sim.last_transport_result.n_packets == 4096


def test_tables_follow_the_moved_grid(runs):
    """What the port derives from density and geometry is rebuilt from the
    moved grid: the solver's element number densities are a fresh
    solver's, and the final iteration's packets start at the new inner
    radius."""
    from tardis_torch.plasma.solver import PlasmaSolver

    _, port = runs
    sim = port.sim
    fresh = PlasmaSolver(sim.atom_data, sim.state, "cpu")
    np.testing.assert_array_equal(sim.plasma_solver.number_density,
                                  fresh.number_density)
    r_in = sim.state.geometry.r_inner[0]
    li = sim.last_transport_result.last_interaction
    touched = li["type"] > 0
    assert touched.any() and (li["r"][touched] >= r_in * (1 - 1e-6)).all()


def test_default_tau_keeps_the_boundary(atom_data_prepared):
    """At the default tau = 2/3, above the integrated-tau profile, both
    packages keep the boundary where it was."""
    cfg = copy.deepcopy(V_INNER_CONFIG)
    cfg["montecarlo"]["iterations"] = 2
    v0 = 1.1e9
    for package in ("jax", "torch"):
        wf = _run(package, atom_data_prepared, {}, config=cfg)
        assert wf.v_inner_history == [pytest.approx(v0, rel=1e-12)], package
        assert wf.sim.state.geometry.v_inner[0] == pytest.approx(v0,
                                                                 rel=1e-12)


def test_default_device_is_the_card(monkeypatch):
    """Without a device the workflow asks for the card, and a machine
    without one raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchVInner(copy.deepcopy(V_INNER_CONFIG))
