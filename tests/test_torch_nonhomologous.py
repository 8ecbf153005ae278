"""The nonhomologous path (K7's plain version, its tables, the RNG-walk
macro atom, the solver and the workflow) against the JAX package.

Both packages get one host-mode plasma solve of ``BASE_CONFIG`` on the
synthetic atomic data and the mixed-gradient velocity law of
``tests/test_nonhomologous.py`` (blueshifting shells, so the reversed-order
walk runs), the same pool and the same run key.  The JAX loop tests its
predicate on two-float prefixes with a three-level 128-ary search and
takes -log(u) in f32; the port uses f64 prefixes, a binary search and an
f64 log.  A near tie can therefore resolve differently, so the packet bars
are those of the JAX package's own equivalence test (>= 0.95 of statuses,
nu and energy within 1e-5 on >= 0.95 of packets, estimators 1e-3, the
cumulative j_blue difference within 1e-2 of its maximum and its 99.9th
percentile within 1e-3).
"""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.config.reader import config_from_dict as torch_config
from tardis_torch.model.geometry import (
    NonhomologousRadial1DGeometry as TorchNonhomGeometry,
)
from tardis_torch.model.state import SimulationState as TorchState
from tardis_torch.opacities.macro_atom_solver import (
    solve_macro_state as torch_macro_state,
)
from tardis_torch.plasma.solver import PlasmaState as TorchPlasmaState
from tardis_torch.simulation.base import run_tardis as torch_run_tardis
from tardis_torch.transport import nonhomologous as tnh
from tardis_torch.transport import rng
from tardis_torch.transport.kernel import transport_loop_plain
from tardis_torch.transport.tables import build_transport_tables as torch_tables
from tardis_torch.workflows.nonhomologous import (
    NonhomologousTARDISWorkflow as TorchNonhomWorkflow,
)
from tardis_tpu.atomic.synthetic import make_synthetic_atom_data
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.model.geometry import NonhomologousRadial1DGeometry
from tardis_tpu.model.state import SimulationState
from tardis_tpu.opacities.macro_atom_solver import solve_macro_state
from tardis_tpu.plasma.solver import PlasmaSolver
from tardis_tpu.simulation.base import run_tardis
from tardis_tpu.transport.nonhomologous import (
    build_nonhom_tables,
    nonhomologous_plasma_state,
    nonhomologous_tau_scale,
    run_nonhom_transport,
)
from tardis_tpu.transport.source import sample_blackbody_packets
from tardis_tpu.workflows.nonhomologous import NonhomologousTARDISWorkflow

from tests.test_plasma import BASE_CONFIG
from tests.test_torch_slice import CONFIG

torch.set_num_threads(2)

N = 1024
SEED = 11
MODES = ("scatter", "downbranch", "macroatom")


def mixed_gradient_kw(geometry):
    """The oscillating law of tests/test_nonhomologous.py:175-190."""
    S = geometry.no_of_shells
    pert = 1.0 + 0.35 * np.sin(np.arange(S) * 1.7)
    pert += 0.1 * np.random.default_rng(3).standard_normal(S)
    return dict(_r_inner=geometry.r_inner.copy(),
                _r_outer=geometry.r_outer.copy(),
                v_inner=geometry.v_inner * pert,
                v_outer=geometry.v_outer * np.roll(pert, -1),
                time_explosion=geometry.time_explosion)


def port_plasma(ps):
    """The port's PlasmaState holding the JAX package's solve."""
    kw = {f.name: getattr(ps, f.name) for f in dataclasses.fields(
        TorchPlasmaState) if f.name != "tau_prefix"}
    for name in ("tau_sobolev", "stimulated_emission_factor", "beta_sobolev",
                 "j_blues"):
        kw[name] = torch.as_tensor(np.asarray(kw[name], np.float64))
    tau = kw["tau_sobolev"]
    prefix = torch.zeros((tau.shape[1], tau.shape[0] + 1), dtype=torch.float64)
    torch.cumsum(tau.T, dim=1, out=prefix[:, 1:])
    return TorchPlasmaState(tau_prefix=prefix, **kw)


@pytest.fixture(scope="module")
def problem():
    atom = make_synthetic_atom_data().prepare(
        selected_atoms=[8, 12, 14, 16, 18, 20],
        line_interaction_type="macroatom")
    state = SimulationState.from_config(config_from_dict(BASE_CONFIG))
    ps = PlasmaSolver(atom, state).update(
        state.t_radiative, state.dilution_factor, line_mode="host")
    kw = mixed_gradient_kw(state.geometry)
    geom = NonhomologousRadial1DGeometry(**kw)
    tgeom = TorchNonhomGeometry(**kw)
    port_atom = atom_data_from_arrays(atom_data_to_arrays(atom))
    ps_nh = nonhomologous_plasma_state(ps, geom)
    tps_nh = tnh.nonhomologous_plasma_state(port_plasma(ps), tgeom)
    base = jax.random.key(np.uint32(SEED))
    pool = sample_blackbody_packets(jax.random.fold_in(base, 0), N,
                                    state.t_inner)
    return dict(atom=atom, port_atom=port_atom, state=state, ps=ps,
                geom=geom, tgeom=tgeom, ps_nh=ps_nh, tps_nh=tps_nh,
                pool=pool, run_key=jax.random.fold_in(base, 1))


def both_walk_tables(p, mode):
    """The walk tables of ``mode`` in both packages (None in scatter)."""
    if mode == "scatter":
        return None, None
    macro = "downbranch" if mode == "downbranch" else "macro_atom"
    ps_nh, tps_nh = p["ps_nh"], p["tps_nh"]
    ms = solve_macro_state(getattr(p["atom"], macro), ps_nh.beta_sobolev,
                           ps_nh.j_blues, ps_nh.stimulated_emission_factor)
    walk = torch_macro_state(getattr(p["port_atom"], macro),
                             tps_nh.beta_sobolev, tps_nh.j_blues,
                             tps_nh.stimulated_emission_factor)
    return ms, walk


@pytest.fixture(scope="module")
def loops(problem):
    """Both event loops in each mode on the same pool and run key."""
    p = problem
    mu, nu = (torch.as_tensor(np.array(a)) for a in p["pool"])
    out = {}
    for mode in MODES:
        ms, walk = both_walk_tables(p, mode)
        tables, static = build_nonhom_tables(p["geom"], p["ps_nh"], p["atom"],
                                             mode, macro_state=ms)
        carry = run_nonhom_transport(tables, static, *p["pool"], p["run_key"],
                                     n_packets=N, batch_size=256,
                                     max_steps=60000)
        tt = tnh.build_nonhom_tables(p["tgeom"], p["tps_nh"], p["port_atom"],
                                     mode, walk=walk)
        res = tnh.nonhom_transport_loop_plain(
            tt, mu, nu, rng.fold_in(rng.key(SEED), 1), batch_size=256)
        out[mode] = (carry, res, tables, tt)
    return out


def test_geometry_matches_jax(problem):
    """Velocity gradient, volumes, radii, midpoints and the dilution factor
    of the nonhomologous geometry, and the Sobolev-depth scale, equal the
    JAX package's at 1e-12."""
    geom, tgeom = problem["geom"], problem["tgeom"]
    for name in ("velocity_gradient", "volume", "r_inner", "r_outer",
                 "r_middle", "v_middle"):
        np.testing.assert_allclose(getattr(tgeom, name), getattr(geom, name),
                                   rtol=1e-12, err_msg=name)
    np.testing.assert_allclose(tgeom.geometric_dilution_factor(),
                               geom.geometric_dilution_factor(), rtol=1e-12)
    assert tgeom.no_of_shells == geom.no_of_shells
    assert (geom.velocity_gradient < 0).any()
    np.testing.assert_allclose(tnh.nonhomologous_tau_scale(tgeom),
                               nonhomologous_tau_scale(geom), rtol=1e-12)
    home = TorchNonhomGeometry.from_homologous(
        TorchState.from_config(torch_config(BASE_CONFIG)).geometry)
    np.testing.assert_allclose(
        home.velocity_gradient * home.time_explosion, 1.0, rtol=1e-12)


def test_plasma_state_matches_jax(problem):
    """tau_sobolev and beta_sobolev rescaled to the nonhomologous law equal
    the JAX package's at 1e-12; the prefix follows the rescaled depths."""
    ps_nh, tps_nh = problem["ps_nh"], problem["tps_nh"]
    np.testing.assert_allclose(tps_nh.tau_sobolev.numpy(), ps_nh.tau_sobolev,
                               rtol=1e-12)
    np.testing.assert_allclose(tps_nh.beta_sobolev.numpy(),
                               ps_nh.beta_sobolev, rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(tps_nh.tau_prefix[:, -1].numpy(),
                               ps_nh.tau_sobolev.sum(axis=0), rtol=1e-12)


def test_prefixes_match_jax_two_float(loops):
    """The flat f64 forward and reversed-order prefixes K7 searches equal
    the JAX package's hi + lo pairs at 1e-7 relative."""
    _, _, tables, tt = loops["scatter"]
    for hi, lo, ours in ((tables.tau_cum_hi, tables.tau_cum_lo, tt.prefix),
                         (tables.rev_cum_hi, tables.rev_cum_lo,
                          tt.rev_prefix)):
        ref = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-7, atol=1e-30)
    np.testing.assert_array_equal(tt.line_nu.numpy(),
                                  np.asarray(tables.line_nu))
    for name in ("r_inner", "r_outer", "beta_in", "m_grad", "chi_e"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(tables, name)))


@pytest.mark.parametrize("mode", ["downbranch", "macroatom"])
def test_solve_macro_state_matches_jax(problem, mode):
    """The walk tables: cumulative probabilities within one f32 ulp of the
    JAX package's (block ends exactly 1), every integer table equal."""
    ms, walk = both_walk_tables(problem, mode)
    cum_j = np.asarray(ms[0])
    cum_t = walk.cum_prob.numpy()
    assert cum_t.dtype == np.float32 and cum_t.shape == cum_j.shape
    ulps = np.abs(cum_j.view(np.int32).astype(np.int64)
                  - cum_t.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1, ulps.max()
    refs = np.asarray(ms[1])
    assert (cum_t[refs[1:] - 1] == 1.0).all()
    for a, b in zip(ms[1:], walk[1:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("mode", MODES)
def test_plain_loop_matches_jax(loops, mode):
    """K7's plain version against run_nonhom_transport on the mixed-gradient
    law: the bars of the module docstring, every packet finished, and
    line estimators from the reversed walk."""
    carry, res, _, tt = loops[mode]
    nu_p = res.out[:, 0].numpy().astype(np.float64)
    st_p = np.where(nu_p > 0, 1, np.where(nu_p < 0, 2, 0))
    st_j = np.asarray(carry.out_status)
    same = st_p == st_j
    assert (st_p > 0).all() and res.summary[3].item() == 0
    assert same.mean() >= 0.95, same.mean()
    nu_j = np.asarray(carry.out_nu, np.float64)
    e_j = np.asarray(carry.out_energy, np.float64)
    e_p = res.out[:, 1].numpy().astype(np.float64)
    close = (same & (np.abs(np.abs(nu_p) - nu_j) <= 1e-5 * nu_j)
             & (np.abs(e_p - e_j) <= 1e-5 * np.abs(e_j)))
    assert close.mean() >= 0.95, close.mean()
    np.testing.assert_allclose(res.est_j.numpy(), carry.est_j_f64(),
                               rtol=1e-3)
    np.testing.assert_allclose(res.est_nubar.numpy(), carry.est_nubar_f64(),
                               rtol=1e-3)
    S, L = tt.n_shells, tt.n_lines
    cum_j = np.cumsum(carry.line_diff_f64().reshape(L + 1, S, 2)[:, :, 0],
                      axis=0)
    cum_p = np.cumsum(res.line_diff.numpy().reshape(L + 1, S, 2)[:, :, 0],
                      axis=0)
    d = np.abs(cum_j - cum_p)
    top = np.abs(cum_j).max()
    assert d.max() <= 1e-2 * top
    assert np.quantile(d, 0.999) <= 1e-3 * top
    assert (np.abs(cum_p[:-1]).sum(axis=1) > 0).sum() > 100


def test_plain_loop_homologous_law_matches_k1(problem):
    """Under the homologous law K7's plain version walks the packets K1's
    plain version walks (scatter mode, same pool and key): at least 0.999
    of statuses equal, the JAX package's bar."""
    p = problem
    state = TorchState.from_config(torch_config(BASE_CONFIG))
    geom = TorchNonhomGeometry.from_homologous(state.geometry)
    tps = port_plasma(p["ps"])
    tps_nh = tnh.nonhomologous_plasma_state(tps, geom)
    np.testing.assert_allclose(tps_nh.tau_sobolev.numpy(),
                               tps.tau_sobolev.numpy(), rtol=1e-7)
    t7 = tnh.build_nonhom_tables(geom, tps_nh, p["port_atom"], "scatter")
    t1 = torch_tables(state.geometry, p["ps"].electron_densities,
                      tps.tau_prefix, p["port_atom"], "scatter")
    mu, nu = (torch.as_tensor(np.array(a)) for a in p["pool"])
    key = rng.fold_in(rng.key(SEED), 1)
    k7 = tnh.nonhom_transport_loop_plain(t7, mu, nu, key, batch_size=256)
    k1 = transport_loop_plain(t1, mu, nu, key, batch_size=256)
    s7, s1 = torch.sign(k7.out[:, 0]), torch.sign(k1.out[:, 0])
    assert (s7 == s1).double().mean().item() >= 0.999
    np.testing.assert_allclose(k7.est_j.numpy(), k1.est_j.numpy(), rtol=1e-3)


def test_plain_loop_options(problem):
    """Last-interaction rows and the r-packet tracker come out of the same
    walk as the plain run without them, and a reflective core at albedo 1
    reabsorbs no packet."""
    p = problem
    _, walk = both_walk_tables(p, "macroatom")
    tt = tnh.build_nonhom_tables(p["tgeom"], p["tps_nh"], p["port_atom"],
                                 "macroatom", walk=walk)
    mu, nu = (torch.as_tensor(np.array(a)[:256]) for a in p["pool"])
    key = rng.fold_in(rng.key(SEED), 1)
    base = tnh.nonhom_transport_loop_plain(tt, mu, nu, key, batch_size=64)
    opt = tnh.nonhom_transport_loop_plain(tt, mu, nu, key, batch_size=64,
                                          last_interaction=True,
                                          tracker_length=8)
    assert torch.equal(base.out, opt.out)
    li = opt.last_interaction
    line = li[:, 0] == 2
    assert line.any() and (li[line, 1] >= 0).all() and (li[line, 2] >= 0).all()
    assert (opt.tracker[:, 0, 4] > 0).all()
    tt.inner_boundary_albedo = 1.0
    wall = tnh.nonhom_transport_loop_plain(tt, mu, nu, key, batch_size=64)
    assert (wall.out[:, 0] > 0).all()
    assert tnh.variant_name(tnh.variant(tt, True, 8)) == (
        "macro+last_interaction+tracker+reflective")


@pytest.fixture(scope="module")
def workflows(atom_data_prepared):
    """Both packages' NonhomologousTARDISWorkflow on the configuration and
    perturbed law of tests/test_nonhomologous.py:233-258."""
    cfg = {**BASE_CONFIG, "montecarlo": {
        **BASE_CONFIG["montecarlo"], "no_of_packets": 2048,
        "last_no_of_packets": 4096, "iterations": 3,
        "no_of_virtual_packets": 0}}
    out = []
    for cls, config, kw in (
            (NonhomologousTARDISWorkflow, config_from_dict(cfg),
             dict(atom_data=atom_data_prepared)),
            (TorchNonhomWorkflow, torch_config(copy.deepcopy(cfg)),
             dict(atom_data=atom_data_from_arrays(
                 atom_data_to_arrays(atom_data_prepared)), device="cpu"))):
        wf = cls(config, show_progress_bars=False, **kw)
        S = wf.geometry.no_of_shells
        wf.geometry.v_inner = wf.geometry.v_inner * (
            1.0 + 0.1 * np.sin(np.arange(S)))
        wf.geometry.v_outer = wf.geometry.v_outer * (
            1.0 + 0.1 * np.sin(np.arange(S) + 1.0))
        out.append(wf.run())
    return out


def test_workflow_matches_jax(workflows):
    """t_inner within 1%, t_rad within 2% and W within 5% of the JAX
    package's, and the real spectrum finite and positive."""
    ref, port = workflows
    assert port.completed and isinstance(port.geometry, TorchNonhomGeometry)
    s_r, s_p = ref.sim.state, port.sim.state
    assert abs(s_p.t_inner / s_r.t_inner - 1) < 0.01
    np.testing.assert_allclose(s_p.t_radiative, s_r.t_radiative, rtol=0.02)
    np.testing.assert_allclose(s_p.dilution_factor, s_r.dilution_factor,
                               rtol=0.05)
    lum = np.asarray(port.sim.spectrum_real.luminosity_nu)
    assert np.isfinite(lum).all() and lum.sum() > 0
    assert (s_p.t_radiative > 1000).all()


@pytest.fixture(scope="module")
def nonhom_runs(atom_data_prepared):
    """Both packages' run_tardis on the slice CONFIG with
    enable_nonhomologous_expansion, 2 virtual packets and the integrated
    spectrum (3 iterations)."""
    cfg = copy.deepcopy(CONFIG)
    cfg["montecarlo"].update(enable_nonhomologous_expansion=True,
                             no_of_virtual_packets=2)
    cfg["spectrum"]["method"] = "integrated"
    ref = run_tardis(copy.deepcopy(cfg), atom_data=atom_data_prepared)
    port = torch_run_tardis(
        copy.deepcopy(cfg), atom_data=atom_data_from_arrays(
            atom_data_to_arrays(atom_data_prepared)), device="cpu")
    return ref, port


def test_run_tardis_nonhomologous_matches_jax(nonhom_runs):
    """run_tardis with enable_nonhomologous_expansion takes the
    nonhomologous solver in both packages.  As in the JAX package, virtual
    packets are not traced in this mode (no virtual spectrum) and the
    integrated spectrum is the formal integral over the run's estimators:
    t_inner within 1% and the integrated luminosity within 1%."""
    from tardis_torch.transport.solver import NonhomologousTransportSolver

    ref, port = nonhom_runs
    assert isinstance(port.transport, NonhomologousTransportSolver)
    assert abs(port.state.t_inner / ref.state.t_inner - 1) < 0.01
    assert ref.spectrum_virtual is None and port.spectrum_virtual is None
    a = np.asarray(ref.spectrum_integrated.luminosity_nu).sum()
    b = np.asarray(port.spectrum_integrated.luminosity_nu).sum()
    assert abs(b / a - 1) < 0.01


def test_run_tardis_nonhomologous_final_plasma_matches_jax(nonhom_runs):
    """The final iteration transports on the plasma of the last
    advance_state, as in the JAX package, which re-solves it only for the
    classic solver's device-line states: the final electron densities
    agree within 1e-5 (one more step of the n_e fixpoint moves them by up
    to ~4e-3)."""
    ref, port = nonhom_runs
    np.testing.assert_allclose(port.plasma_state.electron_densities,
                               ref.plasma_state.electron_densities,
                               rtol=1e-5)
