"""The formal integral: K5's plain version and the host source function
against the JAX package's.

- Rays: both packages integrate identical inputs (the synthetic atom's
  lines and tau, the slice geometry, source-function tables from a numpy
  seed) in f32 with the same step arithmetic; only the order of a few f32
  operations inside XLA's fused loop may differ, so I p agrees within 1e-5
  of its largest value.
- Source function: host f64 in both, on identical estimators; only scipy's
  sparse solve and numpy sums in another order separate them: rtol 1e-10.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.spectrum.formal_integral import (
    COUNT_CAPPED,
    IntegrationError,
    check_formal_integral_requirements,
    integrate_rays,
    integrate_rays_plain,
    interp_shells,
    solve_source_function,
)
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.constants import C
from tardis_tpu.model.state import SimulationState
from tardis_tpu.plasma.lte import intensity_black_body
from tardis_tpu.plasma.solver import PlasmaSolver
from tardis_tpu.spectrum import formal_integral as jax_fi
from tardis_tpu.transport.device_state import NU_UNIT

from tests.test_plasma import BASE_CONFIG

torch.set_num_threads(2)

F, P = 50, 20


@pytest.fixture(scope="module")
def problem(atom_data_prepared):
    state = SimulationState.from_config(config_from_dict(BASE_CONFIG))
    ps = PlasmaSolver(atom_data_prepared, state).update(
        state.t_radiative, state.dilution_factor, line_mode="host")
    return state, ps, atom_data_prepared


def _jax_rays(a):
    """JAX ``_integrate_rays`` on the (S, L) tables of ``a``."""
    S, L = a["exp_tau"].shape

    def line_major(x):
        return jnp.asarray(np.ascontiguousarray(x.T).reshape(-1))

    return np.asarray(jax_fi._integrate_rays(
        jnp.asarray(a["nu_grid"]), jnp.asarray(a["p_grid"]),
        jnp.asarray(a["r_inner"]), jnp.asarray(a["r_outer"]),
        jnp.asarray(a["chi_e"]), jnp.asarray(-a["line_nu"]),
        jnp.asarray(a["line_nu"]), line_major(a["exp_tau"]),
        line_major(a["att_S"]), line_major(a["j_red"]),
        line_major(a["j_blue"]), jnp.asarray(a["i_inner"]),
        n_shells=S, n_lines=L, n_p=a["p_grid"].shape[0],
    ))


def _port_rays(a, fn=integrate_rays):
    return fn(**{k: torch.as_tensor(v) for k, v in a.items()})


def test_rays_match_jax(problem):
    state, ps, atom = problem
    geometry = state.geometry
    ct = C * state.time_explosion
    S, L = state.no_of_shells, atom.n_lines
    rng = np.random.default_rng(3)
    nu_grid = np.linspace(C / 20000e-8, C / 500e-8, F)
    i_bb = intensity_black_body(nu_grid, 10000.0)
    scale = float(i_bb.max())
    p_grid = np.linspace(0.0, geometry.r_outer[-1], P + 1)[1:]

    def f32(x):
        return np.ascontiguousarray(x, np.float32)

    j_blue = rng.uniform(0.1, 1.0, (S, L)) * scale
    a = dict(
        nu_grid=f32(nu_grid / NU_UNIT), p_grid=f32(p_grid / ct),
        r_inner=f32(geometry.r_inner / ct), r_outer=f32(geometry.r_outer / ct),
        chi_e=f32(6.6524587321e-25 * ps.electron_densities * ct),
        line_nu=f32(atom.line_nu / NU_UNIT),
        exp_tau=f32(np.exp(-ps.tau_sobolev).T),
        att_S=f32(rng.uniform(0.0, 0.5, (S, L)) * scale),
        j_red=f32(j_blue * rng.uniform(0.5, 1.0, (S, L))),
        j_blue=f32(j_blue), i_inner=f32(i_bb),
    )
    port = _port_rays(a)
    assert port.i_p.shape == (F, P) and port.i_p.dtype == torch.float32
    ref = _jax_rays(a)
    np.testing.assert_allclose(port.i_p.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    counts = port.counts.tolist()
    assert counts[0] > 0 and counts[1] >= F * P and counts[COUNT_CAPPED] == 0
    assert integrate_rays.launches == 0  # CPU tensors never launch


def test_bare_photosphere_blackbody():
    """No lines and no electron scattering: L_nu = 4 pi^2 r_ph^2 B_nu within
    10% (the photosphere's Doppler shift), as the JAX package's test; and
    I p equal to the JAX package's within 1e-5 of its largest value."""
    state = SimulationState.from_config(config_from_dict(BASE_CONFIG))
    geometry = state.geometry
    ct = C * state.time_explosion
    S, L, n_p = geometry.no_of_shells, 4, 200
    nu_grid = np.linspace(2e14, 2e15, 40)
    p_grid = np.linspace(0.0, geometry.r_outer[-1], n_p + 1)[1:]
    i_bb = intensity_black_body(nu_grid, 10000.0)
    a = {k: np.asarray(v, np.float32) for k, v in dict(
        nu_grid=nu_grid / NU_UNIT, p_grid=p_grid / ct,
        r_inner=geometry.r_inner / ct, r_outer=geometry.r_outer / ct,
        chi_e=np.zeros(S), line_nu=np.linspace(4e9, 1e9, L) / NU_UNIT,
        exp_tau=np.ones((S, L)), att_S=np.zeros((S, L)),
        j_red=np.zeros((S, L)), j_blue=np.zeros((S, L)), i_inner=i_bb,
    ).items()}
    i_p = _port_rays(a, integrate_rays_plain).i_p.numpy().astype(np.float64)
    dp = (p_grid[1] - p_grid[0]) / ct
    lum = 8.0 * np.pi**2 * np.trapezoid(i_p, dx=dp, axis=1) * ct**2
    expected = 4.0 * np.pi**2 * geometry.r_inner[0] ** 2 * i_bb
    assert np.all(np.abs(lum / expected - 1.0) < 0.1)
    ref = _jax_rays(a)
    np.testing.assert_allclose(i_p, ref, rtol=0, atol=1e-5 * ref.max())


@pytest.mark.parametrize("mode", ["macroatom", "downbranch"])
def test_source_function_matches_jax(problem, mode):
    state, ps, atom = problem
    L, S = ps.tau_sobolev.shape
    rng = np.random.default_rng(11)
    result = types.SimpleNamespace(
        time_of_simulation=1.0 / state.luminosity_requested,
        edot_lu_estimator=rng.uniform(0.0, 1.0, (L, S)) * 1e-3,
        j_blue_estimator=rng.uniform(0.0, 1.0, (L, S)) * 1e-20,
    )
    macro = atom.macro_atom if mode == "macroatom" else atom.downbranch
    ref = jax_fi.solve_source_function(macro, ps, result, state, atom, mode)
    port_atom = atom_data_from_arrays(atom_data_to_arrays(atom))
    port_ps = types.SimpleNamespace(**{
        k: torch.as_tensor(getattr(ps, k))
        for k in ("tau_sobolev", "beta_sobolev", "j_blues",
                  "stimulated_emission_factor")})
    port = solve_source_function(
        port_atom.macro_atom if mode == "macroatom" else
        port_atom.downbranch, port_ps, result, state, port_atom, mode)
    for name in ("att_S_ul", "Jred_lu", "Jblue_lu"):
        a, b = getattr(port, name), getattr(ref, name)
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a, b, rtol=1e-10,
                                   atol=1e-10 * np.abs(b).max(), err_msg=name)


def test_requirements_check():
    assert check_formal_integral_requirements("macroatom")
    assert check_formal_integral_requirements("downbranch")
    with pytest.raises(IntegrationError):
        check_formal_integral_requirements("scatter")
    with pytest.raises(IntegrationError):
        check_formal_integral_requirements("macroatom", continuum_enabled=True)
    with pytest.warns(UserWarning):
        assert not check_formal_integral_requirements("scatter", raises=False)


@pytest.mark.parametrize("kind", ["linear", "nearest"])
def test_interpolate_shells_matches_jax(kind):
    """Shell refinement of the tables: the same numpy arithmetic as the JAX
    package's, so equal bit for bit, extrapolated edges included."""
    rng = np.random.default_rng(5)
    mid_old = np.sort(rng.uniform(1.0, 2.0, 20))
    mid_new = np.linspace(0.9, 2.1, 57)
    arr = rng.uniform(0.0, 1.0, (6, 20))
    np.testing.assert_array_equal(
        interp_shells(mid_old, mid_new, arr, kind=kind),
        jax_fi._interp_shells(mid_old, mid_new, arr, kind=kind))
