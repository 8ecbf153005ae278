"""``detailed`` radiative rates, with an NLTE species, end to end against
the JAX package.

Under ``detailed`` rates every iteration accumulates the line estimators
and feeds their j_blues back into the plasma: K3's estimators mode keeps
each positive estimator and takes w_epsilon W B_nu(T_rad) elsewhere
(``tardis_tpu/plasma/solver.py:458-465``), held here to rtol 1e-12 in its
plain version.  Both packages' ``run_tardis`` on test_torch_slice's
configuration with ``radiative_rates_type: detailed`` and Si II in NLTE
agree within that test's bands (per-iteration t_inner 1%, t_rad 2%, W 5%,
final real luminosity 2%), and so do their nonhomologous runs (t_rad).
"""

import copy

import numpy as np
import pytest
import torch

from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.plasma.line_tables import (
    LineStatic,
    line_tables,
    line_tables_plain,
)
from tardis_torch.simulation.base import run_tardis as torch_run_tardis
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.model.state import SimulationState
from tardis_tpu.plasma import lte
from tardis_tpu.plasma.solver import PlasmaSolver
from tardis_tpu.simulation.base import run_tardis

from tests.test_plasma import BASE_CONFIG
from tests.test_torch_slice import CONFIG

torch.set_num_threads(2)

DETAILED = copy.deepcopy(CONFIG)
DETAILED["plasma"].update(radiative_rates_type="detailed",
                          nlte={"species": ["Si 2"]})


def test_k3_estimator_mode_matches_jax_host(atom_data_prepared):
    """The plain K3's j_blues from estimators that are positive, zero and
    negative: the estimator where positive, else w_epsilon times the
    dilute-Planck value, as the JAX package's host pass selects; the other
    tables are those of the default mode, bit for bit."""
    atom = atom_data_prepared
    state = SimulationState.from_config(config_from_dict(BASE_CONFIG))
    t_rad, w = state.t_radiative, state.dilution_factor
    solver = PlasmaSolver(atom, state, radiative_rates_type="detailed",
                          w_epsilon=1e-7)
    est = lte.dilute_planck_j_blues(atom.line_nu, t_rad, w) * (
        1.0 + 0.5 * np.cos(np.arange(atom.n_lines)))[:, None]
    est[::4] = 0.0
    est[1::7] = -1.0
    ref = solver.update(t_rad, w, j_blues=est, line_mode="host")
    static = LineStatic.from_atom_data(
        atom_data_from_arrays(atom_data_to_arrays(atom)), "cpu")
    pop = torch.as_tensor(ref.level_number_density)
    args = (static, pop, t_rad, w, state.time_explosion)
    got = line_tables(*args, j_estimators=torch.as_tensor(est),
                      w_epsilon=1e-7)
    np.testing.assert_allclose(got.j_blues.numpy(), ref.j_blues, rtol=1e-12,
                               atol=0)
    assert (got.j_blues.numpy()[::4] < est.max() * 1e-6).all()
    plain = line_tables_plain(*args)
    for name in ("stim", "tau", "beta", "prefix"):
        assert torch.equal(getattr(got, name), getattr(plain, name)), name
    assert line_tables.launches == 0  # CPU tensors never launch


def _both(atom_data_prepared, cfg):
    """Both packages' run_tardis, and whether each of the port's
    iterations carried line estimators."""
    carried = []
    ref = run_tardis(copy.deepcopy(cfg), atom_data=atom_data_prepared)
    port = torch_run_tardis(
        copy.deepcopy(cfg),
        atom_data=atom_data_from_arrays(atom_data_to_arrays(
            atom_data_prepared)),
        device="cpu",
        callbacks=[lambda sim: carried.append(
            sim.last_transport_result.j_blue_estimator is not None)])
    return ref, port, carried


@pytest.fixture(scope="module")
def detailed_runs(atom_data_prepared):
    return _both(atom_data_prepared, DETAILED)


def test_detailed_nlte_run_matches_jax(detailed_runs):
    ref, port, carried = detailed_runs
    assert carried == [True, True, True]
    assert port.plasma_solver.nlte_species == [(14, 1)]
    assert len(port.history) == len(ref.history) == 2
    for h_p, h_r in zip(port.history, ref.history):
        assert abs(h_p.t_inner / h_r.t_inner - 1) < 0.01
        np.testing.assert_allclose(h_p.t_radiative, h_r.t_radiative,
                                   rtol=0.02)
        np.testing.assert_allclose(h_p.dilution_factor, h_r.dilution_factor,
                                   rtol=0.05)
    lum_p = port.spectrum_real.luminosity
    assert np.isfinite(port.spectrum_real.luminosity_nu).all()
    assert abs(lum_p / ref.spectrum_real.luminosity - 1) < 0.02


def test_detailed_final_plasma_keeps_the_estimator_j_blues(detailed_runs):
    """The final iteration transports on the plasma of the last
    advance_state: its j_blues are the estimators' (rtol 0.2 of the JAX
    package's, a Monte Carlo field at 2,048 packets), not dilute-Planck."""
    ref, port, _ = detailed_runs
    jb_p = port.plasma_state.j_blues.numpy()
    jb_r = ref.plasma_state.j_blues
    strong = jb_r > np.quantile(jb_r, 0.9)
    np.testing.assert_allclose(jb_p[strong], jb_r[strong], rtol=0.2)
    planck = lte.dilute_planck_j_blues(ref.atom_data.line_nu,
                                       port.plasma_state.t_rad,
                                       port.plasma_state.w)
    assert not np.allclose(jb_p, planck, rtol=1e-3)


def test_detailed_nonhomologous_matches_jax(atom_data_prepared):
    cfg = copy.deepcopy(CONFIG)
    cfg["plasma"]["radiative_rates_type"] = "detailed"
    cfg["montecarlo"]["enable_nonhomologous_expansion"] = True
    ref, port, carried = _both(atom_data_prepared, cfg)
    assert carried == [True, True, True]
    for h_p, h_r in zip(port.history, ref.history):
        assert np.isfinite(h_p.t_radiative).all()
        assert (h_p.t_radiative > 1000).all()
        np.testing.assert_allclose(h_p.t_radiative, h_r.t_radiative,
                                   rtol=0.02)
