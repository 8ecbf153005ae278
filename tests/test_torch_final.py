"""The final iteration users run, end to end against the JAX package:
virtual packets (K1 spawn records + K4 volley) and the formal integral
(host source function + K5 rays), on the plain PyTorch versions.

Both packages run the slice configuration of ``test_torch_slice.py`` with
two virtual packets per record and the integrated spectrum, on the same
atomic data and seed, so they draw the same random bits: their spawn
records, and the spectra built from them, differ only where a trajectory
parts ways (a few packets in a thousand, ``test_torch_transport.py``).
Tolerances: spawn-record counts 1%, virtual and integrated luminosities 2%.
"""

import copy

import numpy as np
import pytest
import torch

from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.simulation.base import run_tardis as torch_run_tardis
from tardis_torch.spectrum.formal_integral import FormalIntegralSolver
from tardis_tpu.simulation.base import run_tardis

from tests.test_torch_slice import CONFIG

torch.set_num_threads(2)

FINAL_CONFIG = copy.deepcopy(CONFIG)
FINAL_CONFIG["montecarlo"]["no_of_virtual_packets"] = 2
FINAL_CONFIG["spectrum"]["method"] = "integrated"
FINAL_CONFIG["spectrum"]["integrated"] = {"points": 300}


@pytest.fixture(scope="module")
def sims(atom_data_prepared):
    ref = run_tardis(copy.deepcopy(FINAL_CONFIG), atom_data=atom_data_prepared)
    port_atom = atom_data_from_arrays(atom_data_to_arrays(atom_data_prepared))
    port = torch_run_tardis(copy.deepcopy(FINAL_CONFIG), atom_data=port_atom,
                            device="cpu")
    return ref, port


def test_spawn_records_match(sims):
    ref, port = sims
    n_ref = ref.last_transport_result.vp_records
    n_port = port.last_transport_result.vp_records
    assert n_ref > port.last_no_of_packets  # births plus interactions
    assert abs(n_port / n_ref - 1) < 0.01, (n_port, n_ref)


def test_virtual_spectrum_matches(sims):
    ref, port = sims
    sv, rv = port.spectrum_virtual, ref.spectrum_virtual
    assert np.isfinite(sv.luminosity_nu).all()
    np.testing.assert_array_equal(sv.nu_edges, rv.nu_edges)
    assert abs(sv.luminosity / rv.luminosity - 1) < 0.02
    # the virtual spectrum estimates the escaping luminosity
    assert 0.85 < sv.luminosity / port.spectrum_real.luminosity < 1.18


def test_integrated_spectrum_matches(sims):
    ref, port = sims
    si, ri = port.spectrum_integrated, ref.spectrum_integrated
    assert np.isfinite(si.luminosity_nu).all()
    np.testing.assert_array_equal(si.nu_edges, ri.nu_edges)
    assert abs(si.luminosity / ri.luminosity - 1) < 0.02
    assert 0.7 < si.luminosity / port.spectrum_real.luminosity < 1.4


def test_integrate_spectrum_after_run(sims):
    """``integrate_spectrum()`` recomputes the same spectrum after ``run()``,
    and refining the shells changes it only by discretization (15%, as the
    JAX package's own test allows)."""
    _, port = sims
    again = port.spectrum_integrated.luminosity_nu.copy()
    np.testing.assert_array_equal(port.integrate_spectrum().luminosity_nu,
                                  again)
    args = (port.spectrum_nu_edges, port.state, port.plasma_state,
            port.last_transport_result, port.atom_data)
    base = FormalIntegralSolver(n_points=120, n_impact_parameters=40).solve(
        *args, device="cpu")
    fine = FormalIntegralSolver(
        n_points=120, n_impact_parameters=40,
        interpolate_shells=3 * port.state.no_of_shells).solve(
            *args, device="cpu")
    lum_b = (base.luminosity_nu * np.diff(base.nu_edges)).sum()
    lum_f = (fine.luminosity_nu * np.diff(fine.nu_edges)).sum()
    assert lum_f > 0 and abs(lum_f / lum_b - 1) < 0.15


def test_virtual_packet_logging(atom_data_prepared):
    """With ``virtual_packet_logging`` every virtual packet that carries
    energy is returned under the reference's ``virt_packet_*`` names and
    sums to the virtual spectrum (f64 sums in another order: rtol 1e-10)."""
    cfg = copy.deepcopy(FINAL_CONFIG)
    cfg["spectrum"]["method"] = "virtual"
    cfg["spectrum"]["virtual"] = {"virtual_packet_logging": True}
    cfg["montecarlo"]["iterations"] = 1
    sim = torch_run_tardis(
        cfg, atom_data=atom_data_from_arrays(
            atom_data_to_arrays(atom_data_prepared)), device="cpu")
    res = sim.last_transport_result
    vp = res.vpackets
    n = len(vp["virt_packet_energies"])
    assert n > 0 and all(len(a) == n for a in vp.values())
    assert (vp["virt_packet_energies"] > 0).all()
    assert set(np.unique(vp["virt_packet_last_interaction_type"])) <= {
        -1, 1, 2}
    np.testing.assert_allclose(vp["virt_packet_energies"].sum(),
                               res.virt_energy_hist.sum(), rtol=1e-10)
    assert sim.spectrum_integrated is None
