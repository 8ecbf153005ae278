"""The port's classic convergence loop end to end against the JAX package.

Both run the same configuration on the same atomic data with the same
seed, so they draw the same random bits and their trajectories are
correlated far beyond Monte Carlo noise: per-iteration t_inner within 1%,
t_rad within 2%, W within 5%, and the final real-packet spectrum's
luminosity within 2%.
"""

import copy

import numpy as np
import pytest
import torch

from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.atomic.synthetic import (
    make_synthetic_atom_data as torch_synthetic,
)
from tardis_torch.simulation.base import run_tardis as torch_run_tardis
from tardis_tpu.simulation.base import run_tardis

torch.set_num_threads(2)

CONFIG = {
    "supernova": {"luminosity_requested": "9.44 log_lsun",
                  "time_explosion": "13 day"},
    "model": {"structure": {"type": "specific",
                            "velocity": {"start": "1.1e4 km/s",
                                         "stop": "20000 km/s", "num": 20},
                            "density": {"type": "branch85_w7"}},
              "abundances": {"type": "uniform", "O": 0.19, "Mg": 0.03,
                             "Si": 0.52, "S": 0.19, "Ar": 0.04,
                             "Ca": 0.03}},
    "plasma": {"line_interaction_type": "macroatom"},
    "montecarlo": {"seed": 23, "no_of_packets": 2048, "iterations": 3,
                   "last_no_of_packets": 4096, "no_of_virtual_packets": 0,
                   "tracking": {"track_last_interaction": False}},
    "spectrum": {"start": "500 angstrom", "stop": "20000 angstrom",
                 "num": 200},
}


@pytest.fixture(scope="module")
def sims(atom_data_prepared):
    ref = run_tardis(copy.deepcopy(CONFIG), atom_data=atom_data_prepared)
    port = torch_run_tardis(
        copy.deepcopy(CONFIG),
        atom_data=atom_data_from_arrays(
            atom_data_to_arrays(atom_data_prepared)),
        device="cpu",
    )
    return ref, port


def test_iteration_history(sims):
    ref, port = sims
    assert len(port.history) == len(ref.history) == 2
    for h_p, h_r in zip(port.history, ref.history):
        assert abs(h_p.t_inner / h_r.t_inner - 1) < 0.01
        np.testing.assert_allclose(h_p.t_radiative, h_r.t_radiative,
                                   rtol=0.02)
        np.testing.assert_allclose(h_p.dilution_factor, h_r.dilution_factor,
                                   rtol=0.05)


def test_final_spectrum(sims):
    ref, port = sims
    lum_p = port.spectrum_real.luminosity
    lum_r = ref.spectrum_real.luminosity
    assert np.isfinite(port.spectrum_real.luminosity_nu).all()
    assert abs(lum_p / lum_r - 1) < 0.02
    np.testing.assert_array_equal(port.spectrum_real.nu_edges,
                                  ref.spectrum_real.nu_edges)
    res = port.last_transport_result
    assert res.n_packets == 4096 and res.n_immortal == 0
    assert res.j_blue_estimator.shape == ref.last_transport_result \
        .j_blue_estimator.shape


def test_converter_matches_port_generator(atom_data_prepared):
    """The port's own synthetic generator and the converted JAX data give
    identical arrays, so either feeds the port the same problem."""
    ours = atom_data_to_arrays(torch_synthetic().prepare(
        selected_atoms=[8, 12, 14, 16, 18, 20],
        line_interaction_type="macroatom",
    ))
    theirs = atom_data_to_arrays(atom_data_prepared)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    back = atom_data_to_arrays(atom_data_from_arrays(theirs))
    for k in theirs:
        np.testing.assert_array_equal(back[k], theirs[k], err_msg=k)
