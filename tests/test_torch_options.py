"""Configuration options no other port test holds, against the JAX package.

Each case runs both packages' ``run_tardis`` on ``test_torch_slice.py``'s
configuration (2,048 packets an iteration, the same atomic data and seed,
so the same random bits) with one option set: per iteration t_rad within
1e-3 and W within 5e-3 of the JAX package's.  The stopping case also stops
after the same number of iterations, before its last, with t_inner held
through the first iteration; the spawn-range case's virtual
spectra agree within the final spectrum's 2% and are empty far outside the
range on both sides.  Beside them, the options that change nothing log
what the JAX package logs, and vpacket biasing is refused with its reason.
"""

import copy
import logging

import numpy as np
import pytest
import torch

from tardis_torch.config.reader import config_from_dict as torch_config
from tardis_torch.model.state import SimulationState as TorchState
from tardis_torch.simulation import base as torch_base
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.simulation import base as jax_base
from tardis_tpu.simulation.base import Simulation

from tests.test_torch_model_structures import run_both
from tests.test_torch_slice import CONFIG

torch.set_num_threads(2)

SPAWN_RANGE = ("3000 angstrom", "7000 angstrom")


def option_config(case):
    cfg = copy.deepcopy(CONFIG)
    mc, sn, plasma = cfg["montecarlo"], cfg["supernova"], cfg["plasma"]
    mc.update(iterations=3, last_no_of_packets=2048)
    if case in ("disable_electron_scattering", "disable_line_scattering"):
        plasma[case] = True
    elif case == "luminosity_wavelength":
        sn.update(luminosity_wavelength_start="3500 angstrom",
                  luminosity_wavelength_end="9000 angstrom")
    elif case == "virtual_spectrum_spawn_range":
        mc.update(no_of_virtual_packets=2, iterations=2,
                  virtual_spectrum_spawn_range=dict(
                      zip(("start", "end"), SPAWN_RANGE)))
    elif case == "lock_t_inner_stop_if_converged":
        # a loose threshold so the run converges and stops before its
        # 8 iterations; t_inner moves every second iteration
        mc.update(iterations=8, convergence_strategy=dict(
            stop_if_converged=True, threshold=0.2, hold_iterations=1,
            lock_t_inner_cycles=2))
    return cfg


@pytest.mark.parametrize("case", [
    "disable_electron_scattering", "disable_line_scattering",
    "luminosity_wavelength", "virtual_spectrum_spawn_range",
    "lock_t_inner_stop_if_converged"])
def test_option_matches_jax(case, atom_data_prepared):
    cfg = option_config(case)
    ref, port = run_both(cfg, atom_data_prepared)
    assert len(port.history) == len(ref.history) >= 1
    for h_p, h_r in zip(port.history, ref.history):
        np.testing.assert_allclose(h_p.t_radiative, h_r.t_radiative,
                                   rtol=1e-3)
        np.testing.assert_allclose(h_p.dilution_factor, h_r.dilution_factor,
                                   rtol=5e-3)
        assert h_p.t_inner == pytest.approx(h_r.t_inner, rel=1e-3)
    if case == "lock_t_inner_stop_if_converged":
        assert len(port.history) < 7  # stopped before the last iteration
        # t_inner moves after the second iteration, not the first
        start = TorchState.from_config(torch_config(cfg)).t_inner
        assert port.history[0].t_inner == start
        assert port.history[1].t_inner != start
    if case == "virtual_spectrum_spawn_range":
        sv, rv = port.spectrum_virtual, ref.spectrum_virtual
        assert sv.luminosity > 0
        assert sv.luminosity == pytest.approx(rv.luminosity, rel=0.02)
        wl = np.asarray(sv.wavelength) * 1e8  # bin centres, cm -> angstrom
        lo, hi = (float(v.split()[0]) for v in SPAWN_RANGE)
        far = (wl < 0.8 * lo) | (wl > 1.25 * hi)
        assert far.any()
        assert not np.asarray(sv.luminosity_nu)[far].any()
        assert not np.asarray(rv.luminosity_nu)[far].any()


def test_no_op_options_log_as_the_jax_package(caplog, atom_data_prepared):
    """``montecarlo.nthreads`` and the vpacket roulette's knobs change
    nothing in either package; each logs one info line naming them."""
    cfg = copy.deepcopy(CONFIG)
    cfg["montecarlo"]["nthreads"] = 4
    cfg["spectrum"]["virtual"] = {"tau_russian": 5.0,
                                  "survival_probability": 0.1}
    names = ("montecarlo.nthreads",
             "spectrum.virtual.tau_russian/survival_probability")
    said = {}
    for package, run in (
            (torch_base, lambda: torch_base.check_supported(
                torch_config(copy.deepcopy(cfg)))),
            (jax_base, lambda: Simulation.from_config(
                config_from_dict(copy.deepcopy(cfg)),
                atom_data=atom_data_prepared))):
        caplog.clear()
        # the JAX package's logger does not propagate to the root logger
        log = logging.getLogger(package.__name__)
        log.addHandler(caplog.handler)
        try:
            with caplog.at_level(logging.INFO, logger=package.__name__):
                run()
        finally:
            log.removeHandler(caplog.handler)
        # once each, whether or not the record also reached the root
        said[package.__name__] = list(dict.fromkeys(
            r.getMessage() for r in caplog.records
            if r.levelno == logging.INFO and r.name == package.__name__
            and any(r.getMessage().startswith(n) for n in names)))
    for messages in said.values():
        assert [m.split()[0] for m in messages] == list(names)
    # the roulette's reason is the same words in both
    assert said[torch_base.__name__][1] == said[jax_base.__name__][1]


def test_biasing_is_refused_with_the_jax_packages_reason(atom_data_prepared):
    cfg = copy.deepcopy(CONFIG)
    cfg["spectrum"]["virtual"] = {"enable_biasing": True}
    with pytest.raises(NotImplementedError) as port_error:
        torch_base.check_supported(torch_config(copy.deepcopy(cfg)))
    with pytest.raises(NotImplementedError) as jax_error:
        Simulation.from_config(config_from_dict(copy.deepcopy(cfg)),
                               atom_data=atom_data_prepared)
    assert str(port_error.value) == str(jax_error.value)
    assert "not ported" not in str(port_error.value)
