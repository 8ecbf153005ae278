"""The Type IIP workflow end to end: the port's ``TypeIIPWorkflow`` against
the JAX package's on one configuration, the refusals around it, and the
classic loop with continuum species through both entry points.

The configuration is the JAX package's IIP problem (H / He, H I continua,
macroatom, 20 shells) moved outward and later, 1.5e4-2.5e4 km/s at 16
days: the workflow cannot cap a packet's events, and at 1.1e4 km/s and 13
days a few packets random-walk 1e4-1e5 events through continuum-thick
inner shells, which the lockstep loops of both packages step one event at
a time (minutes on a CPU).  Here no packet of the three iterations
(300 packets each, the thermal balance at 3 evaluations) walks more than
61 events, so each package's run takes seconds.  Both packages draw the
same bits and run the same host f64 plasma, continuum state and least
squares; they differ only in the f32 two-float sums of the JAX package's
estimators (f64 here), so every quantity is held within 1e-4 relative
(measured: W within 2.7e-6, the damped estimators within
6.6e-6 on entries above 1e-6 of the largest, link and n_e within 7.1e-7,
t_inner within 6.2e-10).
"""

import copy

import numpy as np
import pytest
import torch

from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.workflows.simple import StandardTARDISWorkflow
from tardis_torch.workflows.type_iip import TypeIIPWorkflow as TorchIIP
from tardis_tpu.atomic.synthetic import make_synthetic_atom_data
from tardis_tpu.workflows.type_iip import TypeIIPWorkflow

torch.set_num_threads(2)

CONFIG = {
    "supernova": {"luminosity_requested": "9.44 log_lsun",
                  "time_explosion": "16 day"},
    "model": {"structure": {"type": "specific",
                            "velocity": {"start": "1.5e4 km/s",
                                         "stop": "2.5e4 km/s", "num": 20},
                            "density": {"type": "branch85_w7"}},
              "abundances": {"type": "uniform", "H": 0.8, "He": 0.2}},
    "plasma": {"line_interaction_type": "macroatom",
               "continuum_interaction": {"species": ["H I"]}},
    "montecarlo": {"seed": 23111963, "no_of_packets": 300, "iterations": 3,
                   "last_no_of_packets": 300},
    "spectrum": {"start": "500 angstrom", "stop": "20000 angstrom",
                 "num": 100},
}
RTOL = 1e-4
ESTIMATORS = ("photo_ion", "stim_recomb", "bf_heating", "stim_recomb_cooling",
              "photo_ion_statistics", "ff_heating")


def _atom():
    return make_synthetic_atom_data(
        atomic_numbers=(1, 2), max_ion_stage=2, n_levels=10,
        continuum_species=((1, 0),),
    ).prepare(line_interaction_type="macroatom")


@pytest.fixture(scope="module")
def workflows():
    atom = _atom()
    ref = TypeIIPWorkflow(copy.deepcopy(CONFIG), atom_data=atom,
                          thermal_balance_max_nfev=3).run()
    port = TorchIIP(copy.deepcopy(CONFIG),
                    atom_data=atom_data_from_arrays(atom_data_to_arrays(atom)),
                    thermal_balance_max_nfev=3, device="cpu").run()
    return ref, port


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def test_radiation_field_and_thermal_balance(workflows):
    """t_rad, W, t_inner, the per-shell link_t_rad_t_electron the thermal
    balance leaves, n_e and the final spectrum's luminosity within RTOL;
    the iteration histories too."""
    ref, port = workflows
    assert ref.completed and port.completed
    r, p = ref.sim, port.sim
    assert _rel(p.state.t_radiative, r.state.t_radiative) <= RTOL
    assert _rel(p.state.dilution_factor, r.state.dilution_factor) <= RTOL
    assert _rel(p.state.t_inner, r.state.t_inner) <= RTOL
    link_p = np.asarray(p.plasma_solver.link_t_rad_t_electron)
    link_r = np.asarray(r.plasma_solver.link_t_rad_t_electron)
    assert link_p.shape == (20,) and _rel(link_p, link_r) <= RTOL
    assert (link_p > 0).all() and (link_p <= 1.5).all()
    assert _rel(p.plasma_state.electron_densities,
                r.plasma_state.electron_densities) <= RTOL
    assert len(p.history) == len(r.history) == 2
    for h_p, h_r in zip(p.history, r.history):
        assert _rel(h_p.t_radiative, h_r.t_radiative) <= RTOL
        assert _rel(h_p.emitted_luminosity, h_r.emitted_luminosity) <= RTOL
    assert _rel(p.spectrum_real.luminosity, r.spectrum_real.luminosity) <= RTOL


@pytest.mark.parametrize("field", ESTIMATORS)
def test_damped_continuum_estimators(workflows, field):
    """The damped continuum estimators after the run: every entry above
    1e-6 of the largest within RTOL, the statistics counts equal."""
    ref, port = workflows
    a = getattr(port.cont_estimators, field)
    b = getattr(ref.cont_estimators, field)
    assert a.shape == b.shape and np.isfinite(a).all()
    if field == "photo_ion_statistics":
        np.testing.assert_array_equal(a, b)
        return
    big = np.abs(b) > 1e-6 * np.abs(b).max()
    assert big.sum() >= 10 and _rel(a[big], b[big]) <= RTOL
    np.testing.assert_allclose(port._damping, ref._damping, rtol=RTOL)


def test_continuum_transport_options(workflows):
    """Continuum forces full relativity and the relativistic pool; the
    last iteration's per-packet event counts and last-interaction rows are
    there, the events adding up to the run's total."""
    _, port = workflows
    t = port.sim.transport
    assert t.full_relativity(True) and t.pool_for(True) == "relativistic"
    assert not t.enable_full_relativity and t.pool == "simple"
    res = port.sim.last_transport_result
    assert res.events.shape == (300,)
    assert int(res.events.sum()) == res.n_events and res.n_immortal == 0
    assert res.last_interaction["type"].shape == (300,)
    assert res.continuum.photo_ion.shape == (10, 20)


def test_refusals():
    """The workflow needs photoionization data and macroatom; the
    convergence plots are no longer refused (tests/test_torch_viz.py runs
    them), nor are continuum species in the classic loop
    (``test_classic_loop_with_continuum_species``)."""
    from tardis_torch.atomic.synthetic import make_synthetic_atom_data as syn

    plain = syn(atomic_numbers=(1, 2), max_ion_stage=2, n_levels=5)
    with pytest.raises(ValueError, match="photoionization"):
        TorchIIP(copy.deepcopy(CONFIG), atom_data=plain, device="cpu")
    cfg = copy.deepcopy(CONFIG)
    cfg["plasma"]["line_interaction_type"] = "scatter"
    with pytest.raises(ValueError, match="macroatom"):
        TorchIIP(cfg, atom_data=_torch_atom(), device="cpu")
    cfg = copy.deepcopy(CONFIG)
    del cfg["plasma"]["continuum_interaction"]
    wf = StandardTARDISWorkflow(cfg, atom_data=_torch_atom(), device="cpu",
                                show_convergence_plots=True)
    assert wf.show_convergence_plots


def _torch_atom():
    return atom_data_from_arrays(atom_data_to_arrays(_atom()))


def _classic_runs(entry):
    """Both packages' ``entry`` ("run_tardis" or "workflow", the standard
    workflow) on CONFIG: continuum species with the classic loop."""
    from tardis_torch.simulation.base import run_tardis as torch_run
    from tardis_tpu.simulation.base import run_tardis
    from tardis_tpu.workflows.simple import (
        StandardTARDISWorkflow as JaxStandard,
    )

    if entry == "run_tardis":
        return (run_tardis(copy.deepcopy(CONFIG), atom_data=_atom()),
                torch_run(copy.deepcopy(CONFIG), atom_data=_torch_atom(),
                          device="cpu"))
    ref = JaxStandard(copy.deepcopy(CONFIG), atom_data=_atom()).run()
    port = StandardTARDISWorkflow(copy.deepcopy(CONFIG),
                                  atom_data=_torch_atom(), device="cpu").run()
    return ref.sim, port.sim


@pytest.mark.parametrize("entry", ["run_tardis", "workflow"])
def test_classic_loop_with_continuum_species(entry):
    """``run_tardis`` and ``StandardTARDISWorkflow`` with continuum species
    run what the JAX package runs: the classic transport, which ignores
    the continua, with the plasma in host line mode and no final
    re-solve.  t_rad, W, t_inner and the emitted luminosity of every
    iteration and the real spectrum's luminosity within RTOL (measured:
    t_rad 2.2e-7, W 1.5e-6, t_inner 2.8e-8, L 1.1e-7, the spectrum's
    luminosity 2.5e-10)."""
    ref, port = _classic_runs(entry)
    assert not port._device_line_ok() and not ref._device_line_ok()
    assert port.last_transport_result.continuum is None
    assert len(port.history) == len(ref.history) == 2
    for h_p, h_r in zip(port.history, ref.history):
        assert _rel(h_p.t_radiative, h_r.t_radiative) <= RTOL
        assert _rel(h_p.dilution_factor, h_r.dilution_factor) <= RTOL
        assert _rel(h_p.t_inner, h_r.t_inner) <= RTOL
        assert _rel(h_p.emitted_luminosity, h_r.emitted_luminosity) <= RTOL
    assert _rel(port.state.t_radiative, ref.state.t_radiative) <= RTOL
    assert _rel(port.state.t_inner, ref.state.t_inner) <= RTOL
    assert _rel(port.spectrum_real.luminosity,
                ref.spectrum_real.luminosity) <= RTOL


def test_standard_workflow_runs_the_classic_loop():
    """StandardTARDISWorkflow drives the classic loop as run_tardis does:
    the same history and spectrum on the CPU."""
    from tardis_torch.simulation.base import run_tardis

    cfg = copy.deepcopy(CONFIG)
    del cfg["plasma"]["continuum_interaction"]
    cfg["montecarlo"]["iterations"] = 2
    wf = StandardTARDISWorkflow(copy.deepcopy(cfg), atom_data=_torch_atom(),
                                device="cpu", show_progress_bars=False).run()
    sim = run_tardis(copy.deepcopy(cfg), atom_data=_torch_atom(),
                     device="cpu")
    assert wf.completed and len(wf.sim.history) == len(sim.history) == 1
    assert wf.sim.history[0].t_inner == sim.history[0].t_inner
    np.testing.assert_array_equal(wf.sim.spectrum_real.luminosity_nu,
                                  sim.spectrum_real.luminosity_nu)
