"""Entry kind ``converge``: back-to-back TARDIS models, each its convergence
iterations (``Simulation.from_config``, then ``iterate`` and
``advance_state`` as ``run_convergence`` runs them), in a closed loop.

One prepared atomic dataset serves every model, as in a grid fit; model
m's Monte Carlo seed comes from (--seed, m), so every seed runs the same
sizes.  The window ends with the first whole iteration that ends after
``seconds``; every packet of every iteration in it counts.

The comparison: one iteration of the window, drawn from the seed
(reservoir sampling, so every iteration is as likely), is worked out again
by the reference from the radiation field it started from and the
electron density its plasma fixpoint started from (the program's state:
the reference follows the program step by step), and every output of
that iteration is compared: its plasma, chain tables, every packet, the
estimators, the luminosities and the damped field it handed on.  The
model's start, which this skips, is compared by itself.
"""

import copy
import time

import numpy as np
import torch

from portbench.compare import NAMES as NAMES, differing, gaps
from portbench.reference.atoms import make_atom_data, prepare
from portbench.reference.iteration import FieldState, run_iteration
from portbench.reference.macro import layout
from portbench.reference.model import build_model


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def model_seed(seed: int, m: int) -> int:
    return int(np.random.SeedSequence([seed, m]).generate_state(1)[0])


def elements(tardis_cfg: dict) -> list:
    from portbench.reference.constants import SYMBOLS

    ab = tardis_cfg["model"]["abundances"]
    return sorted(SYMBOLS.index(s) + 1 for s in ab if s != "type")


class Converge:
    def __init__(self, cell: dict, config: dict, device, probe):
        from tardis_torch.atomic.atom_data import AtomData
        import tardis_torch.transport.solver as solver

        self.cell, self.device, self.probe = cell, device, probe
        self.tardis = copy.deepcopy(config["tardis"])
        self.tardis["montecarlo"]["no_of_packets"] = int(cell["packets"])
        self.tardis["montecarlo"]["iterations"] = int(
            cell["iterations_per_model"]) + 1
        self.n = int(cell["packets"])
        self.raw = make_atom_data(config["atom_recipe"])
        lit = self.tardis["plasma"]["line_interaction_type"]
        self.atom = AtomData(**copy.deepcopy(self.raw)).prepare(
            selected_atoms=elements(self.tardis),
            line_interaction_type=lit)
        probe.wrap(solver, "solve_macro_chain", "k8")

    def _simulation(self, seed: int):
        from tardis_torch.config.reader import config_from_dict
        from tardis_torch.simulation.base import Simulation

        cfg = copy.deepcopy(self.tardis)
        cfg["montecarlo"]["seed"] = seed
        return Simulation.from_config(config_from_dict(cfg),
                                      atom_data=self.atom,
                                      device=self.device)

    def warm(self):
        """One model's first two iterations at the cell's sizes: every
        kernel built and loaded, the allocator's pools grown."""
        with torch.no_grad():
            sim = self._simulation(model_seed(0, 0))
            for it in range(2):
                sim.advance_state(sim.iterate(self.n, it), it)
        sync(self.device)

    def window(self, seconds: float, seed: int) -> dict:
        draw = np.random.default_rng(np.random.SeedSequence([seed, 1]))
        per_model = int(self.cell["iterations_per_model"])
        done = packets = failed = m = 0
        events, walls, sample = [], [], None
        t0 = t_prev = time.perf_counter()
        with torch.no_grad():
            while True:
                seed_m = model_seed(seed, m)
                sim = self._simulation(seed_m)
                st = sim.state
                start = (st.t_radiative.copy(), st.dilution_factor.copy(),
                         st.t_inner)
                for it in range(per_model):
                    before = FieldState(st.t_radiative.copy(),
                                        st.dilution_factor.copy(),
                                        st.t_inner, None)
                    res = sim.iterate(self.n, it)
                    ne0 = sim.plasma_solver._n_e_seed_used
                    plasma = sim.plasma_state
                    chain = self.probe.last.get("k8")
                    sim.advance_state(res, it)
                    sim.iterations_executed += 1
                    done += 1
                    packets += self.n
                    events.append(res.n_events)
                    if res.n_immortal or not np.all(
                            np.isfinite(st.t_radiative)):
                        failed += 1
                    if draw.random() * done < 1.0:
                        before.n_e_start = (None if ne0 is None
                                            else np.array(ne0))
                        sample = dict(
                            model=m, seed=seed_m, iteration=it,
                            before=before, start=start, plasma=plasma,
                            chain=chain, result=res,
                            after=(st.t_radiative.copy(),
                                   st.dilution_factor.copy(), st.t_inner))
                    t_now = time.perf_counter()
                    walls.append(t_now - t_prev)
                    t_prev = t_now
                    if t_now - t0 >= seconds:
                        break
                else:
                    m += 1
                    continue
                break
        sync(self.device)
        wall = time.perf_counter() - t0
        return dict(wall_s=wall, iterations=done, packets=packets,
                    failed=failed, models=m + 1, events=events,
                    iteration_s=walls, sample=sample,
                    metrics={"packets_per_s": (packets / wall,
                                               "packets/s")})

    def program_outputs(self, sample: dict) -> dict:
        res, plasma, chain = (sample["result"], sample["plasma"],
                              sample["chain"])
        return dict(
            start=sample["start"], n_e=np.array(plasma.electron_densities),
            tau=plasma.tau_sobolev, prefix=plasma.tau_prefix,
            chain_cdf=None if chain is None else chain.chain_cdf,
            emit_cdf=None if chain is None else chain.emit_cdf,
            out=res._out, last=res._li,
            est_j=res.j_estimator, est_nubar=res.nu_bar_estimator,
            emitted=res._lum_cache[2], reabsorbed=res._lum_cache[3],
            t_rad=sample["after"][0], w=sample["after"][1],
            t_inner=sample["after"][2])

    def reference(self):
        atoms = prepare(self.raw, elements(self.tardis))
        return atoms, layout(atoms), build_model(self.tardis)

    def check(self, sample: dict, control: bool = False) -> dict:
        """The comparison's numbers for one sampled iteration; with
        ``control`` the reference in f32 stands in the program's place."""
        return self.readings(sample, program=not control,
                             control=control)["control" if control
                                              else "program"]

    def readings(self, sample: dict, program=True, control=True) -> dict:
        """The numbers of the program and of the control, against one run
        of the reference."""
        atoms, lay, model = self.reference()
        ref = self.reference_outputs(atoms, lay, model, sample)
        out = {}
        for name, on, dtype in (("program", program, np.float64),
                                ("control", control, np.float32)):
            if not on:
                continue
            side = (self.program_outputs(sample) if dtype == np.float64
                    else self.reference_outputs(atoms, lay, model, sample,
                                                dtype))
            # the packets that differ, run again on this side's prefix
            rows = differing(side["out"], side["last"], ref["out"],
                             ref["last"])
            wit = run_iteration(
                self.tardis, atoms, lay, model, sample["before"],
                sample["seed"], sample["iteration"], self.n, self.device,
                prefix=side["prefix"], packets=rows)
            on_prefix = len(differing(side["out"][rows], side["last"][rows],
                                      wit["out"], wit["last"])) / self.n
            out[name] = gaps(side, ref, on_prefix)
            del side, wit
        return out

    def reference_outputs(self, atoms, lay, model, sample, dtype=np.float64):
        out = run_iteration(self.tardis, atoms, lay, model, sample["before"],
                            sample["seed"], sample["iteration"], self.n,
                            self.device, dtype)
        if dtype != np.float64:
            m32 = build_model(self.tardis, dtype)
            out["start"] = (m32.t_rad, m32.w, m32.t_inner)
        else:
            out["start"] = (model.t_rad, model.w, model.t_inner)
        return out


def make(cell, config, device, probe):
    return Converge(cell, config, device, probe)


def bound_inputs(driver: Converge, stats: dict) -> dict:
    """What the layer readers' bounds take: packets and events of each K1
    launch, and the chain tables' groups with their bandwidth."""
    atoms, lay, _ = driver.reference()
    return dict(k1_packets=driver.n, k1_events=stats["events"],
                k8_groups=[size for _, size in lay.groups],
                k8_bandwidth=lay.bandwidth,
                k8_shells=int(driver.tardis["model"]["structure"]
                              ["velocity"]["num"]),
                k8_lines=len(atoms.line_nu), k8_levels=atoms.n_macro,
                k8_width=lay.W, k8_emit_width=lay.We,
                k8_transitions=len(atoms.m_src))
