"""Entry kind ``iip_model``: back-to-back whole Type IIP models
(``TypeIIPWorkflow(...).run()``: the convergence iterations, each with its
thermal balance, then the final iteration and its real-packet spectrum),
in a closed loop.

One prepared atomic dataset serves every model; model m's Monte Carlo
seed comes from (--seed, m), so every seed runs the same sizes.  The
window ends with the first whole model that ends after ``seconds``;
``model_s`` is the window's seconds over its models.

The comparison: one model of the window, drawn from the seed (reservoir
sampling), has each stage of each iteration recorded as the program ran
it, and the reference works every stage out again from the state that
iteration started from (the program's: the field, the link, the electron
density its thermal balance fixed, the damped estimators of the last
iteration; the reference follows the program step by step), and the
model's start by itself.  The transport is worked out again in full for
one of the later iterations, drawn from the seed, and for a sample of
the first iteration's packets (the random-walk iteration, whose longest
packets take minutes of a plain loop), drawn from the seed, those the
reference finishes within ``ref_event_cap`` events; the other
iterations' stages after the transport take the program's estimators.
"""

import copy
import time

import numpy as np
import torch

from portbench.compare import TAU_FLOOR, abs_t, differing, rel, rel_t
from portbench.reference import iip
from portbench.reference.atoms import make_atom_data, prepare
from portbench.reference.continuum import Continua, Estimators, State
from portbench.reference.model import build_model
from portbench.reference.plasma import solve_plasma

NAMES = ("start_gap", "plasma_gap", "continuum_gap", "macro_gap",
         "packets_differ", "packets_differ_on_prefix", "estimator_gap",
         "luminosity_gap", "field_gap", "balance_gap", "spectrum_gap")


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def model_seed(seed: int, m: int) -> int:
    return int(np.random.SeedSequence([seed, m]).generate_state(1)[0])


def elements(tardis_cfg: dict) -> list:
    from portbench.reference.constants import SYMBOLS

    ab = tardis_cfg["model"]["abundances"]
    return sorted(SYMBOLS.index(s) + 1 for s in ab if s != "type")


def normwise(a, b) -> float:
    """max |a - b| / max |b| (0 where both are 0)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    d = float(np.max(np.abs(a - b))) if a.size else 0.0
    s = float(np.max(np.abs(b))) if b.size else 0.0
    return d / s if s > 0 else (0.0 if d == 0 else float("inf"))


class IIPModel:
    def __init__(self, cell: dict, config: dict, device, probe):
        from tardis_torch.atomic.atom_data import (
            AtomData,
            PhotoIonizationData,
        )
        import tardis_torch.workflows.type_iip as type_iip

        self.cell, self.device, self.probe = cell, device, probe
        self.tardis = copy.deepcopy(config["tardis"])
        mc = self.tardis["montecarlo"]
        self.n = int(cell["packets"])
        mc["no_of_packets"] = mc["last_no_of_packets"] = self.n
        mc["iterations"] = int(cell["iterations_per_model"])
        self.nfev = int(config["thermal_balance_max_nfev"])
        self.raw = make_atom_data(config["atom_recipe"])
        raw = copy.deepcopy(self.raw)
        raw["photo_ion"] = PhotoIonizationData(**raw["photo_ion"])
        self.atom = AtomData(**raw).prepare(
            selected_atoms=elements(self.tardis),
            line_interaction_type="macroatom")
        probe.wrap(type_iip, "solve_continuum_macro_state", "macro")

    def _workflow(self, seed: int):
        from tardis_torch.config.reader import config_from_dict
        from tardis_torch.workflows.type_iip import TypeIIPWorkflow

        cfg = copy.deepcopy(self.tardis)
        cfg["montecarlo"]["seed"] = seed
        return TypeIIPWorkflow(config_from_dict(cfg), atom_data=self.atom,
                               thermal_balance_max_nfev=self.nfev,
                               device=self.device)

    def _record(self, wf) -> list:
        """Wraps the workflow's stages on this instance so that each
        iteration's inputs and outputs are kept as the program made them;
        the stages themselves run unchanged."""
        sim, probe, recs = wf.sim, self.probe, []
        pl = sim.plasma_solver
        S = sim.state.no_of_shells

        def arr(x):
            return None if x is None else np.array(
                np.broadcast_to(np.asarray(x, np.float64), (S,)))

        montecarlo = wf.solve_montecarlo
        advance = wf.solve_simulation_state
        balance = wf.solve_thermal_balance

        def solve_montecarlo(n_packets, iteration):
            st = sim.state
            before = iip.Before(
                st.t_radiative.copy(), st.dilution_factor.copy(),
                st.t_inner, arr(pl.link_t_rad_t_electron),
                arr(pl._fixed_electron_densities), arr(pl._last_n_e),
                wf.cont_estimators)
            res = montecarlo(n_packets, iteration)
            recs.append(dict(it=iteration, n=n_packets, before=before,
                             plasma=sim.plasma_state, cont=wf.cont_state,
                             macro=probe.last["macro"], result=res,
                             damped=wf.cont_estimators))
            return res

        def solve_simulation_state(result, iteration):
            seed_ne = arr(pl._last_n_e)
            converged = advance(result, iteration)
            st = sim.state
            recs[-1].update(after=(st.t_radiative.copy(),
                                   st.dilution_factor.copy(), st.t_inner),
                            advance_seed=seed_ne,
                            advance_n_e=arr(sim.plasma_state
                                            .electron_densities))
            return converged

        def solve_thermal_balance():
            n_e0 = arr(sim.plasma_state.electron_densities)
            out = balance()
            recs[-1].update(balance_n_e0=n_e0,
                            balance=(arr(pl.link_t_rad_t_electron),
                                     arr(pl._fixed_electron_densities)))
            return out

        wf.solve_montecarlo = solve_montecarlo
        wf.solve_simulation_state = solve_simulation_state
        wf.solve_thermal_balance = solve_thermal_balance
        return recs

    def warm(self):
        """One whole model at the cell's sizes: every kernel built and
        loaded, scipy's solver imported, the allocator's pools grown."""
        with torch.no_grad():
            self._workflow(model_seed(0, 0)).run()
        sync(self.device)

    def window(self, seconds: float, seed: int) -> dict:
        draw = np.random.default_rng(np.random.SeedSequence([seed, 1]))
        done = failed = m = 0
        events, sample = [], None
        t0 = time.perf_counter()
        while True:
            seed_m = model_seed(seed, m)
            wf = self._workflow(seed_m)
            start = (wf.sim.state.t_radiative.copy(),
                     wf.sim.state.dilution_factor.copy(),
                     wf.sim.state.t_inner,
                     np.array(wf.sim.plasma_solver.link_t_rad_t_electron))
            recs = self._record(wf)
            wf.run()
            done += len(recs)
            for r in recs:
                events.append(r["result"].n_events)
                failed += int(r["result"].n_immortal > 0)
            spec = wf.sim.spectrum_real.luminosity_nu
            if (not np.all(np.isfinite(wf.sim.state.t_radiative))
                    or not np.all(np.isfinite(spec))):
                failed += 1
            if draw.random() * (m + 1) < 1.0:
                sample = dict(model=m, seed=seed_m, start=start,
                              records=recs, spectrum=np.array(spec))
            m += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        wall = time.perf_counter() - t0
        k = min(self.n, int(self.cell["ref_packets"]))
        sample["picked"] = [np.sort(draw.choice(self.n, size=k,
                                                replace=False))
                            for _ in sample["records"][:-1]]
        return dict(wall_s=wall, iterations=done, failed=failed, models=m,
                    events=events, sample=sample,
                    metrics={"model_s": (wall / m, "s")})

    # ------------------------------------------------------------ check
    def reference(self):
        atoms = prepare(self.raw, elements(self.tardis))
        return atoms, Continua(atoms), build_model(self.tardis)

    def program_side(self, sample: dict) -> dict:
        """The program's outputs, in the reference's layout (packet rows
        by packet id)."""
        its = []
        for r in sample["records"]:
            res, ps = r["result"], r["plasma"]
            it = dict(
                n_e=np.array(ps.electron_densities), tau=ps.tau_sobolev,
                prefix=ps.tau_prefix, cs=r["cont"], macro=r["macro"],
                out=res._out, last=res._li,
                est_j=res.j_estimator, est_nubar=res.nu_bar_estimator,
                emitted=res._lum_cache[2], reabsorbed=res._lum_cache[3],
                raw=res.continuum, damped=r["damped"])
            if "after" in r:
                it.update(after=r["after"], advance_n_e=r["advance_n_e"],
                          balance=r["balance"])
            its.append(it)
        return dict(start=sample["start"], iterations=its,
                    spectrum=sample["spectrum"])

    def _ids(self, sample, i):
        """The packets compared in iteration i: every one in the last, the
        sample drawn from the seed in the others."""
        if i == len(sample["records"]) - 1:
            return torch.arange(self.n, device=self.device)
        return torch.as_tensor(sample["picked"][i], device=self.device)

    def _cap(self, sample, i):
        return (500_000 if i == len(sample["records"]) - 1
                else int(self.cell["ref_event_cap"]))

    def side(self, ref, sample, dtype=np.float64) -> dict:
        """The reference's outputs (f64), or the control's (f32), each
        stage from the state the program's iteration started from; packet
        rows in the order of ``_ids``."""
        atoms, cont, model = ref
        m0 = build_model(self.tardis, dtype)
        start = (m0.t_rad, m0.w, m0.t_inner,
                 iip.round_to(m0.w**0.25, dtype))
        est_dtype = torch.float64 if dtype == np.float64 else torch.float32
        last_i = len(sample["records"]) - 1
        its, spectrum = [], None
        for i, r in enumerate(sample["records"]):
            b, res = r["before"], r["result"]
            pl, cs, macro = iip.plasma_and_continuum(atoms, model, cont, b,
                                                     self.device, dtype)
            prefix = pl.prefix.float() if dtype != np.float64 else pl.prefix
            mu, nu, w = iip.pool(sample["seed"], r["it"],
                                 torch.arange(self.n, device=self.device),
                                 b.t_inner, model, self.device)
            ids = self._ids(sample, i)
            tr = iip.run_transport(atoms, model, sample["seed"], r["it"],
                                   pl.n_e, prefix, cs, macro, mu[ids],
                                   nu[ids], w[ids], ids, self.device,
                                   max_events=self._cap(sample, i),
                                   est_dtype=est_dtype)
            it = dict(n_e=pl.n_e, tau=pl.tau, prefix=prefix, cs=cs,
                      macro=macro, pool=(mu, nu, w), ids=ids, out=tr.out,
                      last=tr.last, events=tr.events)
            if i == last_i:
                e = iip.estimators(atoms, model, tr, self.n)
                e["raw"] = e.pop("continuum")
                it.update(e)
                spectrum = iip.spectrum(self.tardis, model, tr.out, self.n)
            del tr
            # the stages after the transport: from this side's estimators
            # where it ran every packet, else from the program's
            est_j = it.get("est_j", res.j_estimator)
            it["damped"] = iip.damp_estimators(
                model, b, est_j, it.get("raw", res.continuum))
            if "after" in r:
                t_rad, w_new, t_inner = iip.field_update(
                    self.tardis, model, b, est_j, res.nu_bar_estimator,
                    res._lum_cache[2], dtype)
                seed_ne = r["advance_seed"] if b.n_e_fixed is None else None
                adv = solve_plasma(atoms, model, t_rad, w_new, seed_ne,
                                   self.device, dtype, n_e_fixed=b.n_e_fixed,
                                   lines=False)
                it.update(after=(t_rad, w_new, t_inner),
                          advance_n_e=adv.n_e,
                          balance=iip.thermal_balance(
                              atoms, model, cont, t_rad, w_new, b.link,
                              adv.n_e, it["damped"], self.nfev, self.device,
                              dtype))
            its.append(it)
        return dict(start=start, iterations=its, spectrum=spectrum)

    def on_prefix(self, ref, sample, side, r, i, rows, ids) -> int:
        """Of the packets ``ids`` (the side's rows ``rows``), which differ
        from the reference on its own tables, those that differ again when
        the reference's transport takes the side's tau prefix in place of
        its own (its other tables are the side's too wherever
        ``continuum_gap`` and ``macro_gap`` read 0)."""
        if not len(ids):
            return 0
        atoms, _, model = ref
        s = side["iterations"][i]
        mu, nu, w = (x[ids] for x in r["pool"])
        tr = iip.run_transport(
            atoms, model, sample["seed"], sample["records"][i]["it"],
            r["n_e"], s["prefix"].to(self.device), r["cs"], r["macro"],
            mu, nu, w, ids, self.device, max_events=self._cap(sample, i))
        return len(differing(s["out"][rows], s["last"][rows], tr.out,
                             tr.last))

    def gaps(self, ref_tables, sample, side: dict, ref: dict,
             by_id: bool) -> dict:
        """``by_id``: the side's packet rows are by packet id (the
        program's), else in the order of ``_ids``."""
        g = dict.fromkeys(NAMES, 0.0)

        def up(name, v):
            g[name] = max(g[name], v)

        up("start_gap", max(rel(a, b) for a, b in zip(side["start"],
                                                      ref["start"])))
        for i, (s, r) in enumerate(zip(side["iterations"],
                                       ref["iterations"])):
            up("plasma_gap", max(rel(s["n_e"], r["n_e"]),
                                 rel_t(s["tau"], r["tau"], TAU_FLOOR),
                                 rel_t(s["prefix"], r["prefix"], TAU_FLOOR)))
            up("continuum_gap", max(normwise(getattr(s["cs"], k),
                                             getattr(r["cs"], k))
                                    for k in State.COMPARED))
            up("macro_gap", max(
                abs_t(torch.as_tensor(s["macro"].cum_B),
                      torch.as_tensor(r["macro"].cum_B)),
                abs_t(torch.as_tensor(s["macro"].deact_cum_prob),
                      torch.as_tensor(r["macro"].deact_cum_prob))))
            # the packets the reference finished
            done = (r["events"] >= 0).nonzero()[:, 0]
            rows = r["ids"][done] if by_id else done
            bad = differing(s["out"][rows], s["last"][rows], r["out"][done],
                            r["last"][done])
            n = max(1, len(done))
            up("packets_differ", len(bad) / n)
            up("packets_differ_on_prefix", self.on_prefix(
                ref_tables, sample, side, r, i, rows[bad],
                r["ids"][done][bad]) / n)
            if "raw" in r:
                up("estimator_gap", max(
                    rel(s["est_j"], r["est_j"]),
                    rel(s["est_nubar"], r["est_nubar"]),
                    max(normwise(getattr(s["raw"], k), getattr(r["raw"], k))
                        for k in Estimators.FIELDS)))
                up("luminosity_gap", max(rel(s["emitted"], r["emitted"]),
                                         rel(s["reabsorbed"],
                                             r["reabsorbed"])))
            up("estimator_gap", max(normwise(getattr(s["damped"], k),
                                             getattr(r["damped"], k))
                                    for k in Estimators.FIELDS))
            if "after" in r:
                up("field_gap", max(rel(a, b) for a, b in zip(s["after"],
                                                              r["after"])))
                up("plasma_gap", rel(s["advance_n_e"], r["advance_n_e"]))
                up("balance_gap", max(rel(s["balance"][0], r["balance"][0]),
                                      rel(s["balance"][1], r["balance"][1])))
        up("spectrum_gap", normwise(side["spectrum"], ref["spectrum"]))
        return g

    def check(self, sample: dict, control: bool = False) -> dict:
        return self.readings(sample, program=not control, control=control)[
            "control" if control else "program"]

    def readings(self, sample: dict, program=True, control=True) -> dict:
        """The numbers of the program and of the control, against one
        working-out of the reference, and the share of each convergence
        iteration's sampled packets that the reference finished."""
        t0 = time.perf_counter()
        ref = self.reference()
        r = self.side(ref, sample)
        out = {"reference_s": time.perf_counter() - t0}
        if program:
            p = self.program_side(sample)
            out["program"] = self.gaps(ref, sample, p, r, by_id=True)
            del p
        if control:
            c = self.side(ref, sample, np.float32)
            out["control"] = self.gaps(ref, sample, c, r, by_id=False)
            del c
        out["finished"] = [float((it["events"] >= 0).double().mean())
                           for it in r["iterations"]]
        return out


def make(cell, config, device, probe):
    return IIPModel(cell, config, device, probe)


def bound_inputs(driver: IIPModel, stats: dict) -> dict:
    """What the layer readers' bounds take: packets and events of each K1
    launch, the continuum grid's cells and the shells."""
    from portbench.reference.continuum_transport import continuum_grid

    atoms = prepare(driver.raw, elements(driver.tardis))
    grid, _ = continuum_grid(atoms.photo_ion)
    return dict(k1_packets=driver.n, k1_events=stats["events"],
                grid_cells=len(grid) - 1,
                shells=int(driver.tardis["model"]["structure"]["velocity"]
                           ["num"]))
