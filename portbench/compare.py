"""The comparison that decides ``correct``: the numbers by which what the
timed path produced lies from what the reference works out again, each
held to the limit the cell's traffic file gives it.  Each driver names its
numbers (``NAMES``); this module holds the measures they share and the
converge cells' numbers (each a worst case over its entries):

- ``start_gap``: the model's starting t_rad, W and t_inner, relative;
- ``plasma_gap``: electron densities, and the Sobolev depths and their
  per-shell prefix sums relative to max(|x|, 1e-10) (a depth below 1e-10
  moves no packet);
- ``chain_gap``: the chain and emission CDF rows, absolute;
- ``packets_differ``: the share of packets whose output row (signed nu,
  energy) or last-interaction row is not bitwise the reference's;
- ``packets_differ_on_prefix``: the share of packets that differ from
  the reference's transport on its own tables and again on the program's
  tau prefix (the prefix's rounding order is then no cause: a packet that
  differs here is the event loop's);
- ``estimator_gap``: the j and nu-bar estimators of each shell, relative;
- ``luminosity_gap``: emitted and reabsorbed luminosity, relative;
- ``field_gap``: the damped t_rad, W and t_inner handed on, relative.
"""

import numpy as np
import torch

TAU_FLOOR = 1e-10
NAMES = ("start_gap", "plasma_gap", "chain_gap", "packets_differ",
         "packets_differ_on_prefix", "estimator_gap", "luminosity_gap",
         "field_gap")


def rel(a, b, floor=0.0) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    if a.shape != b.shape:
        return float("inf")
    with np.errstate(divide="ignore", invalid="ignore"):
        d = np.where(a == b, 0.0,
                     np.abs(a - b) / np.maximum(np.abs(b), floor))
    return float(np.max(d)) if d.size else 0.0


def rel_t(a: torch.Tensor, b: torch.Tensor, floor: float) -> float:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.shape != b.shape:
        return float("inf")
    if not b.numel():
        return 0.0
    a, b = a.to(b.device, torch.float64), b.to(torch.float64)
    return float((torch.abs(a - b) / torch.clamp(torch.abs(b), min=floor))
                 .max())


def abs_t(a, b) -> float:
    if a is None or b is None:
        return 0.0 if a is None and b is None else float("inf")
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.shape != b.shape:
        return float("inf")
    if not b.numel():
        return 0.0
    return float(torch.abs(a.to(b.device).double() - b.double()).max())


def differing(out, last, ref_out, ref_last):
    """The rows (ids) whose output or last-interaction row is not bitwise
    the reference's."""
    out, last = out.to(ref_out.device), last.to(ref_out.device)
    return ((out != ref_out).any(1) | (last != ref_last).any(1)).nonzero()[
        :, 0]


def gaps(prog: dict, ref: dict, on_prefix: float) -> dict:
    """``prog`` and ``ref`` hold the same keys: ``start`` (t_rad, w,
    t_inner), n_e, tau, prefix, chain_cdf, emit_cdf, out, last, est_j,
    est_nubar, emitted, reabsorbed, t_rad, w, t_inner; ``on_prefix`` the
    share of packets that differ from the reference on the program's
    prefix too."""
    ps, rs = prog["start"], ref["start"]
    return {
        "start_gap": max(rel(ps[0], rs[0]), rel(ps[1], rs[1]),
                         rel(ps[2], rs[2])),
        "plasma_gap": max(rel(prog["n_e"], ref["n_e"]),
                          rel_t(prog["tau"], ref["tau"], TAU_FLOOR),
                          rel_t(prog["prefix"], ref["prefix"], TAU_FLOOR)),
        "chain_gap": max(abs_t(prog["chain_cdf"], ref["chain_cdf"]),
                         abs_t(prog["emit_cdf"], ref["emit_cdf"])),
        "packets_differ": len(differing(prog["out"], prog["last"],
                                        ref["out"], ref["last"]))
        / ref["out"].shape[0],
        "packets_differ_on_prefix": on_prefix,
        "estimator_gap": max(rel(prog["est_j"], ref["est_j"]),
                             rel(prog["est_nubar"], ref["est_nubar"])),
        "luminosity_gap": max(rel(prog["emitted"], ref["emitted"]),
                              rel(prog["reabsorbed"], ref["reabsorbed"])),
        "field_gap": max(rel(prog["t_rad"], ref["t_rad"]),
                         rel(prog["w"], ref["w"]),
                         rel(prog["t_inner"], ref["t_inner"])),
    }


def judge(numbers: dict, limits: dict, names=NAMES) -> bool:
    """Every number finite and at or under its limit (a missing limit
    fails)."""
    ok = True
    for name in names:
        v, lim = numbers.get(name), limits.get(name)
        ok &= (v is not None and lim is not None and np.isfinite(v)
               and v <= lim)
    return bool(ok)
