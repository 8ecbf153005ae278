"""The RNG-walk macro atom that both event loops run (plain version).

Counterpart of ``tardis_tpu/transport/kernel.py:281`` ``_macro_walk`` with
``_uniform_from_key`` (``:229``) and ``_bsearch_first_true`` (``:240``).
The walk starts at the level that the absorbed line activates
(``line2macro``); each jump j draws one scalar uniform from the legacy
per-tag key ``fold_in(fold_in(fold_in(key, packet_id), event_idx),
WALK_TAG + j)`` and takes the first transition of the level's block whose
cumulative probability (``solve_macro_state``, f32, per shell) reaches it,
by a bisection clipped into ``[b0, b1 - 1]``.  An emission ends the walk
with its line; any other transition moves the walk to its destination
level.  A walk that has not emitted after its last jump re-emits the
absorbed line.  ``macroatom`` walks up to MAX_MACRO_JUMPS jumps and
``downbranch`` one: the JAX package's CPU values, its reference (it takes
24 on an accelerator).

The nonhomologous loop (K7, ``nonhomologous.py``) always walks; the
classic loop (K1, ``kernel.py``) walks where the absorbing-chain tables do
not fit the device budget or the solver is told to.  On the card both
kernels take ``tardis::macro_walk`` of ``csrc/macro_walk.cuh``.
"""

from __future__ import annotations

import numpy as np
import torch

from tardis_torch.opacities.macro_atom_solver import MacroWalkTables
from tardis_torch.transport import rng

# jumps of one macro-atom walk; the JAX package takes 40 on the CPU and 24
# on an accelerator, the port 40 on both devices
MAX_MACRO_JUMPS = 40
# the walk's draw of jump j is keyed by fold_in(event key, WALK_TAG + j)
WALK_TAG = 8
U_MIN = 1e-9


def walk_steps(block_start) -> int:
    """Bisection steps that settle a search of the widest transition
    block."""
    widest = int(np.max(np.diff(np.asarray(block_start))))
    return int(np.ceil(np.log2(max(2, widest)))) + 1


def max_jumps(mode_is_downbranch: bool) -> int:
    """Jumps of one walk: one in downbranch mode, MAX_MACRO_JUMPS else."""
    return 1 if mode_is_downbranch else MAX_MACRO_JUMPS


def lower_bound(values, idx_of, lo, hi, u, steps):
    """First t in [lo, hi) with values[idx_of(t)] >= u (hi if none), by
    ``steps`` bisection steps over lanes; values are non-decreasing on
    [lo, hi)."""
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        below = values[idx_of(torch.minimum(mid, hi - 1).clamp(min=0))] < u
        lo = torch.where(active & below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
    return lo


def macro_walk(w: MacroWalkTables, jumps: int, steps: int, shell, i_ev, ke0,
               ke1, tally: dict | None = None):
    """The walk of each lane from the level its line ``i_ev`` activates,
    in shell ``shell``, under the event keys (``ke0``, ``ke1``); returns
    the emitted line (the absorbed one if no jump emits).  With ``tally``
    (a dict), adds the lanes' walks, jumps and walks that reached the
    last jump without emitting ("walks", "jumps", "capped") and keeps the
    most jumps of one walk ("max_jumps")."""
    S = w.cum_prob.shape[1]
    cum = w.cum_prob.reshape(-1)
    level = w.line2macro[i_ev].long()
    em = i_ev.clone()
    done = torch.zeros_like(i_ev, dtype=torch.bool)
    taken = torch.zeros_like(i_ev)  # jumps each walk took
    # every jump's draw in one hash (the bits are counter-based, so they
    # are the draws the kernels make one jump at a time)
    tags = WALK_TAG + torch.arange(jumps, device=i_ev.device)
    u_all = rng.uniform(rng.scalar_bits(rng.fold_in(
        (ke0[:, None], ke1[:, None]), tags[None, :])), U_MIN, 1.0)
    for jump in range(jumps):
        if bool(done.all()):
            break
        u = u_all[:, jump]
        b0 = w.block_start[level].long()
        b1 = w.block_start[level + 1].long()
        tr = lower_bound(cum, lambda i: i * S + shell, b0, b1, u, steps)
        tr = torch.minimum(torch.maximum(tr, b0), torch.maximum(b1 - 1, b0))
        emit = w.emit[tr] & ~done
        em = torch.where(emit, w.line[tr].long(), em)
        level = torch.where(~done & ~w.emit[tr], w.dest[tr].long(), level)
        if tally is not None:
            taken = torch.where(~done, jump + 1, taken)
        done = done | emit
    if tally is not None and i_ev.numel():
        for name, v in (("walks", i_ev.numel()), ("jumps", taken.sum()),
                        ("capped", (~done).sum())):
            tally[name] = tally.get(name, 0) + int(v)
        tally["max_jumps"] = max(tally.get("max_jumps", 0),
                                 int(taken.max()))
    return em
