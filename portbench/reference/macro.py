"""The macro atom's absorbing-chain tables.

A packet absorbed in a line activates its upper level i.  The macro atom
jumps between levels with the normalized internal probabilities Q and
deactivates from level j with probability d_j (the sum of j's emission
probabilities), so the chance that activation at i ends in emission from
j is B = (I - Q)^-1 diag(d), solved here for each shell and each
connected group of levels, which the transitions keep inside one
contiguous range of level ids.  Per level two f32 CDF rows are kept:

- ``chain_cdf`` (S * M, W + 1): row i's cumulative B over the W slots of
  its group (zero past the group's end), then the group's first level;
  a row with no mass, or of a singular system, is the step at i's own
  slot (i deactivates itself);
- ``emit_cdf`` (S * M, 3 We): level j's cumulative emission probabilities
  over its emission lines in line order (1 past the last), then the
  lines' ids and their frequencies / NU_UNIT (line 0's past the last).
"""

from dataclasses import dataclass

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from portbench.reference.atoms import EMISSION, INTERNAL_UP, Atoms
from portbench.reference.constants import NU_UNIT


@dataclass
class ChainLayout:
    """What the tables' shape takes from the transitions alone."""

    groups: list  # (first level, size) of each group
    W: int  # widest group
    We: int  # most emission lines of one level
    emit_slot: np.ndarray  # (E0,) flat slot level * We + k of each emission
    emit_index: np.ndarray  # (E0,) transition index of each emission
    bandwidth: int  # largest |source - destination| of an internal jump


def layout(atoms: Atoms) -> ChainLayout:
    M = atoms.n_macro
    internal = atoms.m_type != EMISSION
    src, dst = atoms.m_src[internal], atoms.m_dest[internal]
    graph = coo_matrix((np.ones(len(src)), (src, dst)), shape=(M, M))
    n, comp = connected_components(graph, directed=True, connection="weak")
    lo = np.full(n, M)
    hi = np.full(n, -1)
    np.minimum.at(lo, comp, np.arange(M))
    np.maximum.at(hi, comp, np.arange(M))
    groups = []
    for c in np.argsort(lo):
        if groups and lo[c] <= groups[-1][1]:
            groups[-1][1] = max(groups[-1][1], hi[c])
        else:
            groups.append([int(lo[c]), int(hi[c])])
    groups = [(a, b - a + 1) for a, b in groups]
    e_idx = np.nonzero(~internal)[0]
    e_src = atoms.m_src[e_idx]
    starts = np.searchsorted(e_src, np.arange(M + 1))
    We = max(int(np.diff(starts).max()), 1)
    slot = np.arange(len(e_idx)) - starts[e_src]
    return ChainLayout(groups=groups, W=max(s for _, s in groups), We=We,
                       emit_slot=e_src * We + slot, emit_index=e_idx,
                       bandwidth=int(np.abs(src - dst).max()))


def chain_tables(atoms: Atoms, lay: ChainLayout, beta, j_blues, stim,
                 dtype=torch.float64):
    """(chain_cdf, emit_cdf) f32 on the device of ``beta`` (L, S), the
    probabilities and the solves in ``dtype``."""
    device = beta.device
    S = beta.shape[1]
    M, W, We = atoms.n_macro, lay.W, lay.We
    line = torch.as_tensor(atoms.m_line, device=device)
    up = torch.as_tensor(atoms.m_type == INTERNAL_UP, device=device)
    src = torch.as_tensor(atoms.m_src, device=device)
    p = torch.as_tensor(atoms.m_coef, dtype=dtype, device=device)[:, None] \
        * beta.to(dtype)[line]
    p = torch.where(up[:, None],
                    p * (stim.to(dtype)[line] * j_blues.to(dtype)[line]), p)
    total = torch.zeros((M, S), dtype=dtype, device=device).index_add_(
        0, src, p)[src]
    p = torch.where(total > 0, p / torch.where(total > 0, total, 1.0), 0.0)

    e_idx = torch.as_tensor(lay.emit_index, device=device)
    dense = torch.zeros((M * We, S), dtype=dtype, device=device).index_add_(
        0, torch.as_tensor(lay.emit_slot, device=device), p[e_idx])
    dense = dense.reshape(M, We, S).permute(2, 0, 1)
    cum = torch.cumsum(dense, dim=2)
    tot = cum[:, :, -1:]
    ecdf = torch.where(tot > 0, cum / torch.where(tot > 0, tot, 1.0), 1.0)
    e_lines = np.zeros((M, We), np.float32)
    nu_s = (atoms.line_nu / NU_UNIT).astype(np.float32)
    e_nu = np.full((M, We), nu_s[0], np.float32)
    flat_src = lay.emit_slot // We
    flat_k = lay.emit_slot % We
    e_line_ids = atoms.m_line[lay.emit_index]
    e_lines[flat_src, flat_k] = e_line_ids.astype(np.float32)
    e_nu[flat_src, flat_k] = nu_s[e_line_ids]
    emit_cdf = torch.cat([
        ecdf.float(),
        torch.as_tensor(e_lines, device=device)[None].expand(S, M, We),
        torch.as_tensor(e_nu, device=device)[None].expand(S, M, We),
    ], dim=2).reshape(S * M, 3 * We)

    deact = torch.zeros((M, S), dtype=dtype, device=device).index_add_(
        0, torch.as_tensor(atoms.m_src[lay.emit_index], device=device),
        p[e_idx])
    internal = np.nonzero(atoms.m_type != EMISSION)[0]
    i_src, i_dst = atoms.m_src[internal], atoms.m_dest[internal]
    p_int = p[torch.as_tensor(internal, device=device)]
    rows = torch.zeros((S, M, W), dtype=dtype, device=device)
    base = np.zeros(M, np.int64)
    for first, size in lay.groups:
        base[first:first + size] = first
        sel = np.nonzero((i_src >= first) & (i_src < first + size))[0]
        q = torch.zeros((S, size, size), dtype=dtype, device=device)
        q.index_put_(
            (torch.arange(S, device=device)[:, None],
             torch.as_tensor(i_src[sel] - first, device=device)[None],
             torch.as_tensor(i_dst[sel] - first, device=device)[None]),
            p_int[torch.as_tensor(sel, device=device)].T, accumulate=True)
        a = torch.eye(size, dtype=dtype, device=device)[None] - q
        d = deact[first:first + size].T  # (S, size)
        b = torch.linalg.solve_ex(a, torch.diag_embed(d))[0]
        rows[:, first:first + size, :size] = b
    finite = torch.isfinite(rows).all(dim=2, keepdim=True)
    rows = torch.clamp(rows, min=0.0)
    rcum = torch.cumsum(rows, dim=2)
    rtot = rcum[:, :, -1:]
    local = torch.as_tensor(np.arange(M) - base, device=device)
    step = (torch.arange(W, device=device)[None, None, :]
            >= local[None, :, None]).to(dtype)
    ccdf = torch.where((rtot > 0) & finite,
                       rcum / torch.where(rtot > 0, rtot, 1.0), step)
    chain_cdf = torch.cat([
        ccdf.float(),
        torch.as_tensor(base.astype(np.float32), device=device)[
            None, :, None].expand(S, M, 1),
    ], dim=2).reshape(S * M, W + 1)
    return chain_cdf, emit_cdf
