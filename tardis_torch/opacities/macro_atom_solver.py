"""Absorbing-chain macro-atom sampling tables, built with PyTorch ops.

Counterpart of ``tardis_tpu/opacities/macro_atom_solver.py``
(``_ChainContext``, ``_device_p_norm``, ``_device_chain_tables``,
``solve_macro_chain``).  The distribution of the deactivating level j given
activation at level l is  B = (I - Q)^-1 diag(d), with Q the internal
transition probabilities and d the per-level deactivation probabilities;
the emitted line given deactivation at j follows block j's emission
probabilities.  The transport loop draws from two row tables:

- ``chain_cdf`` (S*M, W+1) f32: [CDF over the component's W local slots |
  base level id of the component];
- ``emit_cdf`` (S*M, 3*We) f32: [CDF over the level's emission block |
  line ids | line frequencies in NU_UNIT].

The structure (``_ChainContext``) depends only on the transition table's
sparsity and is built once in numpy.  The per-iteration numbers are built
on the device in f64 (segment sums by ``index_add_``, one batched
``torch.linalg.solve`` per component-size bucket) and rounded to f32 for
the kernel.  These are table builds off the transport hot loop; they stay
PyTorch ops in this slice.

``solve_transition_probabilities`` is the host f64 copy of the JAX
package's, which the formal integral's source function reads.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tardis_torch.atomic.atom_data import MACRO_INTERNAL_UP, MacroAtomData

F64 = torch.float64


@dataclass
class MacroChainState:
    """Kernel-ready absorbing-chain tables on one device."""

    n_states: int  # M
    chain_width: int  # W (0 for downbranch)
    emit_width: int  # We (longest emission block)
    chain_cdf: torch.Tensor | None  # (S*M, W+1) f32 (None: downbranch)
    emit_cdf: torch.Tensor  # (S*M, 3*We) f32
    line2macro: np.ndarray  # (L,) i32 activation map


class _ChainContext:
    """Static per-(macro table, mode) structure of the chain build (numpy).

    A copy of the JAX package's context: emission-block layout, merged
    contiguous connected components of the internal-transition graph, and
    the power-of-two size buckets of the batched solves.
    """

    def __init__(self, macro: MacroAtomData, mode: str, line_nu_scaled):
        refs = macro.block_references.astype(np.int64)
        M = len(refs) - 1
        self.M = M
        ttype = macro.transition_type
        src = np.repeat(np.arange(M), np.diff(refs))
        emit_mask = ttype < 0

        arrays = {
            "coef": np.asarray(macro.coef, np.float64),
            "line_idx": np.asarray(macro.transition_line_id, np.int64),
            "up": np.asarray(ttype == MACRO_INTERNAL_UP),
            "block_of": np.asarray(src, np.int64),
        }

        e_idx = np.nonzero(emit_mask)[0]
        e_src = src[e_idx]
        e_line = macro.transition_line_id[e_idx].astype(np.int64)
        e_start = np.searchsorted(e_src, np.arange(M + 1)).astype(np.int64)
        elen = np.diff(e_start)
        We = int(max(int(elen.max()) if len(elen) else 1, 1))
        self.We = We
        slot = np.arange(len(e_src)) - e_start[e_src]
        line_dense = np.zeros((M, We), np.float32)
        line_dense[e_src, slot] = e_line.astype(np.float32)
        # empty emission blocks carry "line 0 at line 0's frequency", as in
        # the JAX package (a 0.0 frequency would emit a dead packet)
        line_nu_scaled = np.asarray(line_nu_scaled, np.float32).ravel()
        nu_fill = line_nu_scaled[0] if len(line_nu_scaled) else 0.0
        nu_dense = np.full((M, We), nu_fill, np.float32)
        nu_dense[e_src, slot] = line_nu_scaled[e_line]
        arrays.update(
            emit_idx=np.asarray(e_idx, np.int64),
            e_src=np.asarray(e_src, np.int64),
            e_slot=np.asarray(e_src * We + slot, np.int64),
            line_dense=line_dense,
            nu_dense=nu_dense,
        )

        self.bucket_meta = []
        if mode == "downbranch":
            self.W = 0
        else:
            from scipy.sparse import coo_matrix
            from scipy.sparse.csgraph import connected_components

            i_idx = np.nonzero(~emit_mask)[0]
            i_src = src[i_idx]
            i_dest = macro.destination_level_id[i_idx].astype(np.int64)
            g = coo_matrix(
                (np.ones(len(i_src)), (i_src, i_dest)), shape=(M, M)
            )
            n_comp, comp = connected_components(
                g, directed=True, connection="weak"
            )
            clo = np.full(n_comp, M, np.int64)
            chi = np.full(n_comp, -1, np.int64)
            np.minimum.at(clo, comp, np.arange(M))
            np.maximum.at(chi, comp, np.arange(M))
            # merge overlapping level-id ranges so every component is a
            # contiguous [base, base + size) interval
            ranges = []
            for c in np.argsort(clo):
                if ranges and clo[c] <= ranges[-1][1]:
                    ranges[-1][1] = max(ranges[-1][1], chi[c])
                else:
                    ranges.append([clo[c], chi[c]])
            r_lo = np.array([r[0] for r in ranges], np.int64)
            r_hi = np.array([r[1] for r in ranges], np.int64)
            sizes = r_hi - r_lo + 1
            self.W = int(sizes.max())

            base = np.zeros(M, np.int64)
            for a, b in ranges:
                base[a : b + 1] = a
            arrays.update(
                base=base.astype(np.float32),
                local=(np.arange(M) - base).astype(np.int64),
            )

            comp_of_level = (
                np.searchsorted(r_lo, np.arange(M), side="right") - 1
            )
            edge_comp = comp_of_level[i_src]
            pad_of = np.maximum(
                2 ** np.ceil(np.log2(np.maximum(sizes, 1))).astype(np.int64),
                8,
            )
            for bi, Wp in enumerate(np.unique(pad_of)):
                comp_ids = np.nonzero(pad_of == Wp)[0]
                pos_of = np.full(len(ranges), -1, np.int64)
                pos_of[comp_ids] = np.arange(len(comp_ids))
                esel = np.nonzero(pos_of[edge_comp] >= 0)[0]
                seg = (
                    pos_of[edge_comp[esel]] * Wp
                    + (i_src[esel] - base[i_src[esel]])
                ) * Wp + (i_dest[esel] - base[i_dest[esel]])
                n_cb = len(comp_ids)
                levels = np.concatenate(
                    [np.arange(r_lo[c], r_hi[c] + 1) for c in comp_ids]
                )
                lvl_pos = np.concatenate(
                    [np.full(int(sizes[c]), pos)
                     for pos, c in enumerate(comp_ids)]
                )
                member_flat = np.zeros(n_cb * Wp, np.int64)
                member_valid = np.zeros(n_cb * Wp, bool)
                for pos, c in enumerate(comp_ids):
                    sz = int(sizes[c])
                    member_flat[pos * Wp : pos * Wp + sz] = np.arange(
                        r_lo[c], r_hi[c] + 1
                    )
                    member_valid[pos * Wp : pos * Wp + sz] = True
                self.bucket_meta.append(dict(Wp=int(Wp), n_cb=n_cb))
                arrays[f"b{bi}_i_idx"] = np.asarray(i_idx[esel], np.int64)
                arrays[f"b{bi}_seg"] = np.asarray(seg, np.int64)
                arrays[f"b{bi}_member_flat"] = member_flat
                arrays[f"b{bi}_member_valid"] = member_valid
                arrays[f"b{bi}_levels"] = np.asarray(levels, np.int64)
                arrays[f"b{bi}_lvl_pos"] = np.asarray(lvl_pos, np.int64)
                arrays[f"b{bi}_lvl_local"] = np.asarray(
                    levels - base[levels], np.int64
                )
        self.arrays_np = arrays
        self._on_device: dict = {}

    def arrays(self, device) -> dict:
        """The structure arrays as tensors on ``device`` (uploaded once)."""
        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = {
                k: torch.as_tensor(v, device=device)
                for k, v in self.arrays_np.items()
            }
        return self._on_device[key]

    def table_bytes(self, n_shells: int) -> float:
        """Device bytes of the chain tables plus the largest batched solve."""
        solve = max(
            (n_shells * b["n_cb"] * b["Wp"] * b["Wp"] * 8.0 * 3
             for b in self.bucket_meta),
            default=0.0,
        )
        return (n_shells * self.M * (self.W + 1) * 4.0
                + n_shells * self.M * 3 * self.We * 4.0 + solve)


def chain_context(macro: MacroAtomData, mode: str,
                  line_nu_scaled) -> _ChainContext:
    """The cached structure for ``macro`` in ``mode``."""
    key = "_torch_chain_ctx_" + mode
    ctx = macro.__dict__.get(key)
    if ctx is None:
        ctx = _ChainContext(macro, mode, line_nu_scaled)
        macro.__dict__[key] = ctx
    return ctx


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg, x)


def p_norm(ctx: _ChainContext, arrays: dict, beta, j_blues, stim):
    """Block-normalized transition probabilities (T, S) f64."""
    li = arrays["line_idx"]
    p = arrays["coef"][:, None] * beta[li]
    p = torch.where(arrays["up"][:, None], p * (stim[li] * j_blues[li]), p)
    bsum = _segment_sum(p, arrays["block_of"], ctx.M)
    denom = bsum[arrays["block_of"]]
    return torch.where(denom > 0, p / torch.where(denom > 0, denom, 1.0),
                       0.0)


def chain_tables(ctx: _ChainContext, arrays: dict, pn: torch.Tensor):
    """(chain_cdf, emit_cdf) f32 row tables from p_norm (T, S)."""
    S = pn.shape[1]
    M, We = ctx.M, ctx.We
    e_p = pn[arrays["emit_idx"]]  # (E0, S)

    dense = _segment_sum(e_p, arrays["e_slot"], M * We)
    dense = dense.reshape(M, We, S).permute(2, 0, 1)  # (S, M, We)
    cum = torch.cumsum(dense, dim=2)
    tot = cum[:, :, -1:]
    ecdf = torch.where(tot > 0, cum / torch.where(tot > 0, tot, 1.0), 1.0)
    emit_cdf = torch.cat(
        [
            ecdf.float(),
            arrays["line_dense"][None].expand(S, M, We),
            arrays["nu_dense"][None].expand(S, M, We),
        ],
        dim=2,
    ).reshape(S * M, 3 * We)

    if ctx.W == 0:  # downbranch: no absorbing chain
        return None, emit_cdf

    deact = _segment_sum(e_p, arrays["e_src"], M)  # (M, S)
    W = ctx.W
    rows = torch.zeros((S, M, W), dtype=F64, device=pn.device)
    for bi, meta in enumerate(ctx.bucket_meta):
        Wp, n_cb = meta["Wp"], meta["n_cb"]
        p_int = pn[arrays[f"b{bi}_i_idx"]]  # (Tb, S)
        Q = _segment_sum(p_int, arrays[f"b{bi}_seg"], n_cb * Wp * Wp)
        Q = (Q.reshape(n_cb, Wp, Wp, S).permute(3, 0, 1, 2)
             .reshape(S * n_cb, Wp, Wp))
        eye = torch.eye(Wp, dtype=F64, device=pn.device)
        d = deact[arrays[f"b{bi}_member_flat"]]  # (n_cb*Wp, S)
        d = torch.where(arrays[f"b{bi}_member_valid"][:, None], d, 0.0)
        d = d.reshape(n_cb, Wp, S).permute(2, 0, 1).reshape(S * n_cb, Wp)
        B = torch.linalg.solve(eye[None] - Q, torch.diag_embed(d))
        Bl = B.reshape(S, n_cb, Wp, Wp)[
            :, arrays[f"b{bi}_lvl_pos"], arrays[f"b{bi}_lvl_local"], :
        ]  # (S, n_levels_in_bucket, Wp)
        wc = min(Wp, W)  # pow2 padding beyond W is zero-mass
        rows[:, arrays[f"b{bi}_levels"], :wc] = Bl[:, :, :wc]

    rows = torch.clamp(rows, min=0.0)
    rcum = torch.cumsum(rows, dim=2)
    rtot = rcum[:, :, -1:]
    # rows with no reachable deactivation: self-deactivation step CDF
    fallback = (
        torch.arange(W, device=pn.device)[None, None, :]
        >= arrays["local"][None, :, None]
    ).to(F64)
    ccdf = torch.where(rtot > 0, rcum / torch.where(rtot > 0, rtot, 1.0),
                       fallback)
    chain_cdf = torch.cat(
        [ccdf.float(), arrays["base"][None, :, None].expand(S, M, 1)],
        dim=2,
    ).reshape(S * M, W + 1)
    return chain_cdf, emit_cdf


def solve_transition_probabilities(
    macro: MacroAtomData,
    beta_sobolev: np.ndarray,  # (L, S)
    j_blues: np.ndarray,  # (L, S)
    stim_factor: np.ndarray,  # (L, S)
) -> np.ndarray:
    """Block-normalized transition probabilities (T, S), host f64."""
    line_idx = macro.transition_line_id
    p = macro.coef[:, None] * beta_sobolev[line_idx]  # (T, S)
    up = macro.transition_type == MACRO_INTERNAL_UP
    p[up] *= stim_factor[line_idx[up]] * j_blues[line_idx[up]]

    refs = macro.block_references
    block_of = np.repeat(np.arange(len(refs) - 1), np.diff(refs))
    T, S = p.shape
    excl = np.zeros((T + 1, S))
    np.cumsum(p, axis=0, out=excl[1:])
    denom = (excl[refs[1:]] - excl[refs[:-1]])[block_of]
    with np.errstate(divide="ignore", invalid="ignore"):
        p_norm = p / denom
    return np.where(np.isfinite(p_norm), p_norm, 0.0)


def solve_macro_chain(
    macro: MacroAtomData,
    beta_sobolev: torch.Tensor,  # (L, S) f64
    j_blues: torch.Tensor,
    stim_factor: torch.Tensor,
    mode: str,
    line_nu_scaled,
    max_chain_bytes: float = 6e9,
) -> MacroChainState:
    """Build the chain tables on the device of ``beta_sobolev``.

    Raises ``NotImplementedError`` when they would not fit
    ``max_chain_bytes`` (the JAX package then falls back to an in-kernel
    random walk, which is not ported).
    """
    ctx = chain_context(macro, mode, line_nu_scaled)
    S = beta_sobolev.shape[1]
    if mode != "downbranch" and ctx.table_bytes(S) > max_chain_bytes:
        raise NotImplementedError(
            "macro-atom chain tables that do not fit device memory (the "
            "random-walk fallback) are not ported"
        )
    arrays = ctx.arrays(beta_sobolev.device)
    pn = p_norm(ctx, arrays, beta_sobolev.to(F64), j_blues.to(F64),
                stim_factor.to(F64))
    chain_cdf, emit_cdf = chain_tables(ctx, arrays, pn)
    return MacroChainState(
        n_states=ctx.M,
        chain_width=ctx.W,
        emit_width=ctx.We,
        chain_cdf=chain_cdf,
        emit_cdf=emit_cdf,
        line2macro=macro.line2macro_level_upper.astype(np.int32),
    )
