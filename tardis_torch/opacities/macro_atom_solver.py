"""Absorbing-chain macro-atom sampling tables (kernel K8,
``csrc/macro_chain.cu``).

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
on the device in f64 and rounded to f32 for the transport kernels:
``macro_chain`` launches K8 for tensors on the card (each (component,
shell) system's block sums, emission rows and in-place Gauss-Jordan
inverse without pivoting, in transition order, no atomics; one launch a
build of the cluster instantiation for the components a thread-block
cluster holds and one of the large-system instantiation for the larger
ones) and runs the plain version ``p_norm`` + ``chain_tables`` (segment
sums by ``index_add_``, ``torch.linalg.solve_ex`` per component-size
bucket, on the CPU one system a call) only for CPU tensors.  A singular
system (a closed internal cycle with no emission) gives non-finite rows
in both, which take the self-deactivation fallback, as the JAX package's
NaN rows do.

``solve_transition_probabilities`` is the host f64 copy of the JAX
package's, which the formal integral's source function reads.
``solve_macro_state`` builds the per-block cumulative probabilities that
the RNG walk of the event loops reads: K7's always (the JAX package's
nonhomologous mode never takes the chain tables), and K1's where the
chain tables do not fit the device budget (``chain_tables_fit``;
``solve_macro_chain`` then returns None) or the solver is told to walk.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from tardis_torch import cuda, tracing
from tardis_torch.atomic.atom_data import MACRO_INTERNAL_UP, MacroAtomData

F64 = torch.float64
# K8's downbranch launch (csrc/macro_chain.cu BLOCK): threads a block, and
# blocks a multiprocessor
K8_BLOCK = 256
K8_STAGE = 64  # f64 of shared staging a warp, for its level rows
K8_DOWN_TILE = 64  # f64 of a downbranch block's shared memory before it
K8_BLOCKS_PER_SM = 2
# the cluster instantiation: cluster sizes, smallest first (8 is the
# portable limit), its panel width, and the dynamic shared memory a block
# may take: 232,448 bytes less a kilobyte for the kernel's static shared
# memory
K8_CLUSTERS = (2, 4, 8)
K8_CLUSTER_PANEL = 16
K8_CLUSTER_SMEM = 232_448 - 1024
K8_CLUSTER_BLOCK = 512  # threads a block (csrc/macro_chain.cu CBLOCK)
# the large-system instantiation (past a cluster's reach): the columns of
# the panel rows a block holds at once (csrc/macro_chain.cu CHUNK), and the
# bytes of the systems in flight's matrix rows outside shared memory, which
# the card's 50 MB L2 cache should hold
K8_LARGE_CHUNK = 1024
K8_LARGE_L2 = 40e6


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

        # K8's transition table in 32-bit integers
        arrays.update(
            k8_refs=refs.astype(np.int32),
            k8_line=np.asarray(macro.transition_line_id, np.int32),
            k8_type=np.asarray(ttype, np.int8),
            k8_dest=np.asarray(macro.destination_level_id, np.int32),
        )
        self.n_lines_read = (int(macro.transition_line_id.max()) + 1
                             if len(ttype) else 0)

        self.bucket_meta = []
        if mode == "downbranch":
            self.W = 0
            # K8's work groups: runs of K8_BLOCK levels (emission rows only)
            g_base = np.arange(0, M, K8_BLOCK, dtype=np.int64)
            g_size = np.minimum(K8_BLOCK, M - g_base)
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
            # K8's work groups: the components
            g_base, g_size = r_lo, sizes
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
        # largest first, so a persistent grid's last round holds the
        # small ones; each group's transitions are one contiguous range
        order = np.argsort(-g_size, kind="stable")
        g_base, g_size = g_base[order], g_size[order]
        g_t0, g_t1 = refs[g_base], refs[g_base + g_size]
        arrays.update(
            k8_base=g_base.astype(np.int32), k8_size=g_size.astype(np.int32),
            k8_t0=g_t0.astype(np.int32), k8_t1=g_t1.astype(np.int32),
        )
        self.k8_groups = len(g_base)
        self.k8_n_max = int(g_size.max()) if self.W and len(g_size) else 0
        self.k8_t_max = int((g_t1 - g_t0).max()) if len(g_base) else 0
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
        """Device bytes of the chain tables plus the largest batched solve,
        counted as the JAX package counts them (``chain_tables_fit``: 4 B
        an entry of the solve's three (Wp, Wp) matrices, whose f32 solve
        it runs).  The port solves in f64, so its solve takes up to twice
        that term: within 12e9 bytes under the 6e9 default budget, which
        an 80 GB card holds; counting it so keeps the two packages'
        choice of sampler the same."""
        solve = max(
            (n_shells * b["n_cb"] * b["Wp"] * b["Wp"] * 4.0 * 3
             for b in self.bucket_meta),
            default=0.0,
        )
        return (n_shells * self.M * (self.W + 1) * 4.0
                + n_shells * self.M * 3 * self.We * 4.0 + solve)

    def plain_bytes(self, n_shells: int) -> float:
        """Device bytes of the plain version's largest f64 intermediate:
        the three (Wp, Wp) matrices of a bucket's batched solve (A, the
        right-hand side, B), or in downbranch mode the (T, S) p_norm."""
        if self.W == 0:
            return 8.0 * len(self.arrays_np["coef"]) * n_shells
        return max((n_shells * b["n_cb"] * b["Wp"] * b["Wp"] * 8.0 * 3
                    for b in self.bucket_meta), default=0.0)


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


def deactivation(ctx: _ChainContext, arrays: dict, pn: torch.Tensor):
    """Each level's deactivation probability d (M, S): the sum of its
    emission p_norm."""
    return _segment_sum(pn[arrays["emit_idx"]], arrays["e_src"], ctx.M)


def bucket_systems(ctx: _ChainContext, arrays: dict, pn: torch.Tensor,
                   deact: torch.Tensor, bi: int):
    """Size bucket ``bi``'s (shell, component) systems as the plain
    version solves them: A = I - Q (S*n_cb, Wp, Wp), each component padded
    to Wp with identity rows, and d (S*n_cb, Wp), zero in the padding."""
    S = pn.shape[1]
    Wp, n_cb = ctx.bucket_meta[bi]["Wp"], ctx.bucket_meta[bi]["n_cb"]
    p_int = pn[arrays[f"b{bi}_i_idx"]]  # (Tb, S)
    Q = _segment_sum(p_int, arrays[f"b{bi}_seg"], n_cb * Wp * Wp)
    Q = (Q.reshape(n_cb, Wp, Wp, S).permute(3, 0, 1, 2)
         .reshape(S * n_cb, Wp, Wp))
    eye = torch.eye(Wp, dtype=F64, device=pn.device)
    d = deact[arrays[f"b{bi}_member_flat"]]  # (n_cb*Wp, S)
    d = torch.where(arrays[f"b{bi}_member_valid"][:, None], d, 0.0)
    d = d.reshape(n_cb, Wp, S).permute(2, 0, 1).reshape(S * n_cb, Wp)
    return eye[None] - Q, d


def _solve(A: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """torch.linalg.solve_ex of a batch; on the CPU one system a call:
    oneMKL 2024.2's batched f64 LU (PyTorch 2.13's CPU build) stops with
    "Parameter 6 was incorrect on entry to DLASWP" and never returns for
    two or more systems of 200 levels or more with more than one
    thread."""
    if A.device.type != "cpu":
        return torch.linalg.solve_ex(A, rhs)[0]
    return torch.cat([torch.linalg.solve_ex(A[i:i + 1], rhs[i:i + 1])[0]
                      for i in range(A.shape[0])]) if A.shape[0] else rhs


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

    deact = deactivation(ctx, arrays, pn)
    W = ctx.W
    rows = torch.zeros((S, M, W), dtype=F64, device=pn.device)
    for bi, meta in enumerate(ctx.bucket_meta):
        Wp, n_cb = meta["Wp"], meta["n_cb"]
        A, d = bucket_systems(ctx, arrays, pn, deact, bi)
        # no host check: a singular system's rows come out non-finite
        B = _solve(A, torch.diag_embed(d))
        Bl = B.reshape(S, n_cb, Wp, Wp)[
            :, arrays[f"b{bi}_lvl_pos"], arrays[f"b{bi}_lvl_local"], :
        ]  # (S, n_levels_in_bucket, Wp)
        wc = min(Wp, W)  # pow2 padding beyond W is zero-mass
        rows[:, arrays[f"b{bi}_levels"], :wc] = Bl[:, :, :wc]

    finite = torch.isfinite(rows).all(dim=2, keepdim=True)
    rows = torch.clamp(rows, min=0.0)
    rcum = torch.cumsum(rows, dim=2)
    rtot = rcum[:, :, -1:]
    # rows with no reachable deactivation, and the non-finite rows of a
    # singular system: self-deactivation step CDF
    fallback = (
        torch.arange(W, device=pn.device)[None, None, :]
        >= arrays["local"][None, :, None]
    ).to(F64)
    ccdf = torch.where((rtot > 0) & finite,
                       rcum / torch.where(rtot > 0, rtot, 1.0), fallback)
    chain_cdf = torch.cat(
        [ccdf.float(), arrays["base"][None, :, None].expand(S, M, 1)],
        dim=2,
    ).reshape(S * M, W + 1)
    return chain_cdf, emit_cdf


def k8_workspace(ctx: _ChainContext, n_shells: int, sms: int):
    """(f64 entries a slot, slots) of K8's downbranch workspace on a card
    of ``sms`` multiprocessors: a slot holds a work group's block sums
    (K8_BLOCK) and its transitions' p, rounded up to 256 bytes; one slot a
    block of the persistent grid, K8_BLOCKS_PER_SM blocks a
    multiprocessor, no more than the work groups' systems, and no more
    than the plain version's largest f64 intermediate holds
    (``plain_bytes``), but at least one."""
    stride = -(-(K8_BLOCK + ctx.k8_t_max) // 32) * 32
    cap = int(ctx.plain_bytes(n_shells) // (8 * stride))
    slots = min(ctx.k8_groups * n_shells, K8_BLOCKS_PER_SM * sms, cap)
    return stride, max(1, slots)


def _round_up(x, m):
    return -(-x // m) * m


def _ldr(n):
    n8 = _round_up(n, 8)
    return n8 if n8 % 16 == 8 else n8 + 8


def k8_cluster_smem(n: int, cluster: int, panel: int) -> int:
    """Dynamic shared bytes a block of K8's cluster instantiation takes for
    components of up to ``n`` levels (``csrc/macro_chain.cu``
    ``cluster_smem``): its rows of A (a multiple of 16, each row a
    multiple of 8 plus 4 f64), the panel rows (a multiple of 16 plus 8),
    two ``panel`` x ``panel`` blocks, d and the warps' staging."""
    rows = _round_up(-(-n // cluster), 16)
    return 8 * (rows * (_round_up(n, 8) + 4) + panel * _ldr(n)
                + 2 * panel * panel + _round_up(n, 2)
                + K8_CLUSTER_BLOCK // 32 * K8_STAGE)


def k8_cluster_shape(n_max: int):
    """(cluster, panel) of K8's cluster instantiation for components of up
    to ``n_max`` levels: the smallest cluster of K8_CLUSTERS whose blocks
    hold them with a panel of K8_CLUSTER_PANEL within K8_CLUSTER_SMEM;
    None past the largest (the large-system instantiation's components)."""
    for cluster in K8_CLUSTERS:
        if k8_cluster_smem(n_max, cluster,
                           K8_CLUSTER_PANEL) <= K8_CLUSTER_SMEM:
            return cluster, K8_CLUSTER_PANEL
    return None


def k8_large_smem(n: int, panel: int, rows: int) -> int:
    """Dynamic shared bytes a block of K8's large-system instantiation
    takes for components of up to ``n`` levels with ``rows`` of its rows
    in shared memory (``csrc/macro_chain.cu`` ``large_smem``): the panel
    rows of a chunk of at most K8_LARGE_CHUNK columns (a multiple of 16
    plus 8 apart), two ``panel`` x ``panel`` blocks, the warps' staging,
    and the rows (a multiple of 8 plus 4 f64 each)."""
    chunk = min(_round_up(n, 8), K8_LARGE_CHUNK)
    return 8 * (panel * _ldr(chunk) + 2 * panel * panel
                + K8_CLUSTER_BLOCK // 32 * K8_STAGE
                + rows * (_round_up(n, 8) + 4))


def k8_large_slot(n: int, panel: int, per: int, t_share: int) -> int:
    """f64 of one system's slot of K8's large-system workspace for
    components of up to ``n`` levels (``csrc/macro_chain.cu``, the large
    section): its matrix (n rows, n rounded up to 8 apart), two panels'
    rows, d, and ``per`` blocks' p of up to ``t_share`` transitions each
    (rounded up to 32)."""
    ldg = _round_up(n, 8)
    return ((n + 2 * panel + 1) * ldg
            + per * (_round_up(t_share, 32) or 32))


class K8Plan(NamedTuple):
    """One K8 launch: its instantiation ("macroatom_cluster",
    "macroatom_large" or "downbranch"), blocks a system (a cluster's
    blocks, or the blocks a large system is spread over; 1 for
    downbranch), panel width, dynamic shared bytes a block, f64 of a
    workspace slot (a block's; a system's in flight for the large one),
    blocks of the grid, systems, rounds of the persistent grid and their
    fill (systems over rounds x the systems in flight), the first of the
    work groups it takes (components largest first) and how many, and the
    rows of each block in shared memory (large only)."""

    variant: str
    cluster: int
    panel: int
    smem: int
    slot_stride: int
    blocks: int
    systems: int
    rounds: int
    fill: float
    first_group: int = 0
    n_groups: int = 0
    smem_rows: int = 0


def _shares(ctx: _ChainContext, first: int, count: int, parts: int,
            rows=None):
    """The most transitions that one of ``parts`` consecutive shares of a
    component's levels holds, over the work groups [first, first +
    count): ``rows`` levels a share (a multiple of 16, from the largest;
    the cluster instantiation), else each component's levels over
    ``parts`` rounded up (the large one)."""
    a = ctx.arrays_np
    refs = a["k8_refs"].astype(np.int64)
    base = a["k8_base"][first:first + count].astype(np.int64)
    size = a["k8_size"][first:first + count].astype(np.int64)
    h = rows if rows is not None else -(-size // parts)
    r0 = np.minimum(size, np.arange(parts)[:, None] * h)
    r1 = np.minimum(size, r0 + h)
    return int((refs[base + r1] - refs[base + r0]).max())


def _cluster_plan(ctx, first, count, n_shells, sms, active_clusters, shape):
    systems = count * n_shells
    n = int(ctx.arrays_np["k8_size"][first])
    cluster, panel = shape or k8_cluster_shape(n)
    smem = k8_cluster_smem(n, cluster, panel)
    if smem > K8_CLUSTER_SMEM:
        raise ValueError(f"macro_chain: a cluster of {cluster} with panel "
                         f"{panel} does not hold {n} levels")
    clusters = (active_clusters(n, cluster, panel) if active_clusters
                else sms // cluster)
    if clusters < 1:
        raise RuntimeError(f"macro_chain: no cluster of {cluster} blocks "
                           f"with {smem} shared bytes fits the card")
    clusters = min(clusters, systems)
    size = ctx.arrays_np["k8_size"][first:first + count].astype(np.int64)
    t_max = _shares(ctx, first, count, cluster,
                    _round_up(-(-size // cluster), 16))
    rounds = -(-systems // clusters)
    return K8Plan("macroatom_cluster", cluster, panel, smem,
                  2 * (_round_up(t_max, 32) or 32), clusters * cluster,
                  systems, rounds, systems / (rounds * clusters), first,
                  count)


def _large_plan(ctx, first, count, n_shells, sms):
    systems = count * n_shells
    n = int(ctx.arrays_np["k8_size"][first])
    panel, ldg = K8_CLUSTER_PANEL, _round_up(n, 8)
    room = max(0, (K8_CLUSTER_SMEM - k8_large_smem(n, panel, 0))
               // (8 * (ldg + 4)))
    # the most systems in flight (the fewest rounds) whose blocks hold at
    # least half their rows in shared memory, whose rows outside it
    # K8_LARGE_L2 holds and whose workspace the plain version's largest f64
    # intermediate does; then the fewest in flight for those rounds
    in_flight = 1
    for f in range(min(systems, sms), 1, -1):
        per = sms // f
        h = -(-n // per)
        rows = min(h, room)
        slot = k8_large_slot(n, panel, per, _shares(ctx, first, count, per))
        if (h <= 2 * rows
                and f * (n - per * rows) * ldg * 8 <= K8_LARGE_L2
                and f * slot * 8 <= ctx.plain_bytes(n_shells)):
            in_flight = f
            break
    rounds = -(-systems // in_flight)
    in_flight = -(-systems // rounds)
    per = sms // in_flight
    rows = min(-(-n // per), room)
    return K8Plan("macroatom_large", per, panel,
                  k8_large_smem(n, panel, rows),
                  k8_large_slot(n, panel, per,
                                _shares(ctx, first, count, per)),
                  in_flight * per, systems, rounds,
                  systems / (rounds * in_flight), first, count, rows)


def k8_plan(ctx: _ChainContext, n_shells: int, sms: int,
            active_clusters=None, shape=None) -> tuple:
    """K8's launches for ``n_shells`` shells on a card of ``sms``
    multiprocessors, one ``K8Plan`` each: at most two, on one stream,
    writing disjoint rows.  The work groups (components, largest first)
    that a cluster holds (``k8_cluster_shape`` of the largest of them)
    take the cluster instantiation, on as many clusters as the card holds
    at once (``active_clusters(n_max, cluster, panel)``, the card's
    occupancy query; one block a multiprocessor without it) but no more
    than their systems; each block's slot holds two buffers of p of its
    own rows' transitions (a system's, and the next one's, gathered during
    its elimination).  The larger ones take the large-system
    instantiation, launched first: one block a multiprocessor, the card's
    blocks split evenly between the systems in flight, as many of each
    block's rows in its shared memory as fit, and as many systems in
    flight (at most the systems) as keep at least half of each block's
    rows in shared memory, the rest within K8_LARGE_L2 and the workspace
    within the plain version's largest f64 intermediate (the fewest in
    flight for those rounds).  At the large-ion shape (360 systems of 600
    levels) 10, 11, 12, 13, 16 and 22 in flight took 24.7, 25.5, 23.6,
    23.5, 27.3 and 38.2 ms (PERF.md): rows outside shared memory cost
    more than the rounds they save.  ``shape`` forces one instantiation
    on every system, for a benchmark: (cluster, panel) the cluster one
    (refused where it does not hold the largest), "large" the large one.
    Downbranch mode takes one launch of its own instantiation."""
    systems = ctx.k8_groups * n_shells
    if not ctx.W:
        stride, blocks = k8_workspace(ctx, n_shells, sms)
        rounds = -(-systems // blocks)
        return (K8Plan("downbranch", 1, 1, 8 * (K8_DOWN_TILE
                                                + K8_BLOCK // 32 * K8_STAGE),
                       stride, blocks, systems, rounds,
                       systems / (rounds * blocks), 0, ctx.k8_groups),)
    size = ctx.arrays_np["k8_size"]
    if shape == "large":
        large = ctx.k8_groups
    elif shape is not None:
        large = 0
    else:
        large = sum(k8_cluster_shape(int(n)) is None for n in size)
    plans = []
    if large:
        plans.append(_large_plan(ctx, 0, large, n_shells, sms))
    if large < ctx.k8_groups:
        plans.append(_cluster_plan(ctx, large, ctx.k8_groups - large,
                                   n_shells, sms, active_clusters, shape))
    return tuple(plans)


_K8_ARGTYPES = (
    [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
    + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2)
_K8_VARIANT_CODE = {"downbranch": 0, "macroatom_cluster": 1,
                    "macroatom_large": 2}
_active: dict = {}


def k8_active_clusters(device, defines=()):
    """The card's occupancy query for K8's cluster instantiation: a
    function (n_max, cluster, panel) -> clusters the card holds at once
    for components of up to ``n_max`` levels, asked once a shape."""
    def query(n_max, cluster, panel):
        key = (str(device), n_max, cluster, panel, tuple(defines))
        if key not in _active:
            fn = cuda.function("macro_chain", "macro_chain_clusters",
                               [ctypes.c_int] * 3 + [ctypes.c_void_p],
                               tuple(defines))
            out = ctypes.c_int(0)
            cuda.check_launch("macro_chain_clusters",
                              fn(n_max, cluster, panel, ctypes.byref(out)))
            _active[key] = out.value
        return _active[key]
    return query


def macro_chain(ctx: _ChainContext, arrays: dict, beta: torch.Tensor,
                j_blues: torch.Tensor, stim: torch.Tensor):
    """One chain build, (chain_cdf, emit_cdf): K8 on the card; the plain
    version (``p_norm``, ``chain_tables``) for CPU tensors.

    One launch an instantiation that ``k8_plan`` gives systems, at most
    two a build (``launches_by_variant`` by instantiation:
    "macroatom_cluster", "macroatom_large" or "downbranch").  The outputs
    and K8's workspaces are allocated here; ``arrays`` are the context's
    structure arrays on the tensors' device.  A failed build or launch
    raises: no instantiation stands in for another.
    """
    device = beta.device
    if device.type == "cpu":
        return chain_tables(ctx, arrays, p_norm(
            ctx, arrays, beta.to(F64), j_blues.to(F64), stim.to(F64)))
    if device.type != "cuda":
        raise ValueError(f"macro_chain: unsupported device {device}")
    chain_cdf, emit_cdf, _ = k8_launch(ctx, arrays, beta, j_blues, stim,
                                       counted=True)
    return chain_cdf, emit_cdf


def k8_launch(ctx: _ChainContext, arrays: dict, beta: torch.Tensor,
              j_blues: torch.Tensor, stim: torch.Tensor, defines=(),
              shape=None, counted=False):
    """K8 on the card: (chain_cdf, emit_cdf, its ``K8Plan``s).
    ``macro_chain``'s launches (``counted``: each launch, where there are
    shells, goes through ``tracing.launch`` into ``macro_chain``'s
    counts), and a benchmark's, uncounted, of K8 built with ``defines``
    (``K8_PHASES``) or of a ``shape`` that ``k8_plan`` forces on every
    system."""
    device = beta.device
    beta, j_blues, stim = (t.to(F64).contiguous()
                           for t in (beta, j_blues, stim))
    cuda.check_cuda("macro_chain", device, beta=(beta, F64),
                    j_blues=(j_blues, F64), stim=(stim, F64))
    L, S = beta.shape
    if j_blues.shape != beta.shape or stim.shape != beta.shape:
        raise ValueError(f"macro_chain: beta {tuple(beta.shape)}, j_blues "
                         f"{tuple(j_blues.shape)}, stim {tuple(stim.shape)}")
    if L < ctx.n_lines_read:
        raise ValueError(f"macro_chain: {L} lines, the transitions read "
                         f"{ctx.n_lines_read}")
    M, We, W = ctx.M, ctx.We, ctx.W
    plans = k8_plan(
        ctx, S, torch.cuda.get_device_properties(device).multi_processor_count,
        k8_active_clusters(device, defines), shape)
    emit_cdf = torch.empty((S * M, 3 * We), dtype=torch.float32,
                           device=device)
    chain_cdf = (torch.empty((S * M, W + 1), dtype=torch.float32,
                             device=device) if W else None)
    a = arrays
    fn = cuda.function("macro_chain", "macro_chain", _K8_ARGTYPES,
                       tuple(defines))
    for plan in plans:
        large = plan.variant == "macroatom_large"
        slots = plan.blocks // plan.cluster if large else plan.blocks
        work = torch.empty(plan.slot_stride * slots, dtype=F64,
                           device=device)
        counters = (torch.zeros(slots, dtype=torch.int32, device=device)
                    if large else None)
        g0 = plan.first_group
        launch_args = (
            beta.data_ptr(), j_blues.data_ptr(), stim.data_ptr(), S,
            a["k8_refs"].data_ptr(), a["coef"].data_ptr(),
            a["k8_line"].data_ptr(), a["k8_type"].data_ptr(),
            a["k8_dest"].data_ptr(), a["line_dense"].data_ptr(),
            a["nu_dense"].data_ptr(), M, We, W,
            a["k8_base"][g0:].data_ptr(), a["k8_size"][g0:].data_ptr(),
            a["k8_t0"][g0:].data_ptr(), a["k8_t1"][g0:].data_ptr(),
            plan.n_groups, int(ctx.arrays_np["k8_size"][g0]) if W else 0,
            _K8_VARIANT_CODE[plan.variant], plan.cluster, plan.panel,
            work.data_ptr(), plan.slot_stride, plan.blocks,
            emit_cdf.data_ptr(),
            None if chain_cdf is None else chain_cdf.data_ptr(),
            plan.smem_rows,
            None if counters is None else counters.data_ptr(),
            cuda.stream(),
        )
        with tracing.launch(macro_chain, plan.variant,
                            int(counted and S > 0)):
            err = fn(*launch_args)
            cuda.check_launch("macro_chain", err)
    return chain_cdf, emit_cdf, plans


# kernel launches by instantiation, one an instantiation a build
macro_chain.launches_by_variant = {}


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


class MacroWalkTables(NamedTuple):
    """The RNG-walk macro atom's tables on one device (K7 always walks
    them; K1 where the chain tables do not fit or it is told to walk)."""

    cum_prob: torch.Tensor  # (T, S) f32 block-normalized cumulative
    block_start: torch.Tensor  # (M+1,) i32 block offsets
    dest: torch.Tensor  # (T,) i32 destination level (emission: -1)
    emit: torch.Tensor  # (T,) bool emission transition
    line: torch.Tensor  # (T,) i32 line of the transition
    line2macro: torch.Tensor  # (L,) i32 level a line absorption activates


def solve_macro_state(
    macro: MacroAtomData,
    beta_sobolev: torch.Tensor,  # (L, S) f64
    j_blues: torch.Tensor,
    stim_factor: torch.Tensor,
) -> MacroWalkTables:
    """Per-block cumulative transition probabilities for the RNG walk, on
    the device of ``beta_sobolev``.

    Counterpart of ``tardis_tpu/opacities/macro_atom_solver.py``
    ``solve_macro_state``: p = coef x beta (internal up also x stim x
    J_blue); within each source-level block the running sum (f64, in
    transition order) is rounded to f32 and multiplied by the f32
    reciprocal of the block's total; a block without probability mass is
    all 1 (its first entry wins); each block ends at exactly 1.  This is
    the arithmetic of the JAX package's host-library path, which its
    ``solve_macro_state`` takes where that library is built; its numpy
    fallback takes differences of one global prefix, which loses digits
    in late blocks (up to ~100 f32 ulps on small entries).
    """
    device = beta_sobolev.device

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    li = dev(macro.transition_line_id, torch.int64)
    up = dev(macro.transition_type == MACRO_INTERNAL_UP)
    p = dev(macro.coef, F64)[:, None] * beta_sobolev.to(F64)[li]
    p = torch.where(up[:, None],
                    p * (stim_factor.to(F64)[li] * j_blues.to(F64)[li]), p)
    T, S = p.shape
    refs = np.asarray(macro.block_references, np.int64)
    sizes = np.diff(refs)
    M = len(sizes)
    block_of = np.repeat(np.arange(M), sizes)
    pos = np.arange(T) - refs[block_of]
    # each block's running sums along its own row of a dense layout, the
    # blocks grouped by their width rounded up to a power of two and each
    # group as wide as its widest block: no differences of a long global
    # prefix, and under 2x padding whatever the widest block
    block_group = np.ceil(np.log2(np.maximum(sizes, 1))).astype(np.int64)
    group = block_group[block_of]
    cum = torch.empty_like(p)
    for g in np.unique(block_group[sizes > 0]):
        blocks = np.flatnonzero((block_group == g) & (sizes > 0))
        rank = np.zeros(M, np.int64)
        rank[blocks] = np.arange(len(blocks))
        rows = np.flatnonzero(group == g)
        w = int(sizes[blocks].max())
        dense_idx = dev(rank[block_of[rows]] * w + pos[rows], torch.int64)
        rows = dev(rows, torch.int64)
        dense = torch.zeros((len(blocks) * w, S), dtype=F64, device=device)
        dense[dense_idx] = p[rows]
        run = torch.cumsum(dense.view(len(blocks), w, S), dim=1)
        cum[rows] = run.view(-1, S)[dense_idx]
    last = dev(refs[1:] - 1, torch.int64)
    total = cum[last[dev(block_of, torch.int64)]]
    inv = torch.where(total > 0, 1.0 / torch.where(total > 0, total, 1.0),
                      0.0).float()
    cum = torch.where(total > 0, cum.float() * inv, 1.0)
    cum[last[dev(sizes > 0)]] = 1.0
    return MacroWalkTables(
        cum_prob=cum.float().contiguous(),
        block_start=dev(refs, torch.int32),
        dest=dev(macro.destination_level_id, torch.int32),
        emit=dev(macro.transition_type < 0),
        line=dev(macro.transition_line_id, torch.int32),
        line2macro=dev(macro.line2macro_level_upper, torch.int32),
    )


def chain_tables_fit(macro: MacroAtomData, n_shells: int,
                     mode: str = "macroatom", max_chain_bytes: float = 6e9,
                     line_nu_scaled=None) -> bool:
    """Whether ``solve_macro_chain`` builds tables (else the event loop
    walks the macro atom): the JAX package's ``chain_tables_fit``, from the
    transition table's sparsity and the shell count alone; downbranch
    always fits.  ``line_nu_scaled`` is asked for because the structure it
    builds, cached on ``macro``, carries the line frequencies."""
    if mode == "downbranch":
        return True
    if line_nu_scaled is None:
        raise ValueError("chain_tables_fit needs line_nu_scaled")
    ctx = chain_context(macro, mode, line_nu_scaled)
    return ctx.table_bytes(n_shells) <= max_chain_bytes


def solve_macro_chain(
    macro: MacroAtomData,
    beta_sobolev: torch.Tensor,  # (L, S) f64
    j_blues: torch.Tensor,
    stim_factor: torch.Tensor,
    mode: str,
    line_nu_scaled,
    max_chain_bytes: float = 6e9,
) -> MacroChainState | None:
    """Build the chain tables on the device of ``beta_sobolev`` (K8 on the
    card, ``macro_chain``); None when they would not fit
    ``max_chain_bytes`` (``chain_tables_fit``), where the event loop walks
    the macro atom instead (``solve_macro_state``), as in the JAX package.
    """
    S = beta_sobolev.shape[1]
    if not chain_tables_fit(macro, S, mode, max_chain_bytes, line_nu_scaled):
        return None
    ctx = chain_context(macro, mode, line_nu_scaled)
    arrays = ctx.arrays(beta_sobolev.device)
    chain_cdf, emit_cdf = macro_chain(ctx, arrays, beta_sobolev, j_blues,
                                      stim_factor)
    return MacroChainState(
        n_states=ctx.M,
        chain_width=ctx.W,
        emit_width=ctx.We,
        chain_cdf=chain_cdf,
        emit_cdf=emit_cdf,
        line2macro=macro.line2macro_level_upper.astype(np.int32),
    )
