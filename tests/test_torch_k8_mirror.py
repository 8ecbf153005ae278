"""K8's arithmetic (``tardis_torch/csrc/macro_chain.cu``) repeated in numpy
f64 and held against the port's plain chain build on the CPU.

No kernel runs here, so ``k8_mirror`` makes K8's choices step by step:
each work group of ``_ChainContext`` (a component, or a run of K8_BLOCK
levels in downbranch mode) at its real width, each level's block sum and
emission running sum in transition order, Q's duplicate (source,
destination) pairs summed in transition order, and the in-place
Gauss-Jordan inverse of A = I - Q without pivoting in the panels of the
instantiation ``k8_plan`` sends the component to: the cluster one (16
pivots, the rows split across the cluster's blocks, a multiple of 16 rows
a block) or the large-system one (16 pivots, ceil(n / per) rows a block of
the ``per`` a system is spread over), each pivot row by the pivot's
reciprocal, the panel's own steps on the panel rows' diagonal block, every
other row's panel columns the same steps from the kept pivot rows, then
one rank-kb update of each block's rows from the panel rows as they were
before the panel, every entry of it a sum over the panel's columns in
their order; B = A^-1 diag(d), and the fused clamp, running sum (a warp
scan in chunks of 32), division and fallback (a zero or non-finite pivot,
or a non-finite row, sends the row to the self-deactivation step).  The
card fuses its products (fma, DMMA) where the mirror rounds them apart, so
the two differ in the last bits of the f64 inverse.  The plain version
solves the power-of-two padded systems by LU with partial pivoting, so
the chain rows agree to rounding: atol 1e-6 on the f32 CDFs; the base
column and the emission rows' line and frequency columns are copies, bit
for bit, and the emission CDFs, summed in the same order on both sides,
bit for bit too.
"""

import copy
import subprocess
import sys

import numpy as np
import pytest
import torch

from tardis_torch.atomic.atom_data import MacroAtomData
from tardis_torch.atomic.synthetic import make_synthetic_atom_data
from tardis_torch.config.reader import config_from_dict
from tardis_torch.model.state import SimulationState
from tardis_torch import cuda
from tardis_torch.opacities.macro_atom_solver import (
    K8_CLUSTER_SMEM,
    K8_CLUSTERS,
    K8_LARGE_CHUNK,
    K8_LARGE_L2,
    chain_context,
    k8_cluster_shape,
    k8_cluster_smem,
    k8_large_smem,
    k8_plan,
    k8_workspace,
    macro_chain,
)
from tardis_torch.plasma.solver import PlasmaSolver
from tardis_torch.transport.tables import NU_UNIT

from tests.test_plasma import BASE_CONFIG
from tests.test_torch_macro_chain import CYCLE_LEVELS, cycle_macro, cycle_rates

import chip_smoke

torch.set_num_threads(2)

CHAIN_ATOL = 1e-6
ELEMENTS = [8, 12, 14, 16, 18, 20]
SMS = 132  # an H100 SXM's multiprocessors


def gauss_jordan(a, kb_max, rows=None):
    """K8's in-place Gauss-Jordan inverse of each (n, n) matrix of ``a``
    (S, n, n) without pivoting, ``kb_max`` pivots a panel; returns the
    inverses and whether each system met a zero or non-finite pivot.

    Each panel as both chain instantiations order it: the panel rows'
    diagonal block D runs the kb pivot steps (each step's normalised pivot
    row kept, by the pivot's reciprocal), every other row's panel columns
    take the same steps from the kept rows, then the rank-kb update of the
    rest from the panel rows as they were before the panel, a sum over the
    panel's columns in order.  With ``rows`` each block (of a cluster, or
    of the blocks a large system is spread over) runs this on its own
    ``rows`` rows and its own copy of D; the split changes no arithmetic,
    which the mirror shows by running it.  The card fuses each product
    into its sum (fma, DMMA), the mirror rounds the two apart: the
    inverses differ in their last bits."""
    a = a.copy()
    S, n, _ = a.shape
    h = rows or n
    singular = np.zeros(S, bool)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for k0 in range(0, n, kb_max):
            kb = min(kb_max, n - k0)
            P = slice(k0, k0 + kb)
            R = a[:, P, :].copy()  # every block's copy of the panel rows
            D = R[:, :, P].copy()
            kept = np.empty((S, kb, kb))
            for kk in range(kb):
                piv = D[:, kk, kk].copy()
                singular |= ~((piv != 0.0) & np.isfinite(piv))
                rk = D[:, kk, :].copy()
                rk[:, kk] = 1.0
                rk = rk * (1.0 / piv)[:, None]  # one division a step
                f = D[:, :, kk].copy()
                D[:, :, kk] = 0.0
                D = D - f[:, :, None] * rk[:, None, :]
                D[:, kk, :] = rk
                kept[:, kk] = rk
            acc = np.empty_like(a)
            for r0 in range(0, n, h):  # each block's rows
                rows_b = slice(r0, min(n, r0 + h))
                C = a[:, rows_b, P].copy()
                for kk in range(kb):
                    f = C[:, :, kk].copy()
                    C[:, :, kk] = 0.0
                    C = C - f[:, :, None] * kept[:, None, kk, :]
                mine = np.arange(rows_b.start, rows_b.stop)
                in_panel = (mine >= k0) & (mine < k0 + kb)
                C[:, in_panel] = D[:, mine[in_panel] - k0]
                block = a[:, rows_b, :].copy()
                block[:, in_panel, :] = 0.0
                for p in range(kb):
                    block = block + C[:, :, p:p + 1] * R[:, p:p + 1, :]
                block[:, :, P] = C
                acc[:, rows_b, :] = block
            a = acc
    return a, singular


def block_rows(plans, g, n):
    """The rows a block holds of work group ``g`` (``n`` levels) in the
    launch of ``plans`` that takes it: a cluster's rows_of(n, cluster), a
    multiple of 16, or the large instantiation's ceil(n / per)."""
    plan, = [p for p in plans
             if p.first_group <= g < p.first_group + p.n_groups]
    if plan.variant == "macroatom_large":
        return plan, -(-n // plan.cluster)
    return plan, -(-(-(-n // plan.cluster)) // 16) * 16


def warp_scan(x, n):
    """The cluster instantiation's running sums of each row of ``x`` (...,
    n), 32 columns a chunk: a Kogge-Stone sum over the chunk's lanes, the
    previous chunk's last sum added, then a running maximum over the lanes
    (the sums of non-negative terms, grouped differently lane by lane,
    could fall by an ulp)."""
    out = np.empty_like(x)
    carry = np.zeros(x.shape[:-1])
    for j0 in range(0, n, 32):
        v = np.zeros(x.shape[:-1] + (32,))
        m = min(32, n - j0)
        v[..., :m] = x[..., j0:j0 + m]
        o = 1
        while o < 32:
            v = np.concatenate([v[..., :o], v[..., o:] + v[..., :-o]],
                               axis=-1)
            o *= 2
        v = carry[..., None] + v
        o = 1
        while o < 32:
            v = np.concatenate([v[..., :o], np.fmax(v[..., o:], v[..., :-o])],
                               axis=-1)
            o *= 2
        out[..., j0:j0 + m] = v[..., :m]
        carry = v[..., m - 1]
    return out


def k8_mirror(ctx, beta, jb, stim):
    """(chain_cdf, emit_cdf) as K8 computes them, from (L, S) f64 numpy
    tables."""
    a = ctx.arrays_np
    S = beta.shape[1]
    M, We, W = ctx.M, ctx.We, ctx.W
    refs = a["k8_refs"].astype(np.int64)
    typ, dest = a["k8_type"], a["k8_dest"].astype(np.int64)
    emit = np.empty((S, M, 3 * We), np.float32)
    emit[:, :, We:2 * We] = a["line_dense"]
    emit[:, :, 2 * We:] = a["nu_dense"]
    chain = np.empty((S, M, W + 1), np.float32) if W else None
    plans = k8_plan(ctx, S, SMS)
    for g in range(ctx.k8_groups):
        base, n = int(a["k8_base"][g]), int(a["k8_size"][g])
        t0, t1 = int(a["k8_t0"][g]), int(a["k8_t1"][g])
        li = a["k8_line"][t0:t1]
        p = a["coef"][t0:t1, None] * beta[li]
        up = typ[t0:t1] == 1
        p[up] = p[up] * (stim[li[up]] * jb[li[up]])
        # each level's transitions along a row, zeros after its last:
        # numpy's cumsum adds in order, so the last column is the sum in
        # transition order
        lv = np.repeat(np.arange(n), np.diff(refs[base:base + n + 1]))
        pos = np.arange(t1 - t0) - (refs[base + lv] - t0)
        dense = np.zeros((n, max(int(pos.max(initial=0)) + 1, 1), S))
        dense[lv, pos] = p
        bsum = np.cumsum(dense, axis=1)[:, -1][lv]
        pn = np.where(bsum > 0, p / np.where(bsum > 0, bsum, 1.0), 0.0)
        em = typ[t0:t1] < 0
        e_lv = lv[em]
        e_slot = np.arange(len(e_lv)) - np.searchsorted(e_lv, e_lv)
        edense = np.zeros((n, We, S))
        edense[e_lv, e_slot] = pn[em]
        cum = np.cumsum(edense, axis=1)
        tot = cum[:, -1:]
        ecdf = np.where(tot > 0, cum / np.where(tot > 0, tot, 1.0), 1.0)
        emit[:, base:base + n, :We] = ecdf.transpose(2, 0, 1)
        if not W:
            continue
        Q = np.zeros((S, n, n))
        i_lv, i_dest = lv[~em], dest[t0:t1][~em] - base
        for s in range(S):  # np.add.at adds in index order
            np.add.at(Q[s], (i_lv, i_dest), pn[~em, s])
        plan, h = block_rows(plans, g, n)
        ainv, singular = gauss_jordan(np.eye(n)[None] - Q, plan.panel, h)
        d = tot[:, 0, :].T  # (S, n)
        with np.errstate(invalid="ignore", over="ignore"):
            B = ainv * d[:, None, :]
            finite = np.isfinite(B).all(axis=2) & ~singular[:, None]
            clamped = np.fmax(B, 0.0)
            run = warp_scan(clamped, n)
            rtot = run[:, :, -1:]
            ok = finite[:, :, None] & (rtot > 0)
            rows = np.ones((S, n, W), np.float32)
            rows[:, :, :n] = run / np.where(ok, rtot, 1.0)
        step = np.arange(W)[None, :] >= np.arange(n)[:, None]
        chain[:, base:base + n, :W] = np.where(ok, rows, step[None])
        chain[:, base:base + n, W] = base
    return (None if chain is None else chain.reshape(S * M, W + 1),
            emit.reshape(S * M, 3 * We))


def plain_and_mirror(macro, mode, line_nu_scaled, beta, jb, stim):
    ctx = chain_context(macro, mode, line_nu_scaled)
    chain, emit = macro_chain(
        ctx, ctx.arrays("cpu"), *(torch.as_tensor(t) for t in (beta, jb, stim)))
    m_chain, m_emit = k8_mirror(ctx, beta, jb, stim)
    return ctx, (chain, emit), (m_chain, m_emit)


def hold(ctx, plain, mirror):
    """The mirror's tables against the plain version's; returns the
    largest chain-row difference."""
    chain, emit = plain
    m_chain, m_emit = mirror
    We, W = ctx.We, ctx.W
    e = emit.numpy()
    assert m_emit.shape == e.shape and m_emit.dtype == np.float32
    np.testing.assert_array_equal(m_emit, e)
    if not W:
        assert chain is None and m_chain is None
        return 0.0
    c = chain.numpy()
    assert m_chain.shape == c.shape
    np.testing.assert_array_equal(m_chain[:, W], c[:, W])
    diff = float(np.abs(m_chain[:, :W] - c[:, :W]).max())
    assert diff <= CHAIN_ATOL, diff
    assert np.isfinite(m_chain).all()
    assert (np.diff(m_chain[:, :W], axis=1) >= 0).all()
    assert (m_chain[:, W - 1] == 1.0).all()
    np.testing.assert_array_equal(m_emit[:, We:], e[:, We:])
    return diff


def plasma_rates(atom, n_shells):
    """The port's CPU plasma on the plasma test model cut into
    ``n_shells`` shells: (beta, j_blues, stim) as (L, S) f64 numpy."""
    cfg = copy.deepcopy(BASE_CONFIG)
    cfg["model"]["structure"]["velocity"]["num"] = n_shells
    state = SimulationState.from_config(config_from_dict(cfg))
    ps = PlasmaSolver(atom, state, "cpu").update(state.t_radiative,
                                                 state.dilution_factor)
    return tuple(np.asarray(t.numpy(), np.float64) for t in (
        ps.beta_sobolev, ps.j_blues, ps.stimulated_emission_factor))


@pytest.mark.parametrize("mode", ["macroatom", "downbranch"])
def test_mirror_on_the_test_atom(mode):
    """The plasma tests' atom (synthetic data, 20 shells) in both modes."""
    atom = make_synthetic_atom_data().prepare(selected_atoms=ELEMENTS,
                                              line_interaction_type=mode)
    macro = atom.downbranch if mode == "downbranch" else atom.macro_atom
    rates = plasma_rates(atom, 20)
    ctx, plain, mirror = plain_and_mirror(macro, mode, atom.line_nu / NU_UNIT,
                                          *rates)
    hold(ctx, plain, mirror)


@pytest.fixture(scope="module")
def bench_atom():
    """The bench problem's atomic data (200 levels, level jumps up to
    60)."""
    return make_synthetic_atom_data(n_levels=200, max_level_jump=60).prepare(
        selected_atoms=ELEMENTS, line_interaction_type="macroatom")


@pytest.mark.parametrize("n_shells", [2, 4])
def test_mirror_at_the_bench_width(bench_atom, n_shells):
    """The bench atom: 18 components of 200 levels, K8's cluster
    instantiation (clusters of 2 blocks, 16-pivot panels), at 2 and 4
    shells."""
    atom = bench_atom
    rates = plasma_rates(atom, n_shells)
    ctx, plain, mirror = plain_and_mirror(
        atom.macro_atom, "macroatom", atom.line_nu / NU_UNIT, *rates)
    assert ctx.k8_n_max == 200 and ctx.k8_groups == 18
    plan, = k8_plan(ctx, n_shells, SMS)
    assert (plan.variant, plan.cluster, plan.panel) == (
        "macroatom_cluster", 2, 16)
    hold(ctx, plain, mirror)


@pytest.fixture(scope="module")
def wide_atom():
    """One element of 600 levels: a component past a cluster's reach."""
    return make_synthetic_atom_data(n_levels=600, max_level_jump=60).prepare(
        selected_atoms=[8], line_interaction_type="macroatom")


def test_mirror_on_a_component_past_the_cluster(wide_atom):
    """Three 600-level components take the large-system instantiation
    (16-pivot panels, each system's rows spread over the blocks the plan
    gives it, the warp scan's row sums) at 2 shells."""
    atom = wide_atom
    rates = plasma_rates(atom, 2)
    ctx, plain, mirror = plain_and_mirror(
        atom.macro_atom, "macroatom", atom.line_nu / NU_UNIT, *rates)
    assert ctx.k8_n_max == 600 and k8_cluster_shape(600) is None
    plan, = k8_plan(ctx, 2, SMS)
    assert (plan.variant, plan.panel, plan.systems) == (
        "macroatom_large", 16, 6)
    assert plan.cluster * (plan.blocks // plan.cluster) == plan.blocks
    hold(ctx, plain, mirror)


def test_mirror_at_400_levels():
    """One element of 400 levels (level jumps up to 20): the large-system
    instantiation at 2 shells, every block's rows in its shared memory."""
    atom = make_synthetic_atom_data(n_levels=400, max_level_jump=20).prepare(
        selected_atoms=[8], line_interaction_type="macroatom")
    rates = plasma_rates(atom, 2)
    ctx, plain, mirror = plain_and_mirror(
        atom.macro_atom, "macroatom", atom.line_nu / NU_UNIT, *rates)
    plan, = k8_plan(ctx, 2, SMS)
    assert plan.variant == "macroatom_large" and ctx.k8_n_max == 400
    assert plan.smem_rows == -(-400 // plan.cluster)
    hold(ctx, plain, mirror)


def mixed_context(bench_atom, wide_atom):
    """The bench atom's macro table and the wide element's side by side,
    built from their arrays (chip_smoke.k8_mixed_macro): 18 components of
    200 levels and 3 of 600."""
    macro, nu = chip_smoke.k8_mixed_macro(bench_atom, wide_atom)
    return macro, nu, chain_context(macro, "macroatom", nu)


def test_mirror_on_a_mixed_context(bench_atom, wide_atom):
    """The mixed build at 1 shell, on seeded rates: the 600-level systems
    in the large-system instantiation's order, the 200-level ones in the
    cluster one's, all against one plain build."""
    macro, nu, ctx = mixed_context(bench_atom, wide_atom)
    gen = np.random.default_rng(5)
    rates = [gen.uniform(lo, hi, (len(nu), 1))
             for lo, hi in ((0.1, 1.0), (1e-6, 1e-4), (0.5, 1.0))]
    _, plain, mirror = plain_and_mirror(macro, "macroatom", nu, *rates)
    assert [p.variant for p in k8_plan(ctx, 1, SMS)] == [
        "macroatom_large", "macroatom_cluster"]
    hold(ctx, plain, mirror)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warp_scan_is_the_running_sum(seed):
    """The cluster instantiation's row scan on rows of zeros, tiny and
    large terms past several chunks: non-decreasing, within a few ulps of
    the sequential running sum, its last entry the row's total."""
    gen = np.random.default_rng(seed)
    n = 200
    x = gen.uniform(0.0, 1.0, (64, n)) * 10.0 ** gen.integers(-30, 3,
                                                              (64, n))
    x[gen.uniform(size=x.shape) < 0.3] = 0.0
    run = warp_scan(x, n)
    assert (np.diff(run, axis=1) >= 0).all()
    np.testing.assert_allclose(run, np.cumsum(x, axis=1), rtol=1e-14,
                               atol=0)


def test_mirror_on_a_singular_component():
    """The closed two-level cycle of ``test_torch_macro_chain.py``: a zero
    pivot, the cycle's rows the self-deactivation step on both sides."""
    beta, jb, stim, nu = cycle_rates()
    ctx, plain, mirror = plain_and_mirror(cycle_macro(MacroAtomData),
                                          "macroatom", nu, beta, jb, stim)
    hold(ctx, plain, mirror)
    W = ctx.W
    rows = mirror[0].reshape(-1, ctx.M, W + 1)[:, list(CYCLE_LEVELS), :W]
    step = np.arange(W)[None, :] >= np.arange(len(CYCLE_LEVELS))[:, None]
    np.testing.assert_array_equal(rows, np.broadcast_to(step, rows.shape))


@pytest.mark.parametrize("kb", [32, 8, 1])
def test_blocked_inverse_is_the_inverse(kb):
    """Any panel width inverts a diagonally dominant M-matrix of a width
    that is no multiple of it, whatever the rows a block holds."""
    gen = np.random.default_rng(kb)
    n = 45
    Q = gen.uniform(0.0, 1.0, (2, n, n)) * (gen.uniform(size=(2, n, n)) < 0.3)
    Q *= gen.uniform(0.5, 0.99, (2, n, 1)) / Q.sum(axis=2, keepdims=True)
    A = np.eye(n)[None] - Q
    for rows in (None, 7, 16):
        inv, singular = gauss_jordan(A, kb, rows)
        assert not singular.any()
        np.testing.assert_allclose(inv, np.linalg.inv(A), rtol=1e-12,
                                   atol=1e-14)


@pytest.mark.parametrize("n_shells", [20, 100])
def test_k8_workspace_within_the_plain_allocation(bench_atom, n_shells):
    """At the bench shape and at 100 shells on a card of 132
    multiprocessors, K8's workspaces (the cluster instantiation's, a slot
    a block; downbranch's, one work group a slot) take no more than the
    plain version's f64 solve allocates."""
    ctx = chain_context(bench_atom.macro_atom, "macroatom",
                        bench_atom.line_nu / NU_UNIT)
    plan, = k8_plan(ctx, n_shells, SMS)
    assert 8 * plan.slot_stride * plan.blocks <= ctx.plain_bytes(n_shells)
    down = chain_context(bench_atom.downbranch, "downbranch",
                         bench_atom.line_nu / NU_UNIT)
    stride, slots = k8_workspace(down, n_shells, 132)
    assert down.k8_n_max == 0 and stride >= 256 + down.k8_t_max
    assert stride % 32 == 0 and 1 <= slots <= 2 * 132
    assert 8 * stride * slots <= down.plain_bytes(n_shells)
    assert k8_plan(down, n_shells, SMS)[0][4:6] == (stride, slots)


@pytest.mark.parametrize("n_max", [1, 200, 736, 737, 2787, 2788, 25536])
def test_k8_panel_fits_shared_memory(n_max):
    """The large-system instantiation's panel rows (a chunk of at most
    K8_LARGE_CHUNK columns), its pivot blocks and staging, and as many of
    a block's rows as ``k8_plan`` puts there fit a block's shared memory
    for components of ``n_max`` levels, and one row more would not (unless
    every row is there)."""
    from types import SimpleNamespace

    refs = np.arange(n_max + 1, dtype=np.int32) * 3
    ctx = SimpleNamespace(
        k8_groups=1, k8_n_max=n_max, W=n_max,
        arrays_np=dict(k8_size=np.array([n_max], np.int32),
                       k8_base=np.array([0], np.int32), k8_refs=refs),
        plain_bytes=lambda S: 24.0 * 2 ** (2 * int(np.ceil(np.log2(
            max(n_max, 8))))) * S)
    plan, = k8_plan(ctx, 2, SMS, shape="large")
    assert plan.smem == k8_large_smem(n_max, 16, plan.smem_rows)
    assert plan.smem <= K8_CLUSTER_SMEM
    per = plan.cluster
    assert (plan.smem_rows == -(-n_max // per)
            or k8_large_smem(n_max, 16, plan.smem_rows + 1)
            > K8_CLUSTER_SMEM)
    assert min(-(-n_max // 8) * 8, K8_LARGE_CHUNK) * 16 * 8 <= plan.smem


@pytest.mark.parametrize("n_max", [1, 8, 100, 185, 186, 200, 250, 300,
                                   384, 385])
def test_k8_cluster_shape_fits_shared_memory(n_max):
    """The cluster instantiation's shape for a component size: the
    smallest cluster of K8_CLUSTERS whose blocks hold it with a panel of
    16, within a block's 232,448 bytes less the static kilobyte; none past
    the largest cluster's reach (384 levels)."""
    shape = k8_cluster_shape(n_max)
    if n_max > 384:
        assert shape is None
        assert k8_cluster_smem(n_max, max(K8_CLUSTERS), 16) > K8_CLUSTER_SMEM
        return
    cluster, panel = shape
    assert panel == 16 and cluster in K8_CLUSTERS
    assert k8_cluster_smem(n_max, cluster, panel) <= K8_CLUSTER_SMEM
    assert K8_CLUSTER_SMEM + 1024 == 232_448
    assert all(k8_cluster_smem(n_max, c, 16) > K8_CLUSTER_SMEM
               for c in K8_CLUSTERS if c < cluster)


@pytest.mark.parametrize("n_shells,rounds", [(20, 6), (100, 28)])
def test_k8_plan_at_the_bench_shape(bench_atom, n_shells, rounds):
    """At the bench shape on a card of 132 multiprocessors: one launch,
    clusters of 2 with 16-pivot panels, one block a multiprocessor, the
    rounds and their fill, and each block's slot holding p of its rows'
    transitions."""
    ctx = chain_context(bench_atom.macro_atom, "macroatom",
                        bench_atom.line_nu / NU_UNIT)
    plan, = k8_plan(ctx, n_shells, SMS)
    assert (plan.variant, plan.cluster, plan.panel, plan.blocks) == (
        "macroatom_cluster", 2, 16, SMS)
    assert plan.systems == 18 * n_shells and plan.rounds == rounds
    assert plan.fill == plan.systems / (rounds * SMS // 2)
    assert plan.smem == k8_cluster_smem(200, 2, 16) <= K8_CLUSTER_SMEM
    assert (plan.first_group, plan.n_groups) == (0, 18)
    refs = ctx.arrays_np["k8_refs"]
    for base in ctx.arrays_np["k8_base"]:
        for r0, r1 in ((0, 112), (112, 200)):
            assert refs[base + r1] - refs[base + r0] <= plan.slot_stride // 2
    assert plan.slot_stride % 64 == 0
    # the card's occupancy query, where it holds fewer clusters
    fewer, = k8_plan(ctx, n_shells, SMS,
                     active_clusters=lambda n, c, p: 60)
    assert fewer.blocks == 120 and fewer.rounds == -(-18 * n_shells // 60)
    down = chain_context(bench_atom.downbranch, "downbranch",
                         bench_atom.line_nu / NU_UNIT)
    plan, = k8_plan(down, n_shells, SMS)
    assert (plan.variant, plan.cluster, plan.panel) == ("downbranch", 1, 1)


# the parent tree's k8_plan on the bench atom (the fields it had), by mode
# and shells: every path driven before the large-system instantiation keeps
# its plan, its single launch and its tables
PARENT_BENCH_PLANS = {
    ("macroatom", 20): ("macroatom_cluster", 2, 16, 222272, 33024, 132, 360,
                        6, 0.9090909090909091),
    ("macroatom", 100): ("macroatom_cluster", 2, 16, 222272, 33024, 132,
                         1800, 28, 0.974025974025974),
    ("downbranch", 20): ("downbranch", 1, 1, 4608, 13792, 264, 300, 2,
                         0.5681818181818182),
    ("downbranch", 100): ("downbranch", 1, 1, 4608, 13792, 264, 1500, 6,
                          0.946969696969697),
}


@pytest.mark.parametrize("mode,n_shells", sorted(PARENT_BENCH_PLANS))
def test_k8_plan_on_the_bench_atom_is_the_parents(bench_atom, mode,
                                                    n_shells):
    macro = bench_atom.macro_atom if mode == "macroatom" else \
        bench_atom.downbranch
    ctx = chain_context(macro, mode, bench_atom.line_nu / NU_UNIT)
    plan, = k8_plan(ctx, n_shells, SMS)
    assert tuple(plan)[:9] == PARENT_BENCH_PLANS[mode, n_shells]
    assert (plan.first_group, plan.n_groups) == (0, ctx.k8_groups)


def test_k8_plan_sends_every_600_level_system_to_the_large_instantiation(
        wide_atom):
    """A 600-level atom: one launch of the large-system instantiation for
    every system (12 at 4 shells: 11 blocks each, the card's 132 busy in
    one round, 29 of each block's 55 rows in its shared memory); a cluster
    shape forced on it is refused."""
    ctx = chain_context(wide_atom.macro_atom, "macroatom",
                        wide_atom.line_nu / NU_UNIT)
    plan, = k8_plan(ctx, 4, SMS)
    assert (plan.variant, plan.first_group, plan.n_groups) == (
        "macroatom_large", 0, 3)
    assert (plan.cluster, plan.blocks, plan.systems, plan.rounds) == (
        11, 132, 12, 1)
    assert plan.smem_rows == 29 and plan.smem <= K8_CLUSTER_SMEM
    with pytest.raises(ValueError, match="does not hold"):
        k8_plan(ctx, 4, SMS, shape=(8, 16))


@pytest.mark.parametrize("n_shells", [1, 4, 20])
def test_k8_plan_partitions_a_mixed_build(bench_atom, wide_atom, n_shells):
    """The mixed build: two launches, the large-system one for the three
    600-level components (the first work groups, largest first) and the
    cluster one for the eighteen 200-level ones, as the bench build plans
    them; every work group in exactly one, every system counted once."""
    _, _, ctx = mixed_context(bench_atom, wide_atom)
    size = ctx.arrays_np["k8_size"]
    large, cluster = k8_plan(ctx, n_shells, SMS)
    assert (large.variant, cluster.variant) == ("macroatom_large",
                                                "macroatom_cluster")
    taken = np.zeros(ctx.k8_groups, int)
    for p in (large, cluster):
        taken[p.first_group:p.first_group + p.n_groups] += 1
        assert p.systems == p.n_groups * n_shells
    assert (taken == 1).all()
    assert (size[:large.n_groups] == 600).all()
    assert (size[large.n_groups:] == 200).all()
    bench, = k8_plan(chain_context(bench_atom.macro_atom, "macroatom",
                                   bench_atom.line_nu / NU_UNIT),
                     n_shells, SMS)
    assert tuple(cluster)[:9] == tuple(bench)[:9]


@pytest.mark.parametrize("case", ["wide", "mixed", "bench_forced"])
@pytest.mark.parametrize("n_shells", [4, 20])
def test_k8_large_plan_bytes(bench_atom, wide_atom, case, n_shells):
    """The large-system instantiation's plan within the card: its shared
    memory within a block's 227 KB (less the static kilobyte), its blocks
    one a multiprocessor at most, its workspace within the JAX package's
    byte bound for the solve it replaces (``table_bytes``'s solve term, 12
    bytes an entry of the padded systems) and its matrices' rows outside
    shared memory within K8_LARGE_L2."""
    if case == "mixed":
        ctx = mixed_context(bench_atom, wide_atom)[2]
        plan = k8_plan(ctx, n_shells, SMS)[0]
    else:
        atom = wide_atom if case == "wide" else bench_atom
        ctx = chain_context(atom.macro_atom, "macroatom",
                            atom.line_nu / NU_UNIT)
        plan, = k8_plan(ctx, n_shells, SMS,
                        shape="large" if case == "bench_forced" else None)
    assert plan.variant == "macroatom_large"
    assert plan.smem <= K8_CLUSTER_SMEM and plan.blocks <= SMS
    in_flight = plan.blocks // plan.cluster
    assert plan.blocks == in_flight * plan.cluster
    solve = max(n_shells * b["n_cb"] * b["Wp"] ** 2 * 12.0
                for b in ctx.bucket_meta)
    assert 8 * plan.slot_stride * in_flight <= solve
    n = int(ctx.arrays_np["k8_size"][plan.first_group])
    h = -(-n // plan.cluster)
    assert h <= 2 * plan.smem_rows
    assert in_flight * (n - plan.cluster * plan.smem_rows) * (
        -(-n // 8) * 8) * 8 <= K8_LARGE_L2


def test_chain_tables_solve_one_system_a_call_on_the_cpu():
    """The plain version's solve of two 256-level systems with two
    threads: oneMKL 2024.2's batched LU (PyTorch 2.13's CPU build) stops
    there and never returns, so the CPU takes one system a call
    (``macro_atom_solver._solve``); run in a child process with a time
    limit, its solution that of numpy's."""
    code = (
        "import numpy as np, torch\n"
        "from tardis_torch.opacities.macro_atom_solver import _solve\n"
        "torch.set_num_threads(2)\n"
        "g = np.random.default_rng(0)\n"
        "Q = g.uniform(0, 1, (2, 256, 256)) * (g.uniform(size=(2, 256, 256))"
        " < 0.05)\n"
        "Q *= 0.9 / Q.sum(axis=2, keepdims=True)\n"
        "A = np.eye(256)[None] - Q\n"
        "B = _solve(torch.as_tensor(A), torch.eye(256, dtype=torch.float64)"
        ".expand(2, 256, 256).contiguous())\n"
        "np.testing.assert_allclose(B.numpy(), np.linalg.inv(A), rtol=1e-10,"
        " atol=1e-12)\n"
        "print('solved')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "solved" in out.stdout, out.stderr


def test_k8_is_built_and_cpu_tensors_launch_nothing():
    """K8 is registered for the build with its source note, and a build on
    CPU tensors runs the plain version without counting a launch."""
    src = (cuda.CSRC / "macro_chain.cu").read_text()
    assert "macro_chain" in cuda.KERNELS
    assert "macro_atom_solver.py:389" in src and ":404" in src
    assert "Bound on the H100: operations" in src
    beta, jb, stim, nu = cycle_rates()
    ctx = chain_context(cycle_macro(MacroAtomData), "macroatom", nu)
    before = dict(macro_chain.launches_by_variant)
    chain, emit = macro_chain(ctx, ctx.arrays("cpu"),
                              *(torch.as_tensor(t) for t in (beta, jb, stim)))
    assert chain.device.type == "cpu" and emit.dtype == torch.float32
    assert dict(macro_chain.launches_by_variant) == before
