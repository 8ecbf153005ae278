"""K8's arithmetic (``tardis_torch/csrc/macro_chain.cu``) repeated in numpy
f64 and held against the port's plain chain build on the CPU.

No kernel runs here, so ``k8_mirror`` makes K8's choices step by step:
each work group of ``_ChainContext`` (a component, or a run of K8_BLOCK
levels in downbranch mode) at its real width, each level's block sum and
emission running sum in transition order, Q's duplicate (source,
destination) pairs summed in transition order, the in-place Gauss-Jordan
inverse of A = I - Q without pivoting in panels of ``k8_panel`` pivots
(the panel's own steps, then one rank-kb update of the rest from the
panel rows as they were before it), B = A^-1 diag(d), and the fused clamp,
running sum, division and fallback (a zero or non-finite pivot, or a
non-finite row, sends the row to the self-deactivation step).  The plain
version solves the power-of-two padded systems by LU with partial
pivoting, so the chain rows agree to rounding: atol 1e-6 on the f32 CDFs
(the largest difference found is 0: in every case here the f64 results
round to the same f32 rows); the base column and the emission rows' line
and frequency columns are copies, bit for bit, and the emission CDFs,
summed in the same order on both sides, bit for bit too.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from tardis_torch.atomic.atom_data import MacroAtomData
from tardis_torch.atomic.synthetic import make_synthetic_atom_data
from tardis_torch.config.reader import config_from_dict
from tardis_torch.model.state import SimulationState
from tardis_torch import cuda
from tardis_torch.opacities.macro_atom_solver import (
    K8_SMEM,
    K8_TILE,
    chain_context,
    k8_panel,
    k8_workspace,
    macro_chain,
)
from tardis_torch.plasma.solver import PlasmaSolver
from tardis_torch.transport.tables import NU_UNIT

from tests.test_plasma import BASE_CONFIG
from tests.test_torch_macro_chain import CYCLE_LEVELS, cycle_macro, cycle_rates

torch.set_num_threads(2)

CHAIN_ATOL = 1e-6
ELEMENTS = [8, 12, 14, 16, 18, 20]


def gauss_jordan(a, kb_max):
    """K8's in-place Gauss-Jordan inverse of each (n, n) matrix of ``a``
    (S, n, n) without pivoting, ``kb_max`` pivots a panel; returns the
    inverses and whether each system met a zero or non-finite pivot."""
    a = a.copy()
    S, n, _ = a.shape
    singular = np.zeros(S, bool)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for k0 in range(0, n, kb_max):
            kb = min(kb_max, n - k0)
            P = slice(k0, k0 + kb)
            C = a[:, :, P].copy()
            for kk in range(kb):
                k = k0 + kk
                piv = C[:, k, kk].copy()
                singular |= ~((piv != 0.0) & np.isfinite(piv))
                rk = C[:, k, :].copy()
                rk[:, kk] = 1.0
                rk = rk / piv[:, None]
                f = C[:, :, kk].copy()
                C[:, :, kk] = 0.0
                C = C - f[:, :, None] * rk[:, None, :]
                C[:, k, :] = rk
            R = a[:, P, :].copy()
            acc = a.copy()
            acc[:, P, :] = 0.0
            for p in range(kb):
                acc = acc + C[:, :, p:p + 1] * R[:, p:p + 1, :]
            acc[:, :, P] = C
            a = acc
    return a, singular


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
    kb = k8_panel(ctx.k8_n_max) if W else 1
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
        ainv, singular = gauss_jordan(np.eye(n)[None] - Q, kb)
        d = tot[:, 0, :].T  # (S, n)
        with np.errstate(invalid="ignore", over="ignore"):
            B = ainv * d[:, None, :]
            finite = np.isfinite(B).all(axis=2) & ~singular[:, None]
            run = np.cumsum(np.maximum(B, 0.0), axis=2)
            rtot = run[:, :, -1:]
            ok = finite[:, :, None] & (rtot > 0)
            rows = np.ones((S, n, W), np.float32)
            rows[:, :, :n] = run / np.where(ok, rtot, 1.0)
        step = np.arange(W)[None, :] >= np.arange(n)[:, None]
        chain[:, base:base + n, :W] = np.where(ok, rows, step[None])
        chain[:, base:base + n, W] = base
    return (None if chain is None else chain.reshape(S * M, W + 1),
            emit.reshape(S * M, 3 * We))


@contextlib.contextmanager
def one_thread():
    """PyTorch 2.13's CPU build with oneMKL 2024.2 stops in a batched f64
    LU of 200-level systems with more than one thread ("Parameter 6 was
    incorrect on entry to DLASWP") and never returns; with one it solves
    the bench width's systems in milliseconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def plain_and_mirror(macro, mode, line_nu_scaled, beta, jb, stim):
    ctx = chain_context(macro, mode, line_nu_scaled)
    with one_thread():
        chain, emit = macro_chain(
            ctx, ctx.arrays("cpu"),
            *(torch.as_tensor(t) for t in (beta, jb, stim)))
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
    """The bench atom: 18 components of 200 levels, K8's widest panel (32
    pivots), at 2 and 4 shells."""
    atom = bench_atom
    rates = plasma_rates(atom, n_shells)
    ctx, plain, mirror = plain_and_mirror(
        atom.macro_atom, "macroatom", atom.line_nu / NU_UNIT, *rates)
    assert ctx.k8_n_max == 200 and ctx.k8_groups == 18
    assert k8_panel(ctx.k8_n_max) == 32
    hold(ctx, plain, mirror)


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
    """Each panel width K8 may take inverts a diagonally dominant
    M-matrix of a width that is no multiple of it."""
    gen = np.random.default_rng(kb)
    n = 45
    Q = gen.uniform(0.0, 1.0, (2, n, n)) * (gen.uniform(size=(2, n, n)) < 0.3)
    Q *= gen.uniform(0.5, 0.99, (2, n, 1)) / Q.sum(axis=2, keepdims=True)
    A = np.eye(n)[None] - Q
    inv, singular = gauss_jordan(A, kb)
    assert not singular.any()
    np.testing.assert_allclose(inv, np.linalg.inv(A), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("n_shells", [20, 100])
def test_k8_workspace_within_the_plain_allocation(bench_atom, n_shells):
    """At the bench shape and at 100 shells on a card of 132
    multiprocessors, K8's workspace holds one system a slot and takes no
    more than the plain version's f64 solve allocates."""
    ctx = chain_context(bench_atom.macro_atom, "macroatom",
                        bench_atom.line_nu / NU_UNIT)
    stride, slots = k8_workspace(ctx, n_shells, 132)
    n = ctx.k8_n_max
    assert stride % 32 == 0 and stride >= n * n + n + ctx.k8_t_max
    assert 1 <= slots <= min(ctx.k8_groups * n_shells, 2 * 132)
    assert 8 * stride * slots <= ctx.plain_bytes(n_shells)
    down = chain_context(bench_atom.downbranch, "downbranch",
                         bench_atom.line_nu / NU_UNIT)
    stride, slots = k8_workspace(down, n_shells, 132)
    assert down.k8_n_max == 0 and stride >= down.k8_t_max
    assert 8 * stride * slots <= down.plain_bytes(n_shells)


@pytest.mark.parametrize("n_max", [1, 200, 736, 737, 2787, 2788, 25536])
def test_k8_panel_fits_shared_memory(n_max):
    """The panel width K8 takes for a component size keeps its panel and
    tile within K8_SMEM, and is the widest that does."""
    kb = k8_panel(n_max)
    ldc = 1 if kb == 1 else kb + 1
    assert (n_max * ldc + kb * K8_TILE) * 8 <= K8_SMEM
    wider = [w for w in (32, 8) if w > kb]
    assert all((n_max * (w + 1) + w * K8_TILE) * 8 > K8_SMEM for w in wider)


def test_k8_refuses_a_component_past_its_panel():
    with pytest.raises(ValueError, match="more than K8 holds"):
        k8_panel(K8_SMEM // 8 - K8_TILE + 1)


def test_k8_is_built_and_cpu_tensors_launch_nothing():
    """K8 is registered for the build with its source note, and a build on
    CPU tensors runs the plain version without counting a launch."""
    src = (cuda.CSRC / "macro_chain.cu").read_text()
    assert "macro_chain" in cuda.KERNELS
    assert "macro_atom_solver.py:389" in src and ":404" in src
    assert "Bound on the H100: operations" in src
    beta, jb, stim, nu = cycle_rates()
    ctx = chain_context(cycle_macro(MacroAtomData), "macroatom", nu)
    before = (macro_chain.launches, dict(macro_chain.launches_by_variant))
    chain, emit = macro_chain(ctx, ctx.arrays("cpu"),
                              *(torch.as_tensor(t) for t in (beta, jb, stim)))
    assert chain.device.type == "cpu" and emit.dtype == torch.float32
    assert (macro_chain.launches,
            dict(macro_chain.launches_by_variant)) == before
