"""The continuum K1's drain tail on the card (every test is marked ``card``
and skips without one; this file imports nothing of JAX, so the card's
machine runs it: ``python -m pytest --noconftest -m card
tests/test_torch_continuum_tail.py``).

The continuum loop hands the packets still walking, once the queue is
empty and few are live, to a second kernel that runs each on a whole
warp, and sums its moments from one private copy an SM.  Which kernel
runs a packet's events must change nothing but the order of the f64
sums: on ``chip_smoke.py``'s IIP problem (the JAX
package's: H / He, 20 shells, full relativity, L = 135, C = 10), runs
with every packet handed off at birth, with the hand-off midway and with
none give the same rows, event counts and totals, in each continuum
instantiation, and agree with the plain version.  The tail's searches
replay the plain version's bisection, also on a full-relativity line
search whose f32 predicate dips.
"""

import ctypes

import numpy as np
import pytest
import torch

import chip_smoke
from tardis_torch import cuda
from tardis_torch.transport import kernel as tk
from tardis_torch.transport.solver import iteration_keys
from tardis_torch.transport.source import blackbody_source
from tardis_torch.transport.tables import LINE_SCATTER, TransportTables

N = 4096
CAP = 2000  # events a packet: the plain check's cap (chip_smoke.IIP_EVENT_CAP)
RECORDS_N = 1024
PLAIN_CAP = 300  # the plain lockstep loop runs as many steps as this
SUM_RTOL = 1e-12
SUMS = ("est_j", "est_nubar", "est_ff_heat", "cont_moments")


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def problem():
    """The IIP problem's first-iteration tables, with and without the
    two-photon and adiabatic channels, and its relativistic pool."""
    device = card()
    state, atom = chip_smoke.build_iip_problem()
    src_key, run_key = iteration_keys(chip_smoke.SEED, 0)
    pool = blackbody_source(src_key, N, state.t_inner, device, "relativistic",
                            chip_smoke.beta_inner(state))
    return dict(tables=chip_smoke.iip_tables(state, atom, device),
                channels=chip_smoke.iip_tables(state, atom, device,
                                               channels=True),
                pool=pool, key=run_key)


def rel(a, b):
    scale = torch.maximum(a.abs(), b.abs())
    diff = (a - b).abs()
    return float(torch.where(scale > 0, diff / scale.clamp_min(1e-300),
                             diff).max()) if a.numel() else 0.0


def assert_same(a, b):
    """Two continuum runs that differ only in which kernel ran which
    events: rows, event counts and totals bitwise, the f64 sums within
    SUM_RTOL."""
    assert torch.equal(a.out, b.out)
    assert torch.equal(a.last_interaction, b.last_interaction)
    assert torch.equal(a.events, b.events)
    assert torch.equal(a.summary[2:4], b.summary[2:4])
    for name in SUMS:
        assert rel(getattr(a, name), getattr(b, name)) <= SUM_RTOL, name
    assert rel(a.summary[:2], b.summary[:2]) <= SUM_RTOL


def runs(tables, pool, key, n=N, **kw):
    """The same launch with the hand-off at birth, midway and never."""
    mu, nu, w = (x[:n] for x in pool)
    out = {}
    for name, threshold in (("birth", n), ("midway", n // 8), ("none", 0)):
        out[name] = tk.transport_loop(tables, mu, nu, key, max_events=CAP,
                                      pool_w=w, last_interaction=True,
                                      tail_threshold=threshold, **kw)
    torch.cuda.synchronize()
    return out


@pytest.mark.card
@pytest.mark.parametrize("case", ["iip", "channels", "device_tables"])
def test_tail_changes_no_packet(problem, case):
    """Every instantiation: the iip.model one (tables in shared memory),
    the two-photon and adiabatic channels, tables in device memory."""
    tables = problem["channels" if case == "channels" else "tables"]
    kw = {"smem_tables": False} if case == "device_tables" else {}
    r = runs(tables, problem["pool"], problem["key"], **kw)
    birth, midway, none = r["birth"], r["midway"], r["none"]
    assert int(birth.tail[0]) == N and int(none.tail[0]) == 0
    assert 0 < int(midway.tail[0]) <= N // 8
    assert int(birth.tail[1]) == int(birth.summary[2])
    assert 0 < int(midway.tail[1]) < int(midway.summary[2])
    assert int(birth.summary[3]) > 0  # the cap stops some walkers
    assert_same(birth, none)
    assert_same(midway, none)
    if case == "channels":
        adiabatic = (none.out[:, 0] < 0) & (none.out[:, 1] == 0)
        assert int(adiabatic.sum()) > 0


@pytest.mark.card
def test_tail_against_the_plain_version(problem):
    """The card's loop (the tail from midway, the moments summed from
    per-SM copies) against its plain version on the same packets, both
    stopped at PLAIN_CAP events: rows and event counts bitwise, the sums
    within SUM_RTOL."""
    n = 256
    mu, nu, w = (x[:n] for x in problem["pool"])
    kw = dict(pool_w=w, last_interaction=True, max_events=PLAIN_CAP)
    card_res = tk.transport_loop(problem["tables"], mu, nu, problem["key"],
                                 tail_threshold=n // 4, **kw)
    plain = tk.transport_loop_plain(problem["tables"], mu, nu,
                                    problem["key"], batch_size=n, **kw)
    assert int(card_res.tail[0]) > 0
    assert_same(card_res, plain)


@pytest.mark.card
def test_tail_records(problem):
    """The records instantiation, with room for every attempt: the
    attempts equal, every record the same multiset (slots race, so the
    order differs)."""
    n = RECORDS_N
    r = runs(problem["tables"], problem["pool"], problem["key"], n=n,
             vpacket_capacity=n * (CAP + 1))
    none = r["none"]
    assert int(none.vp_count[0]) <= none.vp_records.shape[0]

    def rows(res):
        x = res.vp_records[:res.n_vp_records].cpu().numpy()
        return x[np.lexsort(x.T[::-1])]

    for name in ("birth", "midway"):
        assert_same(r[name], none)
        assert int(r[name].vp_count[0]) == int(none.vp_count[0])
        np.testing.assert_array_equal(rows(r[name]), rows(none))


def _f32(x):
    return torch.tensor([x], dtype=torch.float32)


def _dips(n_wanted, seed=29, span=1 << 16):
    """Packet states (nu, z, p2) and line triples (a line 4,096 f32 steps
    above an f32 dip of the full-relativity resonance distance, then the
    dip's two lines), as tests/test_torch_event_loops.py finds them."""
    g = np.random.default_rng(seed)
    found = []
    for _ in range(256):
        nu = np.float32(g.uniform(0.3, 3.0))
        r = np.float32(g.uniform(0.02, 0.1))
        mu = np.float32(g.uniform(-1.0, 1.0))
        z = _f32(mu) * _f32(r)
        p2 = torch.clamp((_f32(r) * _f32(r)) * (1.0 - _f32(mu) * _f32(mu)),
                         min=0.0)
        top = np.float32(nu * (1.0 - float(z)) * g.uniform(0.8, 1.0))
        steps = np.arange(span + 4096, dtype=np.int32)
        lines = torch.as_tensor((np.int32(top.view(np.int32)) - steps).view(
            np.float32))
        s = tk._resonance_distance(lines, _f32(nu), z, p2, True)
        dip = torch.nonzero(s[4097:] < s[4096:-1])
        if dip.numel():
            i = 4096 + int(dip[0])
            found.append((_f32(nu), z, p2, lines[[i - 4096, i, i + 1]]))
        if len(found) == n_wanted:
            break
    return found


def tail_search(problem, rel_, line_nu=None, prefix=None, values=None, *,
                shell=None, lo, hi=None, u=None, chi=None, z=None, nu=None,
                tau_event=None, nu_thresh=None, p2=None):
    """The tail's searches on the card (csrc/transport_loop.cu
    ``tail_search``, in the IIP instantiation's library), one warp a
    state."""
    mu, _, w = problem["pool"]
    device = mu.device
    defines = tk.library_defines(tk.variant(problem["tables"], w,
                                            last_interaction=True))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    fn = cuda.function("transport_loop", "tail_search",
                       [ctypes.c_int, vp, vp, i64, vp, i64] + [vp] * 12,
                       defines)
    args = [None if x is None else x.to(device).contiguous()
            for x in (line_nu, prefix, values, shell, lo, hi, u, chi, z, nu,
                      tau_event, nu_thresh, p2)]
    out = torch.empty(lo.shape[0], dtype=torch.int64, device=device)
    L = 0 if line_nu is None else line_nu.shape[0]
    ptrs = [None if x is None else cuda.ptr(x) for x in args]
    cuda.check_launch("tail_search", fn(
        int(rel_), ptrs[0], ptrs[1], L, ptrs[2], lo.shape[0], *ptrs[3:],
        cuda.ptr(out), cuda.stream()))
    return out.cpu()


def bisect(values, lo, hi, u):
    """The plain bisection: first index of [lo, hi) the loop stops at, with
    right(i) = values[i] < u."""
    while lo < hi:
        mid = (lo + hi) >> 1
        if values[mid] < u:
            lo = mid + 1
        else:
            hi = mid
    return lo


@pytest.mark.card
def test_tail_search_replays_the_bisection(problem):
    """warp_bisect on values that are not sorted: ranges from empty to
    5,000 long (one round, or several rounds of five levels), the index
    the plain bisection stops at, not the first past u."""
    g = np.random.default_rng(5)
    values = g.random(6000).astype(np.float32)
    n = 2000
    lo = g.integers(0, 1000, n)
    hi = lo + np.concatenate([g.integers(0, 40, n // 2),
                              g.integers(0, 5000, n - n // 2)])
    u = g.random(n).astype(np.float32)
    got = tail_search(problem, False, values=torch.as_tensor(values),
                      lo=torch.as_tensor(lo), hi=torch.as_tensor(hi),
                      u=torch.as_tensor(u))
    want = [bisect(values, int(a), int(b), v) for a, b, v in zip(lo, hi, u)]
    assert got.tolist() == want
    first = [next((i for i in range(a, b) if values[i] >= v), b)
             for a, b, v in zip(lo, hi, u)]
    assert sum(x != y for x, y in zip(want, first)) > n // 4


@pytest.mark.card
def test_tail_search_on_an_f32_dip(problem):
    """The full-relativity line search where the f32 resonance distance
    dips (tests/test_torch_event_loops.py ``test_k1_guard_on_an_f32_dip``'s
    tables: one shell, chi 1, a line well above the dip, the dip's pair
    with no optical depth, then a thick line; tau_event at the pair's
    lower distance): the predicate fires on the pair's first line and not
    its second, and the tail's search must stop where the plain version's
    bisection of [0, L] does, at the thick line, not at the first line
    where the predicate turns true."""
    dips = _dips(8)
    assert len(dips) == 8
    for nu, z, p2, lines in dips:
        lines = torch.cat([lines, lines[2:] * 0.9])
        t = TransportTables(
            r_inner=_f32(0.01), r_outer=_f32(0.2), chi_e=_f32(1.0),
            line_nu=lines,
            prefix=torch.tensor([[0.0, 0.0, 0.0, 0.0, 100.0]],
                                dtype=torch.float64),
            line2macro=torch.zeros(4, dtype=torch.int32),
            chain_cdf=torch.zeros(1, 1), emit_cdf=torch.zeros(1, 3),
            mode=LINE_SCATTER, full_relativity=True)
        s = tk._resonance_distance(lines, nu, z, p2, True)
        assert s[0] < s[2] < s[1]
        chi, tau, thresh = _f32(1.0), s[2:3].clone(), lines[3:] * 0.5
        shell = lo = torch.zeros(1, dtype=torch.int64)
        plain = tk._search(t, shell, lo.clone(), chi, z, nu, tau, thresh,
                           torch.zeros(1, dtype=torch.float64), p2)
        assert int(plain) == 3
        got = tail_search(problem, True, lines, t.prefix, shell=shell, lo=lo,
                          chi=chi, z=z, nu=nu, tau_event=tau,
                          nu_thresh=thresh, p2=p2)
        assert int(got[0]) == 3
