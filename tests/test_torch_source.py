"""Port packet source (K2's plain version) against the JAX blackbody pool;
the wrapper's copies and cache; the SASS count behind K2's bound in
``chip_smoke.py``."""

import jax
import numpy as np
import pytest
import torch

from tardis_torch.transport import rng, source
from tardis_torch.transport.source import blackbody_source
from tardis_tpu.transport.source import sample_blackbody_packets

torch.set_num_threads(2)

N = 4096


@pytest.mark.parametrize("seed,iteration,t_inner", [
    (23, 0, 10102.0), (23111963, 3, 9000.0), (2**32 - 1, 1, 14500.0),
])
def test_pool_matches_jax(seed, iteration, t_inner):
    """Same threefry bits; mu and nu differ at most by libm ulps."""
    jkey = jax.random.fold_in(jax.random.key(np.uint32(seed)), 2 * iteration)
    mu_j, nu_j = (np.asarray(a) for a in
                  sample_blackbody_packets(jkey, N, t_inner))
    key = rng.fold_in(rng.key(seed), 2 * iteration)
    mu, nu, w = blackbody_source(key, N, t_inner, "cpu")
    assert mu.dtype == nu.dtype == torch.float32 and w is None
    np.testing.assert_allclose(mu.numpy(), mu_j, rtol=1e-6)
    np.testing.assert_allclose(nu.numpy(), nu_j, rtol=1e-6)
    assert not blackbody_source.launches_by_variant  # CPU tensors never launch


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        blackbody_source(rng.key(1), 8, 1e4, "meta")


def _kernel_order_sum(w):
    """K2's weighted-pool sum as the kernel takes it, loop for loop in
    numpy: 256 threads a block, a thread's 8 packets of a 2,048-packet
    chunk folded by halves, the block's threads by halves into the chunk's
    slot; then each thread's residue class of slots folded through a
    binary-counter stack in bit-reversed order, and the threads by halves."""
    T, C = source.FOLD_WIDTH, source.WEIGHTED_CHUNK
    n = len(w)
    n_chunks = max(1, -(-n // C))
    x = np.zeros(n_chunks * C)
    x[:n] = w
    v = x.reshape(n_chunks, C // T, T)  # [chunk, i, t]: pid c*C + i*T + t

    def fold_threads(s):
        while s.shape[-1] > 1:
            h = s.shape[-1] // 2
            s = s[..., :h] + s[..., h:]
        return s[..., 0]

    while v.shape[1] > 1:
        h = v.shape[1] // 2
        v = v[:, :h] + v[:, h:]
    slots = fold_threads(v[:, 0, :])
    q = 0
    while (T << q) < n_chunks:
        q += 1
    stack = []
    for k in range(1 << q):
        i = int(format(k, f"0{q}b")[::-1], 2) if q else 0
        j = np.arange(T) + T * i
        val = np.where(j < n_chunks, slots[np.minimum(j, n_chunks - 1)], 0.0)
        c = k
        while c & 1:
            val = stack.pop() + val
            c >>= 1
        stack.append(val)
    return fold_threads(stack[0])


@pytest.mark.parametrize("n", [1, 2047, 2048 * 5 + 777, 2048 * 300 + 5,
                               2048 * 1100 + 1])
def test_fixed_order_sum_is_the_kernels_order(n):
    """The plain fold equals the kernel's loops bit for bit, past one
    chunk, past 256 chunks (a thread folds two slots) and past 1,024
    (eight slots a thread, three bit-reversed levels); the values span
    four decades, so a change of order shows in the last bits."""
    g = np.random.default_rng(n)
    w = g.uniform(0.0, 1.0, n) * 10.0 ** g.uniform(-2, 2, n)
    got = source.fixed_order_sum(torch.as_tensor(w)).item()
    assert got == _kernel_order_sum(w)
    assert got == pytest.approx(w.sum(), rel=1e-12)


def test_weighted_mean_is_the_fixed_order_sum(monkeypatch):
    """At a size that is no multiple of the chunk the plain weighted pool
    divides by f32(fixed_order_sum / n), bitwise, and its weights average
    to 1."""
    n = 2048 * 3 + 1001
    seen = []
    real = source.fixed_order_sum

    def spy(w):
        seen.append(w.clone())
        return real(w)

    monkeypatch.setattr(source, "fixed_order_sum", spy)
    mu, nu, w = blackbody_source(rng.key(5), n, 11000.0, "cpu", "weighted")
    (raw,) = seen
    total = _kernel_order_sum(raw.double().numpy())
    mean = torch.tensor(total / n, dtype=torch.float64).float()
    assert torch.equal(w, raw / mean)
    assert abs(w.double().mean().item() - 1.0) < 1e-6


class _MetaTorch:
    """``torch`` with every allocation on the meta device, counting the
    calls that would copy from the host."""

    def __init__(self):
        self.copies = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def empty(self, *shape, device=None, **kw):
        return torch.empty(*shape, device="meta", **kw)

    def _copy(self, name, data, **kw):
        self.copies.append(name)
        return torch.empty(len(data), device="meta")

    def as_tensor(self, data, device=None, **kw):
        return self._copy("as_tensor", data)

    def tensor(self, data, device=None, **kw):
        return self._copy("tensor", [data])

    def zeros(self, *shape, device=None, **kw):
        self.copies.append("zeros")
        return torch.empty(*shape, device="meta", **kw)


def test_wrapper_copies_nothing_after_a_devices_first_call(monkeypatch):
    """On a CUDA device the wrapper copies the l-table once and then only
    allocates and launches: three calls of each pool, one launch a call
    with the C function's arguments, and one host copy in all (the
    weighted pool reads no table)."""
    fake = _MetaTorch()
    calls = []

    def function(name, symbol, argtypes, defines=()):
        assert (name, symbol, argtypes) == ("blackbody_source",
                                            "blackbody_source",
                                            source.ARGTYPES)

        def fn(*args):
            assert len(args) == len(argtypes)
            calls.append(args)
            return 0
        return fn

    monkeypatch.setattr(source, "torch", fake)
    monkeypatch.setattr(source, "_L_TABLES", {})
    monkeypatch.setattr(source.cuda, "function", function)
    monkeypatch.setattr(source.cuda, "stream", lambda: 0)
    monkeypatch.setattr(blackbody_source, "launches_by_variant", {})
    n = 2048 * 2 + 3
    for pool in ("weighted", "simple", "relativistic"):
        for _ in range(3):
            mu, nu, w = blackbody_source(rng.key(3), n, 1e4, "cuda:0", pool,
                                         0.03)
            assert mu.shape == nu.shape == (n,)
            assert (w is None) == (pool == "simple")
    assert fake.copies == ["as_tensor"]
    assert len(calls) == 9
    assert blackbody_source.launches_by_variant == {
        "simple": 3, "relativistic": 3, "weighted": 3}
    assert list(source._L_TABLES) == [torch.device("cuda:0")]


def test_l_table_follows_the_current_device(monkeypatch):
    """``cuda`` without an index is the current device, as the kernel's
    launch is: one table a card, each on the card that was current."""
    fake = _MetaTorch()
    current = [1]
    fake.cuda = type("cuda", (), {
        "current_device": staticmethod(lambda: current[0])})
    monkeypatch.setattr(source, "torch", fake)
    monkeypatch.setattr(source, "_L_TABLES", {})
    a = source.l_table("cuda")
    assert source.l_table("cuda:1") is a
    current[0] = 0
    b = source.l_table(torch.device("cuda"))
    assert b is not a and source.l_table("cuda:0") is b
    assert fake.copies == ["as_tensor", "as_tensor"]
    assert sorted(map(str, source._L_TABLES)) == ["cuda:0", "cuda:1"]


SASS = """
\tcode for sm_90a
\t\tFunction : {name}
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;              /* 0x0000000000007919 */
        /*0020*/                   ISETP.GE.AND P0, PT, R0, UR4, PT ;
        /*0030*/               @P0 EXIT ;
        /*0040*/                   IMAD.MOV.U32 R2, RZ, RZ, RZ ;
        /*0050*/                   LDG.E R3, desc[UR4][R4.64] ;
        /*0060*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0070*/                   ISETP.GE.AND P1, PT, R2, R5, PT ;
        /*0080*/              @!P1 BRA 0x50 ;
        /*0090*/                   SHF.L.W.U32.HI R7, R6, 0xd, R6 ;
        /*00a0*/              @!P2 BRA 0xe0 ;
        /*00b0*/                   DFMA R8, R8, R8, R8 ;
        /*00c0*/                   DFMA R8, R8, R8, R8 ;
        /*00d0*/                   MUFU.RSQ R6, R6 ;
        /*00e0*/                   LOP3.LUT R6, R2, R3, RZ, 0x3c, !PT ;
        /*00f0*/                   STG.E desc[UR4][R8.64], R6 ;
        /*0100*/                   STG.E.64 desc[UR4][R12.64], R8 ;
        /*0110*/                   FFMA R6, R6, R6, R6 ;
        /*0120*/                   STG.E desc[UR4][R10.64], R6 ;
        /*0130*/                   EXIT ;
        /*0140*/                   BRA 0x140;
        /*0150*/                   NOP;
"""


def test_sass_path_counts():
    """The packet's cheapest path through its stores, less the idle
    thread's (up to the predicated exit), with the loop at its turns: the
    branch around the f64 work is taken, the f64 store is not required."""
    import chip_smoke as cs

    (code,) = cs.sass_functions(SASS.format(name="_Z1kv")).values()
    assert len(code) == 22 and code[3][1:3] == (True, "EXIT")
    once, passes = cs.sass_path_counts(code)
    # 0-10 (the branch included), 14-19 (the exit included): 17; the idle
    # thread's 0-3: 4
    assert once["issue"] == 17 - 4 and passes == "loads and stores"
    thrice, _ = cs.sass_path_counts(code, loop_trips=3)
    assert thrice["issue"] == once["issue"] + 2 * 4
    assert thrice["alu"] == 4 + 2 * 2  # ISETP, IADD3, ISETP, SHF, LOP3 - 1
    assert thrice["fmaheavy"] == 1 and thrice["fma"] == 2
    assert thrice["fp64"] == 0 and thrice["xu"] == 0


def test_sass_bound_terms():
    import chip_smoke as cs

    per = {"issue": 128.0, "alu": 96.0, "fmaheavy": 0.0, "fma": 0.0,
           "fp64": 0.0, "xu": 0.0}
    n = cs.RATES.sms * int(cs.RATES.sm_clock_hz) // 1000
    ms, by, terms = cs.sass_bound(0, n, per)
    assert by == "operations" and terms["issue"] == pytest.approx(1.0)
    assert ms == terms["alu"] == pytest.approx(1.5)


@pytest.mark.parametrize("n", [1, 2, 7, 999, 1000])
def test_search_min_trips(n):
    """The fewest turns of a left bisection over n entries, as K2's loop
    takes them: floor(log2(n + 1)) ... ceil(log2(n + 1))."""
    import chip_smoke as cs

    assert cs.search_min_trips(n) == (n + 1).bit_length() - 1


def test_event_loops_times_every_k2_pool():
    """The two-tree benchmark's K2 cases: each pool at the paths' three
    shapes, the final shape with the last iteration's key, timed by this
    checkout's chip_smoke whichever tree runs."""
    import chip_smoke as cs
    from tardis_torch.benchmarks import event_loops

    k2 = [c for c in event_loops.cases(cs) if c[1] == "k2"]
    assert [(c[0], c[2], c[3], c[4]) for c in k2] == [
        (f"k2 {p} {n}", p, n, cs.ITERATIONS - 1 if n == cs.FINAL_PACKETS
         else 0) for p in source.POOLS for n in cs.K2_SHAPES]
    assert event_loops.K2_SHAPES == cs.K2_SHAPES
    timing = event_loops.this_checkout_smoke()
    assert timing.K2_KERNELS == cs.K2_KERNELS and callable(timing.k2_timings)


def test_sass_path_passes_the_loads():
    """A branch around a load is not the packet's path: with the load
    required the path takes it, and where no path passes every load and
    store (a load on one side, a store on the other) the stores alone
    decide."""
    import chip_smoke as cs

    text = SASS.format(name="_Z1kv").replace(
        "@!P2 BRA 0xe0", "@!P2 BRA 0xe0").replace(
        "MUFU.RSQ R6, R6", "LDG.E R6, desc[UR4][R6.64]")
    (code,) = cs.sass_functions(text).values()
    counts, passes = cs.sass_path_counts(code)
    assert passes == "loads and stores" and counts["issue"] == 13 + 3
    assert counts["fp64"] == 2
    text = """\t\tFunction : _Z1kv
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/               @P1 EXIT ;
        /*0020*/               @P0 BRA 0x50 ;
        /*0030*/                   LDG.E R1, desc[UR4][R2.64] ;
        /*0040*/                   BRA 0x60 ;
        /*0050*/                   STG.E desc[UR4][R2.64], R1 ;
        /*0060*/                   STG.E desc[UR4][R4.64], R1 ;
        /*0070*/                   EXIT ;
"""
    (code,) = cs.sass_functions(text).values()
    counts, passes = cs.sass_path_counts(code)
    assert counts["issue"] == 6 - 2
    assert passes == "stores"


def test_kernel_ms_makes_again_a_session_that_lost_records(monkeypatch,
                                                           capsys):
    """K2's kernel-alone time: a profiler session with 19 records of 20
    calls is made again, and the next whole one is read."""
    import json
    from types import SimpleNamespace

    import chip_smoke as cs

    sessions = iter([19, 20])
    cuda = torch.autograd.DeviceType.CUDA

    class Profile:
        def __init__(self, activities):
            self.n = next(sessions)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return [None] * self.n

        def key_averages(self):
            return [SimpleNamespace(
                key="void (anonymous namespace)::weighted_pool_kernel(P)",
                device_type=cuda, self_device_time_total=40.0 * self.n,
                count=self.n)]

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    ms, launches, other_ms, other_n = cs.kernel_ms(lambda: None, 20,
                                                   cs.K2_KERNELS)
    assert (ms, launches, other_ms, other_n) == (0.04, 1.0, 0.0, 0.0)
    lost = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [(d["phase"], d["records"]) for d in lost] == [
        ("kernel_ms_lost_records", 19)]
