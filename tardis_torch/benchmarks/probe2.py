"""Second profiling probe: scatter scaling, large gathers, the three probe
kernels.

Counterpart of ``tardis_tpu/benchmarks/probe2.py``, whose Pallas kernels
become the hand-written kernels of ``csrc/probe2.cu``:

- ``scale2(x)`` = 2 x (``kern``, the probe's VMEM round trip);
- ``take_1d(tab, idx)`` = tab[idx] (``gkern``);
- ``take_along_rows(tab, idx)`` = take_along_dim(tab, idx, 1) on (R, 128)
  rows (``gkern2``).

Each wrapper launches its kernel for tensors on the card and runs its
plain PyTorch version (``*_plain``, one library call) only for CPU
tensors.  Indices are int32 and must lie inside the table: the plain
versions raise on one outside, the kernels give NaN for it.

``main()`` prints the JAX probe's JSON lines under its keys, timed with
CUDA events on the card (the least of five runs after a warm-up, as the
JAX probe takes the least of five): scatter-adds into a (183,061 x 20, 2)
f32 table, scalar and row gathers, the chain-row gather, the two-level row
search and a 100-step trivial loop, all torch ops; then ``scale2`` over
16 to 120 MB with each size's time (``vmem_roundtrip_ok_mb``: the largest
size whose result equals 2 x bit for bit), and ``take_1d`` /
``take_along_rows`` at the JAX probe's shapes ("ok" when bitwise equal to
the plain version).  Usage, on a card: ``python -m
tardis_torch.benchmarks.probe2``.
"""

from __future__ import annotations

import ctypes
import json

import torch

from tardis_torch import cuda

ROW = 128  # take_along_rows' row length
LP1S = 183061 * 20
VMEM_MB = (16, 32, 64, 96, 120)
SECTOR = 32  # bytes a scattered read moves from device memory


def scale2_plain(x: torch.Tensor) -> torch.Tensor:
    return 2 * x


def take_1d_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return tab[idx]


def take_along_rows_plain(tab: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    return torch.take_along_dim(tab, idx.long(), 1)


def table_sectors(tab: torch.Tensor, idx: torch.Tensor) -> int:
    """The distinct 32-byte sectors of the 1-D table ``tab`` that the
    indices ``idx`` touch, where the table's first entry sits in its
    sector counted: what a gather must read at the least."""
    per = SECTOR // tab.element_size()
    first = (tab.data_ptr() % SECTOR) // tab.element_size()
    return int(torch.unique((idx.long() + first) // per).numel())


def take_1d_bytes(tab: torch.Tensor, idx: torch.Tensor) -> int:
    """Bytes ``take_1d`` must move: each sector of the table it touches
    once, the indices read once and the output written once."""
    return (SECTOR * table_sectors(tab, idx)
            + idx.numel() * (idx.element_size() + tab.element_size()))


def _launch(name, *args):
    fn = getattr(cuda.library("probe2"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int64 if isinstance(a, int) else ctypes.c_void_p
                   for a in args] + [ctypes.c_void_p]
    cuda.check_launch(name, fn(*args, cuda.stream()))


def _device(name, t: torch.Tensor) -> bool:
    """True for a card (launch the kernel), False for the CPU (the plain
    version); raise for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def scale2(x: torch.Tensor) -> torch.Tensor:
    """2 x of an f32 tensor of any shape: the kernel on the card."""
    if not _device("scale2", x):
        return scale2_plain(x)
    cuda.check_cuda("scale2", x.device, x=(x, torch.float32))
    out = torch.empty_like(x)
    _launch("scale2", cuda.ptr(x), cuda.ptr(out), x.numel())
    scale2.launches += 1
    return out


def take_1d(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tab[idx] for a 1-D f32 table and int32 indices of any shape."""
    if not _device("take_1d", tab):
        return take_1d_plain(tab, idx)
    cuda.check_cuda("take_1d", tab.device, tab=(tab, torch.float32),
                    idx=(idx, torch.int32))
    if tab.dim() != 1:
        raise ValueError("take_1d: the table must be 1-D")
    out = torch.empty(idx.shape, dtype=torch.float32, device=tab.device)
    _launch("take_1d", cuda.ptr(tab), tab.numel(), cuda.ptr(idx),
            cuda.ptr(out), idx.numel())
    take_1d.launches += 1
    return out


def take_along_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_dim(tab, idx, 1) for (R, 128) f32 rows and int32 column
    indices (R, 128)."""
    if not _device("take_along_rows", tab):
        return take_along_rows_plain(tab, idx)
    cuda.check_cuda("take_along_rows", tab.device, tab=(tab, torch.float32),
                    idx=(idx, torch.int32))
    if (tab.dim() != 2 or tab.shape[1] != ROW or idx.shape != tab.shape
            or tab.data_ptr() % 16 or idx.data_ptr() % 16):
        raise ValueError(f"take_along_rows: tab and idx must be (R, {ROW}) "
                         "and 16-byte aligned")
    out = torch.empty_like(tab)
    _launch("take_along_rows", cuda.ptr(tab), cuda.ptr(idx), cuda.ptr(out),
            tab.shape[0])
    take_along_rows.launches += 1
    return out


scale2.launches = 0
take_1d.launches = 0
take_along_rows.launches = 0


def min_ms(fn, *args, n=5):
    """The least CUDA-event milliseconds of ``n`` runs after a warm-up."""
    fn(*args)
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return min(times)


class Results(dict):
    """Prints each result as one JSON line when it is set."""

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        print(json.dumps({key: value}), flush=True)


def main(device=None) -> dict:
    """Run the probe on the card (``device``: the current one by default)
    and return its results."""
    device = cuda.resolve_device(device)
    if device.type != "cuda":
        raise ValueError("the probe times with CUDA events: it runs on a "
                         "card")
    gen = torch.Generator(device=device).manual_seed(7)

    def randint(high, n):
        return torch.randint(0, high, (n,), generator=gen, device=device)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=device)

    results = Results()
    with torch.no_grad(), torch.cuda.device(device):
        # scatter-add cost against the number of updates
        target = torch.zeros((LP1S, 2), device=device)
        for nup in (262144, 1048576, 4194304):
            results[f"scatter_add_{nup}_ms"] = min_ms(
                lambda t, i, v: t.index_add(0, i, v), target,
                randint(LP1S, nup), uniform(nup, 2))
        nup = 262144
        results["scatter_add_sorted_262k_ms"] = min_ms(
            lambda t, i, v: t.index_add(0, i, v), target,
            torch.sort(randint(LP1S, nup)).values, uniform(nup, 2))
        results["scatter_add_1d_262k_ms"] = min_ms(
            lambda t, i, v: t.index_add(0, i, v),
            torch.zeros(LP1S, device=device), randint(LP1S, nup),
            uniform(nup))

        # gathers against the batch size
        big = uniform(12_000_000)
        for B in (131072, 1048576):
            results[f"scalar_gather_B{B}_ms"] = min_ms(
                lambda i: big[i], randint(big.shape[0], B))
        rows = uniform(28620, ROW)
        for B in (131072, 1048576):
            results[f"row_gather_B{B}_ms"] = min_ms(
                lambda i: rows[i].sum(dim=1), randint(rows.shape[0], B))
        # the absorbing-chain table: (S * M, Mpad) = (72,000, 3,712) as
        # 128-wide rows, ~1.07 GB
        chain = uniform(72000 * (3712 // ROW), ROW)
        B = 131072
        results[f"chain_row_gather_B{B}_ms"] = min_ms(
            lambda i: chain[i].sum(dim=1), randint(chain.shape[0], B))
        summ = uniform(72000, ROW)

        def two_level(ridx, u):
            w = (summ[ridx] < u[:, None]).sum(dim=1)
            r2 = chain[torch.clamp(ridx * 29 + w, 0, chain.shape[0] - 1)]
            return (r2 < u[:, None]).sum(dim=1)

        results["two_level_rowsearch_ms"] = min_ms(
            two_level, randint(72000, B), uniform(B))

        def loop(x):
            for _ in range(100):
                x = x * 1.000001 + 1e-9
            return x

        results["while100_trivial_ms"] = min_ms(loop, uniform(131072))

        # the probe kernels
        ok_mb = 0
        for mb in VMEM_MB:
            x = uniform(mb * 1024 * 1024 // 4 // ROW, ROW)
            results[f"scale2_{mb}mb_ms"] = min_ms(scale2, x)
            if not torch.equal(scale2(x), scale2_plain(x)):
                break
            ok_mb = mb
            del x
        results["vmem_roundtrip_ok_mb"] = ok_mb
        tab = uniform(4096)
        idx = randint(4096, 1024).int()
        results["pallas_take_1d"] = (
            "ok" if torch.equal(take_1d(tab, idx), take_1d_plain(tab, idx))
            else "fail: differs from tab[idx]")
        tab = uniform(1024, ROW)
        idx = torch.randint(0, ROW, (1024, ROW), generator=gen,
                            device=device, dtype=torch.int32)
        results["pallas_take_along_lanes"] = (
            "ok" if torch.equal(take_along_rows(tab, idx),
                                take_along_rows_plain(tab, idx))
            else "fail: differs from take_along_dim")
    print(json.dumps(results, indent=1), flush=True)
    return dict(results)


if __name__ == "__main__":
    main()
