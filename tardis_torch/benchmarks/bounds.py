"""The card's rates and the least time K1 could take on it.

Shared by ``chip_smoke.py`` and the benchmark harnesses
(``transport_bench.py``), so both charge K1 the same count.  A bound is
the larger of two times: the bytes a launch must move (each input read
once, each output written once) over the card's memory rate, and its
operations over the card's rate for their kind: float operations over
67 TFLOP/s (the H100 SXM's non-tensor f32 rate, an FMA counted as two;
f64 operations are counted against it too, which the card does not
exceed), integer operations (the threefry hashes, the searches' index
arithmetic and compares) over the card's SMs x 64 int32 lanes a clock x
its max SM clock.  The rates are passed in (``Rates``): the defaults are
an H100 SXM's, ``card_rates()`` reads the SMs and clock of the card at
hand.  Nothing here launches a kernel or needs a card but
``card_rates`` and ``card_line``.
"""

from __future__ import annotations

import math
import subprocess
from typing import NamedTuple

import torch

# one threefry2x32 hash: 20 rounds of an add, a rotate (one funnel
# shift) and an xor, and 6 key injections of two adds: integer operations
# (a rotate counted as a shift pair and an or, 120 a hash, put the
# relativistic pool's bound above its measured time at the integer rate)
THREEFRY_OPS = 72


class Rates(NamedTuple):
    """What a bound divides by.  The defaults are an H100 SXM's: HBM3 at
    3.35 TB/s, 67e12 f32 operations a second, 132 SMs at a max SM clock of
    1.98 GHz, each SM 64 int32 lanes a clock."""
    hbm_bytes_per_s: float = 3.35e12
    ops_per_s: float = 67e12  # f32 operations, an FMA counted as two
    int_ops_per_s: float = 132 * 64 * 1.98e9
    sms: int = 132
    max_sm_clock_mhz: float = 1980.0

    @property
    def sm_clock_hz(self) -> float:
        return self.max_sm_clock_mhz * 1e6

    def summary(self) -> dict:
        """The integer rate and what it was read from, and the float
        rate."""
        return dict(sms=self.sms, max_sm_clock_mhz=self.max_sm_clock_mhz,
                    int_ops_per_s=self.int_ops_per_s,
                    float_ops_per_s=self.ops_per_s)


def card_rates(device: int = 0) -> Rates:
    """``Rates`` with the integer rate, SMs and clock of card ``device``:
    its SMs x 64 int32 lanes a clock x its max SM clock (``nvidia-smi``
    clocks.max.sm)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    mhz = float(_smi(device, "clocks.max.sm", "nounits"))
    return Rates(int_ops_per_s=sms * 64 * mhz * 1e6, sms=sms,
                 max_sm_clock_mhz=mhz)


def card_line(device: int = 0) -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them."""
    return _smi(device, "name,power.limit")


def _smi(device: int, query: str, *fmt: str) -> str:
    lines = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}",
         "--format=" + ",".join(("csv", "noheader") + fmt)],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()
    return lines[device].strip()


def bound(n_bytes, n_ops, n_int_ops, rates: Rates):
    """Least ms for ``n_bytes`` of traffic, ``n_ops`` float and
    ``n_int_ops`` integer operations (hashes, searches): the larger of the
    bytes' time and each kind's time at its own rate, and which it was
    ("bytes" or "operations")."""
    t_bytes = n_bytes / rates.hbm_bytes_per_s * 1e3
    t_ops = max(n_ops / rates.ops_per_s,
                n_int_ops / rates.int_ops_per_s) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def k1_bound(tables, n_packets, n_events, rates: Rates, n_records=0,
             extra_bytes=0, line_estimators=True, walk_jumps=0):
    """Least time for K1: every table read once, outputs (spawn records and
    tracker rows included; the line difference array only with
    ``line_estimators``) written once, against the events' hashing,
    search and arithmetic.  Every event hashes at least twice (its key and
    the tau draw); interactions hash more, so counting two keeps the bound
    a lower bound.  With continuum, an event also searches the bound-free
    grid (~4 operations a probe), interpolates and sums the C continua (~8
    operations each) and adds eight moments (counted as 8 operations), and
    the continuum tables, moments, free-free heating and per-packet event
    counts are read or written once.  With the walk tables, the walk
    tables are read once and each of this run's ``walk_jumps`` jumps
    hashes once and bisects its level's block (~4 operations a probe,
    log2 of the mean block's width).  Hashes and searches are integer
    operations; the rest float.

    Classic, without continuum or walk: bytes 8 N + the tables + 8 N +
    8 (2 (L + 1) S + 2 S + 4) + 32 records, float operations 60 an event,
    integer operations 2 THREEFRY_OPS + 8 ceil(log2(L + 1)) an event."""
    t = tables
    in_bytes = 8 * n_packets + nbytes(
        t.r_inner, t.r_outer, t.chi_e, t.line_nu, t.prefix, t.line2macro,
        t.chain_cdf, t.emit_cdf)
    line_diff = 2 * (t.n_lines + 1) * t.n_shells if line_estimators else 0
    out_bytes = (8 * n_packets + 8 * (line_diff + 2 * t.n_shells + 4)
                 + 32 * n_records)
    per_event = 60
    int_per_event = (2 * THREEFRY_OPS
                     + 8 * math.ceil(math.log2(t.n_lines + 1)))
    n_int = 0
    c = t.continuum
    if c is not None:
        in_bytes += nbytes(*(v for v in vars(c).values()
                             if isinstance(v, torch.Tensor)))
        out_bytes += (8 * 8 * (c.n_grid - 1) * t.n_shells
                      + 8 * t.n_shells + 4 * n_packets)
        per_event += 8 * c.n_continua + 8
        int_per_event += 4 * math.ceil(math.log2(c.n_grid))
    if t.walk is not None:
        w = t.walk
        in_bytes += nbytes(*w)
        mean_block = w.dest.shape[0] / max(1, w.block_start.shape[0] - 1)
        n_int += walk_jumps * (THREEFRY_OPS + 4 * max(
            1, math.ceil(math.log2(mean_block))))
    return bound(in_bytes + out_bytes + extra_bytes, n_events * per_event,
                 n_events * int_per_event + n_int, rates)


def lane_efficiency(events, width=32):
    """Events over the lane-events a layout of one thread a packet spends:
    sum of the packets' event counts over sum, over groups of ``width``
    consecutive packets (a warp), of ``width`` times the group's longest."""
    e = events.double()
    pad = (-e.numel()) % width
    groups = torch.cat([e, e.new_zeros(pad)]).view(-1, width)
    return (e.sum() / (width * groups.max(dim=1).values.sum())).item()
