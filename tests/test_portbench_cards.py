"""The benchmark's four-card cell ``w7.converge.x4`` on the CPU: its run
rehearsed on four CPU shards at a tiny size against the reference, and
each of its per-layer readers on records made by hand."""

import json
import subprocess
import sys
from collections import namedtuple

import pytest

from portbench import cards, recorder
from portbench.harness import ROOT, load_module
from tardis_torch import tracing
from tardis_torch.tracing import Launch, Span

CELL = "w7.converge.x4"
MS = 1_000_000  # ns


REHEARSAL = """
import copy, json, sys, time
from argparse import Namespace
import torch
torch.set_num_threads(2)
from portbench import harness
from portbench.harness import load_json
import tardis_torch.transport.solver as solver

cell = dict(load_json("traffic", "w7.converge.x4"), packets=4096,
            iterations_per_model=3)
config = copy.deepcopy(load_json("configs", cell["config"]))
config["atom_recipe"].update(n_levels=12, max_level_jump=None)
shards = []
original = solver.run_transport_sharded

def counted(tables, mu, nu, key, devices, **kw):
    shards.append(len(devices))
    return original(tables, mu, nu, key, devices, **kw)

solver.run_transport_sharded = counted
args = Namespace(workload="w7.converge.x4", seed=2**31 + 11, seconds=0.5,
                 trace=0)
result = harness.run_cell(args, cell, config, torch.device("cpu"),
                          time.time())
print(json.dumps(dict(result=result, shards=shards)))
"""


def test_rehearsal_on_four_cpu_shards_matches_reference():
    """The cell's entry kind hands the simulation four devices (the CPU four
    times here), every iteration shards, and the comparison passes; in a
    process of its own, which holds no JAX (the harness refuses one that
    does)."""
    out = subprocess.run([sys.executable, "-c", REHEARSAL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    run = json.loads(out.stdout.strip().splitlines()[-1])
    result = run["result"]
    assert result is not None, out.stderr[-4000:]
    assert result["correct"], result["compared"]
    assert result["failed"] == 0 and result["device"]["count"] == 4
    # two warm iterations, then every iteration of the window on 4 shards
    assert run["shards"] == [4] * (2 + result["attempted"])
    assert result["metrics"]["packets_per_s"]["value"] > 0


def k1(it, device, start, end):
    return Launch("transport_loop", "last_interaction+no_line_estimators",
                  start * MS, end * MS, device, it)


def reduce_(it, start, end):
    return Launch("_final_reduce", "shard_reduce", start * MS, end * MS, 0,
                  it)


# two iterations on four cards (ms): K1 ends 10, 20, 21, 22 and 40, 54,
# 51, 50; the reduces end at 25 and 58; the window is 0..60
RECORDS = dict(
    window=(0, 60 * MS),
    spans=[Span("tardis.shard_reduce", -1, 5 * MS, 6 * MS, 1, 0),
           Span("tardis.shard_reduce", -1, 35 * MS, 36 * MS, 2, 0)],
    launches=[k1(1, 0, 0, 10), k1(1, 1, 12, 20), k1(1, 2, 12, 21),
              k1(1, 3, 13, 22), reduce_(1, 5, 25),
              k1(2, 0, 30, 40), k1(2, 1, 42, 54), k1(2, 2, 42, 51),
              k1(2, 3, 43, 50), reduce_(2, 35, 58)],
    counters={}, by_iteration={1: {"shard.peer_bytes": 1_000_000_000},
                               2: {"shard.peer_bytes": 1_200_000_000}})
PACKETS, EVENTS = 1_000_000, 20_000_000
CTX = dict(bounds=dict(k1_packets=PACKETS, k1_events=[EVENTS, EVENTS],
                       k1_cards=4))


def k1_share():
    """K1's classic bound by hand: 40 ALU operations a hash, one hash a
    packet, two and a comparison an event, at 132 SMs x 64 lanes x 1.98
    GHz (the bytes, 40 a packet at 3.35 TB/s, take less), at four cards'
    peak, over K1's phases of 22 and 24 ms: the median of the two."""
    bound = (40 * PACKETS + 81 * EVENTS) / (132 * 64 * 1.98e9) / 4
    return 100 * (bound / 0.022 + bound / 0.024) / 2


@pytest.mark.parametrize("name,value", [
    ("k1_roofline.x4", k1_share()),
    ("shard_skew_ms.x4", (12 + 14) / 2),
    ("reduce_ms.x4", (3 + 4) / 2),
    ("peer_mb.x4", 1100.0),
    # idle ms of cards 0-3 (the reduce left out): 40, 40, 42, 44 of 60
    ("cards_idle_share.x4", 100 * (40 + 40 + 42 + 44) / (4 * 60)),
])
def test_layer_reads_hand_made_records(monkeypatch, name, value):
    monkeypatch.setattr(cards, "records", lambda: RECORDS)
    got = load_module("layers", name).read(CTX)
    assert got == pytest.approx(value, rel=1e-12)


@pytest.mark.parametrize("name", ["k1_roofline.x4", "shard_skew_ms.x4",
                                  "reduce_ms.x4", "peer_mb.x4",
                                  "cards_idle_share.x4"])
def test_layer_reads_nothing_from_a_one_anchor_recorder(monkeypatch, name):
    """A recorder whose launches carry no card (one anchor for every
    launch) is not asked for its records: each reader gives None."""
    def refused():
        raise AssertionError("records asked of a one-anchor recorder")

    monkeypatch.setattr(tracing, "Launch", namedtuple(
        "Launch", "kernel variant start_ns end_ns"))
    monkeypatch.setattr(recorder, "records", refused)
    assert load_module("layers", name).read(CTX) is None
