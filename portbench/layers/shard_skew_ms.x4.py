"""How far the shards' K1 launches end apart in ``w7.converge.x4``: the
last shard's K1 end minus the first's, on the host clock (the program's
trace recorder, each card's launch on its own anchors); the median over
the window's iterations.  The reduce waits for the last shard."""

from portbench import cards

NAME = "shard_skew_ms.x4"
UNIT = "ms"
LAYER = "shards"
MOVES = "packets_per_s"
WORKLOADS = ("w7.converge.x4",)


def read(ctx):
    recs = cards.records()
    if recs is None:
        return None
    return cards.median([
        1e-6 * (max(x.end_ns for x in k1) - min(x.end_ns for x in k1))
        for k1, _ in cards.sharded(recs)])
