"""The reduce's milliseconds in ``w7.converge.x4``: from the last shard's
K1 end to the end of the reduce's interval on card 0 (the peer copies of
the shards' rows and sums and the f64 adds in shard order; the program's
trace recorder, each card's launch on its own anchors); the median over
the window's iterations."""

from portbench import cards

NAME = "reduce_ms.x4"
UNIT = "ms"
LAYER = "shards"
MOVES = "packets_per_s"
WORKLOADS = ("w7.converge.x4",)


def read(ctx):
    recs = cards.records()
    if recs is None:
        return None
    return cards.median([
        1e-6 * (max(x.end_ns for x in red) - max(x.end_ns for x in k1))
        for k1, red in cards.sharded(recs) if red])
