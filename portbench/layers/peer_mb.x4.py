"""Megabytes queued between cards in an iteration of ``w7.converge.x4``:
the program's ``shard.peer_bytes`` counter (the transport tables and the
pool's slices sent to the other cards, their rows and sums gathered on
card 0) of each iteration that reduced shards, the median over them."""

from portbench import cards

NAME = "peer_mb.x4"
UNIT = "MB"
LAYER = "shards"
MOVES = "packets_per_s"
WORKLOADS = ("w7.converge.x4",)


def read(ctx):
    recs = cards.records()
    if recs is None:
        return None
    its = {s.iteration for s in recs["spans"]
           if s.name == "tardis.shard_reduce"}
    by = recs["by_iteration"]
    return cards.median([1e-6 * by[i]["shard.peer_bytes"] for i in its
                         if "shard.peer_bytes" in by.get(i, {})])
