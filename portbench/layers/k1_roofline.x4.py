"""K1's share of its roofline in ``w7.converge.x4``, where it runs on all
four cards: the frozen bound (``bounds/k1_classic.py``) of an iteration's
packets and events at the four cards' peak (a quarter of one card's
bound), over the K1 phase's length on the host clock, from the first
shard's K1 start to the last shard's K1 end (the program's trace
recorder, each card's launch on its own anchors); the median over the
window's iterations."""

from portbench import cards
from portbench.bounds import k1_classic

NAME = "k1_roofline.x4"
UNIT = "%"
LAYER = "event loop"
MOVES = "packets_per_s"
WORKLOADS = ("w7.converge.x4",)


def read(ctx):
    recs = cards.records()
    if recs is None:
        return None
    its = cards.sharded(recs)
    b = ctx["bounds"]
    if not its or len(its) != len(b["k1_events"]):
        return None
    shares = []
    for (k1, _), events in zip(its, b["k1_events"]):
        phase_ns = max(x.end_ns for x in k1) - min(x.start_ns for x in k1)
        bound = k1_classic.bound_s(b["k1_packets"], events) / b["k1_cards"]
        shares.append(100.0 * bound / (phase_ns * 1e-9))
    return cards.median(shares)
