"""The four cards' idle share in ``w7.converge.x4``: for each card, the
share of the traced window in which it runs none of the program's
recorded kernel launches (the recorder's launch intervals, each card's on
its own anchors; the reduce's interval on card 0 is left out, since it
holds card 0's wait for the other shards), the mean over the cards."""

from portbench import cards

NAME = "cards_idle_share.x4"
UNIT = "%"
LAYER = "device"
MOVES = "packets_per_s"
WORKLOADS = ("w7.converge.x4",)


def read(ctx):
    recs = cards.records()
    if recs is None or not recs["launches"]:
        return None
    from tardis_torch.tracing import idle_gaps

    kernels = dict(recs, launches=[x for x in recs["launches"]
                                   if x.variant != cards.REDUCE])
    t0, t1 = recs["window"]
    n = ctx["bounds"]["k1_cards"]
    idle = [sum(b - a for a, b in idle_gaps(kernels, d)) for d in range(n)]
    return 100.0 * sum(idle) / (n * (t1 - t0))
