"""Per-card readings of the program's trace recorder in the cells that
shard an iteration's packets over several cards (``converge_cards``).

The recorder puts each launch on the host's clock; with several cards it
needs an anchor on each (a CUDA event cannot be timed against another
card's), and each launch records its card and iteration
(``tardis_torch.tracing.Launch.device``, ``.iteration``).  Where the
program's recorder has no such fields, ``records()`` returns None without
asking it: it would time every card's launches against card 0's anchor.
Every reader here returns None then, so a layer file that reads it reports
nothing rather than failing.
"""

import statistics

from portbench import recorder

K1 = "transport_loop"  # K1's launches, one a shard
REDUCE = "shard_reduce"  # the reduce's interval on card 0


def records():
    """The recorder's records of the last window, or None where the
    program does not place launches card by card."""
    try:
        from tardis_torch import tracing
    except ImportError:
        return None
    if "device" not in getattr(tracing.Launch, "_fields", ()):
        return None
    return recorder.records()


def sharded(recs) -> list:
    """[(K1 launches, reduce launches)] of each iteration whose K1 ran on
    more than one card, in iteration order."""
    by = {}
    for x in recs["launches"]:
        if x.kernel == K1:
            by.setdefault(x.iteration, ([], []))[0].append(x)
        elif x.variant == REDUCE:
            by.setdefault(x.iteration, ([], []))[1].append(x)
    return [by[i] for i in sorted(by)
            if len({x.device for x in by[i][0]}) > 1]


def median(values):
    return float(statistics.median(values)) if values else None
