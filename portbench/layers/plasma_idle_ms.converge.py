"""The card's idle milliseconds an iteration in ``w7.converge`` while the
host solves the plasma (``tardis.plasma``: the host ionization balance
and K3's launch), from the program's trace recorder: idle is the
complement of the hand-written kernels' launch intervals (torch's fills
and copies count as idle)."""

from portbench import recorder

NAME = "plasma_idle_ms.converge"
UNIT = "ms"
LAYER = "plasma"
MOVES = "packets_per_s"
WORKLOADS = ("w7.converge",)


def read(ctx):
    recs = recorder.records()
    n = ctx["stats"]["iterations"]
    if recs is None or not n:
        return None
    from tardis_torch.tracing import idle_by_span

    idle = idle_by_span(recs, ("tardis.plasma",))
    return 1e3 * idle.get("tardis.plasma", 0.0) / n
