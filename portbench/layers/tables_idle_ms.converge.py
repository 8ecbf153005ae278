"""The card's idle milliseconds an iteration in ``w7.converge`` while the
host builds the transport tables (``tardis.transport_tables``: five
blocking uploads) and queues K2 (``tardis.packet_source``), from the
program's trace recorder: idle is the complement of the hand-written
kernels' launch intervals (torch's fills and copies count as idle)."""

from portbench import recorder

NAME = "tables_idle_ms.converge"
UNIT = "ms"
LAYER = "source"
MOVES = "packets_per_s"
WORKLOADS = ("w7.converge",)
STAGES = ("tardis.transport_tables", "tardis.packet_source")


def read(ctx):
    recs = recorder.records()
    n = ctx["stats"]["iterations"]
    if recs is None or not n:
        return None
    from tardis_torch.tracing import idle_by_span

    idle = idle_by_span(recs, STAGES)
    return 1e3 * sum(idle.get(s, 0.0) for s in STAGES) / n
