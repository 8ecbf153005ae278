"""The card's idle milliseconds an iteration in ``w7.converge`` while the
host reads K1's outputs back (``tardis.readback``), finalizes them
(``tardis.finalize``) and advances the field (``tardis.advance`` and its
children but the plasma solve), from the program's trace recorder: idle
is the complement of the hand-written kernels' launch intervals (torch's
fills and copies count as idle: about 0.25 s of a 30 s window on an
NVIDIA H100 80GB HBM3)."""

from portbench import recorder

NAME = "readback_idle_ms.converge"
UNIT = "ms"
LAYER = "finalize, field"
MOVES = "packets_per_s"
WORKLOADS = ("w7.converge",)
STAGES = ("tardis.readback", "tardis.finalize", "tardis.advance",
          "tardis.plasma")


def read(ctx):
    recs = recorder.records()
    n = ctx["stats"]["iterations"]
    if recs is None or not n:
        return None
    from tardis_torch.tracing import idle_by_span

    idle = idle_by_span(recs, STAGES)
    return 1e3 * sum(idle.get(s, 0.0) for s in STAGES[:3]) / n
