"""Host-device synchronizations of an iteration in ``w7.converge``: the
program's ``syncs`` counter (each blocking copy, ``.item()`` or
synchronize on the cell's path goes through ``tracing.sync``) of each of
the window's iterations, the median over them: a steady iteration's
count, the same in every run (a model's start adds its uploads to the
iteration before it)."""

from portbench import recorder

NAME = "syncs.converge"
UNIT = "syncs"
LAYER = "orchestration"
MOVES = "packets_per_s"
WORKLOADS = ("w7.converge",)


def read(ctx):
    recs = recorder.records()
    if recs is None:
        return None
    return recorder.median_by_iteration(recs, "syncs",
                                        "tardis.transport_loop")
