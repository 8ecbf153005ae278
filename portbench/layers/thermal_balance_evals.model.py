"""Residual evaluations of a Type IIP thermal balance in ``iip.model``:
the program's ``thermal_balance.evaluations`` counter (each evaluation a
plasma solve with K3 and a continuum-state update) of each of the
window's balances (one an iteration, ``tardis.thermal_balance``), the
median over them."""

from portbench import recorder

NAME = "thermal_balance_evals.model"
UNIT = "evaluations"
LAYER = "IIP workflow"
MOVES = "model_s"
WORKLOADS = ("iip.model",)


def read(ctx):
    recs = recorder.records()
    if recs is None:
        return None
    return recorder.median_by_iteration(recs, "thermal_balance.evaluations",
                                        "tardis.thermal_balance")
