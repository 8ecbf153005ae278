"""The Type IIP thermal balance's host milliseconds a call in
``iip.model``: each call of ``TypeIIPWorkflow.solve_thermal_balance``
(scipy's least squares, each evaluation a plasma solve with K3's line
tables and a continuum state, then the plasma of its result) between two
synchronizations, averaged over the window."""

NAME = "thermal_balance_ms.model"
UNIT = "ms"
LAYER = "IIP workflow"
MOVES = "model_s"
WORKLOADS = ("iip.model",)
PROBES = (("tardis_torch.workflows.type_iip",
           "TypeIIPWorkflow.solve_thermal_balance", "balance", True),)


def read(ctx):
    ms = ctx["probe"].host.get("balance") or []
    return sum(ms) / len(ms) if ms else None
