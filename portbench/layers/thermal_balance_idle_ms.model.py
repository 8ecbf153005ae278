"""The card's idle milliseconds a Type IIP thermal balance in
``iip.model``: idle under ``tardis.thermal_balance`` and its children
(scipy's least squares, each evaluation a plasma solve with K3, then the
plasma at its solution), from the program's trace recorder, over the
window's balances: idle is the complement of the hand-written kernels'
launch intervals (torch's fills and copies count as idle)."""

from portbench import recorder

NAME = "thermal_balance_idle_ms.model"
UNIT = "ms"
LAYER = "IIP workflow"
MOVES = "model_s"
WORKLOADS = ("iip.model",)


def read(ctx):
    recs = recorder.records()
    if recs is None:
        return None
    n = recorder.span_count(recs, "tardis.thermal_balance")
    if not n:
        return None
    from tardis_torch.tracing import idle_by_span

    idle = idle_by_span(recs, ("tardis.thermal_balance",))
    return 1e3 * idle.get("tardis.thermal_balance", 0.0) / n
