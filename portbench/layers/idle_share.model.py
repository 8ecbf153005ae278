"""The share of the traced window in which the card runs nothing, in
``iip.model``: from the profiler's trace (the union of every kernel, copy
and set), or, where the trace holds fewer records of a kernel in
``COUNTED`` than the program counted launches, from CUDA event pairs
around every kernel wrapper (K1, K2, K3), which miss torch operations and
copies."""

NAME = "idle_share.model"
UNIT = "%"
LAYER = "device"
MOVES = "model_s"
WORKLOADS = ("iip.model",)
PROBES = (
    ("tardis_torch.transport.solver", "transport_loop", "k1", False),
    ("tardis_torch.transport.solver", "blackbody_source", "k2", False),
    ("tardis_torch.plasma.solver", "line_tables", "k3", False),
)
COUNTED = {
    "k1": ("tardis_torch.transport.kernel", "transport_loop",
           ("continuum_kernel",)),
    "k3": ("tardis_torch.plasma.line_tables", "line_tables",
           ("line_elements_kernel", "carry_kernel", "prefix_kernel")),
}


def read(ctx):
    from portbench.harness import busy_seconds

    trace = ctx["trace"]
    if not trace or trace["window_s"] <= 0:
        return None
    busy = busy_seconds(trace, ctx["probe"], ctx["lost"])
    return 100.0 * (1.0 - busy / trace["window_s"])
