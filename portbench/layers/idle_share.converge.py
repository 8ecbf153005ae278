"""The share of the traced window in which the card runs nothing, in
``w7.converge``: from the profiler's trace (the union of every kernel,
copy and set), or, where the trace holds fewer records of a kernel in
``COUNTED`` than the program counted launches, from CUDA event pairs
around every kernel wrapper (K1, K2, K3, K8), which miss torch operations
and copies."""

NAME = "idle_share.converge"
UNIT = "%"
LAYER = "device"
MOVES = "packets_per_s"
WORKLOADS = ("w7.converge",)
PROBES = (
    ("tardis_torch.transport.solver", "transport_loop", "k1", False),
    ("tardis_torch.transport.solver", "blackbody_source", "k2", False),
    ("tardis_torch.plasma.solver", "line_tables", "k3", False),
    ("tardis_torch.transport.solver", "solve_macro_chain", "k8", False),
)
# the kernels whose records the trace must hold, one for each launch the
# program counts: (module, function with ``launches_by_variant``, names
# of the kernels' records)
COUNTED = {
    "k1": ("tardis_torch.transport.kernel", "transport_loop",
           ("transport_loop_kernel",)),
    "k8": ("tardis_torch.opacities.macro_atom_solver", "macro_chain",
           ("chain_cluster_kernel", "chain_large_kernel",
            "workspace_kernel")),
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
