"""K8's share of its roofline in ``w7.converge`` from K8's own launches:
the frozen bound of a build (``bounds/k8_chain.py``, the inputs of
``k8_roofline.converge``) times the window's builds (``tardis.macro_chain``
spans), over the device time of K8's launch intervals in the program's
trace recorder (CUDA events around each launch, without the wrapper's
host and torch work that ``k8_roofline.converge``'s events hold)."""

from portbench import recorder
from portbench.bounds import k8_chain

NAME = "k8_launch_roofline.converge"
UNIT = "%"
LAYER = "macro atom"
MOVES = "packets_per_s"
WORKLOADS = ("w7.converge",)


def read(ctx):
    recs = recorder.records()
    if recs is None:
        return None
    ns = sum(x.end_ns - x.start_ns for x in recs["launches"]
             if x.kernel == "macro_chain")
    builds = recorder.span_count(recs, "tardis.macro_chain")
    if not ns or not builds:
        return None
    b = ctx["bounds"]
    one = k8_chain.bound_s(b["k8_groups"], b["k8_bandwidth"],
                           b["k8_shells"], b["k8_lines"], b["k8_levels"],
                           b["k8_width"], b["k8_emit_width"])
    return 100.0 * one * builds / (ns * 1e-9)
