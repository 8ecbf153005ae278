"""K8's share of its roofline in ``w7.converge``: the frozen bound
(``bounds/k8_chain.py``) of a build, from the reference's own layout of
the macro atom (its groups and bandwidth), over the device milliseconds
of each build (a CUDA event pair around each call of the solver's
``solve_macro_chain``), summed over the window's builds."""

from portbench.bounds import k8_chain

NAME = "k8_roofline.converge"
UNIT = "%"
LAYER = "macro atom"
MOVES = "packets_per_s"
WORKLOADS = ("w7.converge",)
PROBES = (("tardis_torch.transport.solver", "solve_macro_chain", "k8",
           False),)


def read(ctx):
    ms = ctx["probe"].device_ms("k8")
    if not ms:
        return None
    b = ctx["bounds"]
    one = k8_chain.bound_s(b["k8_groups"], b["k8_bandwidth"],
                           b["k8_shells"], b["k8_lines"], b["k8_levels"],
                           b["k8_width"], b["k8_emit_width"])
    return 100.0 * one * len(ms) / (sum(ms) * 1e-3)
