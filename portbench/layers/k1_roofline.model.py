"""The continuum K1's share of its roofline in ``iip.model``: the frozen
bound (``bounds/k1_continuum.py``) of each launch, from its packets, the
events the program counted (``TransportResult.n_events``), the merged
bound-free grid's cells and the shells, over its device milliseconds (a
CUDA event pair around each call of the solver's ``transport_loop``),
summed over the window's launches."""

from portbench.bounds import k1_continuum

NAME = "k1_roofline.model"
UNIT = "%"
LAYER = "event loop"
MOVES = "model_s"
WORKLOADS = ("iip.model",)
PROBES = (("tardis_torch.transport.solver", "transport_loop", "k1", False),)


def read(ctx):
    ms = ctx["probe"].device_ms("k1")
    b = ctx["bounds"]
    events = b["k1_events"]
    if not ms or len(ms) != len(events):
        return None
    bound = sum(k1_continuum.bound_s(b["k1_packets"], e, b["grid_cells"],
                                     b["shells"]) for e in events)
    return 100.0 * bound / (sum(ms) * 1e-3)
