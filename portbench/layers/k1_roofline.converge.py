"""K1's share of its roofline in the converge cells: the frozen bound
(``bounds/k1_classic.py``) of each launch, from its packets and the events
the program counted (``TransportResult.n_events``), over its device
milliseconds (a CUDA event pair around each call of the solver's
``transport_loop``), summed over the window's launches."""

from portbench.bounds import k1_classic

NAME = "k1_roofline.converge"
UNIT = "%"
LAYER = "event loop"
MOVES = "packets_per_s"
WORKLOADS = ("w7.converge",)
PROBES = (("tardis_torch.transport.solver", "transport_loop", "k1", False),)


def read(ctx):
    ms = ctx["probe"].device_ms("k1")
    events = ctx["bounds"]["k1_events"]
    if not ms or len(ms) != len(events):
        return None
    n = ctx["bounds"]["k1_packets"]
    bound = sum(k1_classic.bound_s(n, e) for e in events)
    return 100.0 * bound / (sum(ms) * 1e-3)
