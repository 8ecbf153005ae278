"""The plasma solve's host milliseconds a call in the converge cells: each
call of ``Simulation._solve_plasma`` (host ionization balance and K3's
line tables) between two synchronizations, averaged over the window."""

NAME = "plasma_ms.converge"
UNIT = "ms"
LAYER = "plasma"
MOVES = "packets_per_s"
WORKLOADS = ("w7.converge",)
PROBES = (("tardis_torch.simulation.base", "Simulation._solve_plasma",
           "plasma", True),)


def read(ctx):
    ms = ctx["probe"].host.get("plasma") or []
    return sum(ms) / len(ms) if ms else None
