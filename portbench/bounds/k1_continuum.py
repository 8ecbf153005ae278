"""Lower bound on one launch of K1's continuum event loop (the Type IIP
workflow: full relativity, bound-free and free-free opacity, the
absorbing-Markov macro atom, last-interaction rows), from the work its
inputs need; ``iip.model`` reads it.

Counted, with the reason for each count:

- threefry2x32 hashes, as for the classic loop (``k1_classic.py``): one a
  packet (its key), two an event (the event's key and tau), 40 ALU
  operations a hash (20 rounds of a rotate and an xor).  The other
  columns (mu, the Thomson / continuum split, the continuum picked, the
  Markov draws) are drawn only where an event needs them and are not
  counted.
- the line search: one comparison an event, as for the classic loop.
- bytes: each packet's pool entry (mu, nu, weight: 12 B) read once, its
  output row (8 B) and last-interaction row (24 B) written once, and the
  estimator moments (8 f64 a grid cell and shell) written once.

bound = max(ALU operations / ALU rate, bytes / HBM bandwidth).
"""

from portbench.bounds.k1_classic import (
    HASH_ALU_OPS,
    HASHES_PER_EVENT,
    HASHES_PER_PACKET,
    SEARCH_ALU_OPS_PER_EVENT,
)
from portbench.bounds.peaks import ALU_OPS_PER_S, HBM_BYTES_PER_S

BYTES_PER_PACKET = 12 + 8 + 24
MOMENT_BYTES = 8 * 8


def work(packets: int, events: float, grid_cells: int, shells: int) -> dict:
    alu = (HASH_ALU_OPS * HASHES_PER_PACKET * packets
           + (HASH_ALU_OPS * HASHES_PER_EVENT + SEARCH_ALU_OPS_PER_EVENT)
           * events)
    return {"alu_ops": alu,
            "bytes": (BYTES_PER_PACKET * packets
                      + MOMENT_BYTES * grid_cells * shells)}


def bound_s(packets: int, events: float, grid_cells: int,
            shells: int) -> float:
    w = work(packets, events, grid_cells, shells)
    return max(w["alu_ops"] / ALU_OPS_PER_S, w["bytes"] / HBM_BYTES_PER_S)
