"""Lower bound on one launch of K1's classic event loop (homologous
transport, macro-atom chain tables, no line estimators), from the work its
inputs need; no implementation can beat it, so a share of it cannot pass
100%.

Counted, with the reason for each count:

- threefry2x32 hashes.  Every packet hashes its key once (fold_in of the
  loop key and its id); every event hashes its key (fold_in of the packet
  key and the event index) and draws tau (-ln of its column 0), one hash
  each: 2 an event.  A hash is 20 rounds, and each round's rotate and xor
  run only on the integer / logic pipe (its add may issue on the FMA pipe
  as IMAD): 40 ALU operations a hash.  The key schedule, the injections,
  the other columns (mu, the chain and emission rows, drawn only where an
  event needs them) and the bits-to-float steps are not counted.
- the line search.  Every event evaluates the event predicate at least
  once, ending in a comparison on the ALU pipe: 1 an event.  Further
  probes depend on how far the packet's frequency moves past lines before
  its event; the events that the run took are counted, not a search of
  ceil(log2(L + 1)) steps.
- bytes.  Each packet's pool entry (mu, nu: 8 B) read once, its output
  row (8 B) and last-interaction row (24 B) written once.  The tables are
  not counted: a run need not read every entry.

bound = max(ALU operations / ALU rate, bytes / HBM bandwidth).
"""

from portbench.bounds.peaks import ALU_OPS_PER_S, HBM_BYTES_PER_S

ROUND_ALU_OPS = 2  # rotate, xor
ROUNDS = 20
HASH_ALU_OPS = ROUND_ALU_OPS * ROUNDS
HASHES_PER_EVENT = 2
HASHES_PER_PACKET = 1
SEARCH_ALU_OPS_PER_EVENT = 1
BYTES_PER_PACKET = 8 + 8 + 24


def work(packets: int, events: float) -> dict:
    alu = (HASH_ALU_OPS * HASHES_PER_PACKET * packets
           + (HASH_ALU_OPS * HASHES_PER_EVENT + SEARCH_ALU_OPS_PER_EVENT)
           * events)
    return {"alu_ops": alu, "bytes": BYTES_PER_PACKET * packets}


def bound_s(packets: int, events: float) -> float:
    w = work(packets, events)
    return max(w["alu_ops"] / ALU_OPS_PER_S, w["bytes"] / HBM_BYTES_PER_S)
