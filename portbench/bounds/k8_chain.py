"""Lower bound on one chain build (K8): the macro atom's absorbing-chain
tables of every shell, from the work its inputs need.

Counted, with the reason for each count:

- flops.  For each shell and each group of n levels, the n x n table
  B = (I - Q)^-1 diag(d).  Levels jump at most b levels apart, so I - Q is
  banded with half-bandwidth b and its inverse is semiseparable with
  generators of rank b: each of the n^2 entries is a sum of b products of
  generators, 2 n^2 b flops for the group, against the 2 n^3 of the
  Gauss-Jordan elimination K8 runs (b <= n, so the count is below K8's
  own).  The generators' cost (O(n b^2)) and the CDF sums are not
  counted.  Rate: the FP64 tensor cores' peak, the highest f64 rate.
- bytes.  The Sobolev escape probability, the stimulated-emission factor
  and J_blue of every line in every shell (f64, read once), and the chain
  and emission CDF tables (f32, written once).

bound = max(flops / FP64 peak, bytes / HBM bandwidth).
"""

from portbench.bounds.peaks import FP64_TENSOR_FLOPS, HBM_BYTES_PER_S


def work(groups, bandwidth: int, shells: int, lines: int, levels: int,
         width: int, emit_width: int) -> dict:
    flops = shells * sum(2.0 * n * n * min(bandwidth, n) for n in groups)
    read = 3 * 8.0 * lines * shells
    written = 4.0 * shells * levels * ((width + 1) + 3 * emit_width)
    return {"flops": flops, "bytes": read + written}


def bound_s(groups, bandwidth, shells, lines, levels, width,
            emit_width) -> float:
    w = work(groups, bandwidth, shells, lines, levels, width, emit_width)
    return max(w["flops"] / FP64_TENSOR_FLOPS, w["bytes"] / HBM_BYTES_PER_S)
