// The RNG-walk macro atom that K1's walk instantiations and K7 share.
//
// Replaces: tardis_tpu/transport/kernel.py:281 `_macro_walk` with
// `_uniform_from_key` (:229) and `_bsearch_first_true` (:240).  Each jump
// draws u from its own key, fold_in(event key, 8 + jump), takes the first
// transition of the level's block whose cumulative probability (f32, per
// shell, column-major (T, S)) reaches u, clipped into the block, and ends
// on an emission; a walk that never emits re-emits the absorbed line.
// tardis_torch/transport/macro_walk.py is its plain version.
//
// Bound: a jump is one threefry hash and a bisection of its level's block
// (~log2 of the block's width probes, each a dependent load of a column
// entry); the walk's jumps depend on each other, so a walk waits on
// ~jumps x (hash + probes) latencies.  A plain, correct walk: one thread
// walks its packet's macro atom where the event happens.
#pragma once
#include <cstdint>

#include "threefry.cuh"

namespace tardis {

constexpr uint32_t kMacroWalkTag = 8;

// P provides: int S; int max_jumps; const int32_t* line2macro, block_start,
// dest, mline; const float* cum_prob; const bool* emit
template <class P>
__device__ __forceinline__ int64_t macro_walk(const P& p, Key ke, int shell, int64_t i_ev) {
  const int S = p.S;
  int level = p.line2macro[i_ev];
  for (int jump = 0; jump < p.max_jumps; ++jump) {
    const Key kw = fold_in(ke, kMacroWalkTag + (uint32_t)jump);
    const float u = uniform_f32(random_bits(kw, 0u), 1e-9f, 1.0f);
    const int b0 = p.block_start[level];
    const int b1 = p.block_start[level + 1];
    int lo = b0, hi = b1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (p.cum_prob[(int64_t)mid * S + shell] < u) lo = mid + 1;
      else hi = mid;
    }
    const int t = min(max(lo, b0), max(b1 - 1, b0));
    if (p.emit[t]) return (int64_t)p.mline[t];
    level = p.dest[t];
  }
  return i_ev;
}

}  // namespace tardis
