// Slots of a device counter for lanes that take their work from a list:
// K1's continuum grid takes packet ids, K6's walk takes entries of its list
// of moving packets.
#pragma once
#include <cooperative_groups.h>

namespace tardis {

// a slot of ``counter`` for each calling lane, taken once per group of
// converged lanes (a warp-aggregated atomicAdd)
template <typename T>
__device__ __forceinline__ T take_slot(T* counter) {
  namespace cg = cooperative_groups;
  cg::coalesced_group g = cg::coalesced_threads();
  T base = 0;
  if (g.thread_rank() == 0) base = atomicAdd(counter, (T)g.size());
  return g.shfl(base, 0) + (T)g.thread_rank();
}

}  // namespace tardis
