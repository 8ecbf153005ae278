// Slots of a device counter for lanes that take their work from a list:
// K1's grids and K7's take packet ids, K6's walk takes entries of its list
// of moving packets, K5's warps take rays in ranges; and the size of such
// a persistent grid.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

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

// Consecutive slots of a device counter for the lanes of one warp, taken
// a range of kRange slots at a time: one atomicAdd a range, so that lanes
// which finish their items at different times do not contend on one
// address for every item.  Called by the whole warp, converged, with
// ``need`` the lanes that want a slot, at most kRange of them; returns this
// lane's slot (where its bit of ``need`` is set): the lanes that take
// together get consecutive slots in lane order.  ``next`` and ``end`` are
// the same in every lane.
struct WarpRange {
  unsigned long long next = 0, end = 0;

  template <unsigned long long kRange>
  __device__ __forceinline__ unsigned long long take(unsigned long long* counter,
                                                     unsigned need, int lane) {
    const unsigned n = __popc(need);
    const unsigned rank = __popc(need & ((1u << lane) - 1u));
    const unsigned long long avail = end - next;
    unsigned long long slot;
    if (avail < n) {
      unsigned long long base = 0;
      if (lane == 0) base = atomicAdd(counter, kRange);
      base = __shfl_sync(0xffffffffu, base, 0);
      slot = rank < avail ? next + rank : base + (rank - avail);
      next = base + (n - avail);
      end = base + kRange;
    } else {
      slot = next + rank;
      next += n;
    }
    return slot;
  }
};

// blocks of a persistent launch of ``kernel``: as many as are resident on
// the current device at ``threads`` lanes and ``shm`` bytes of dynamic
// shared memory (opted in past the default 48 KiB), and no more than
// ``n_items`` lanes need
template <class Kernel>
inline cudaError_t persistent_blocks(Kernel kernel, int threads, size_t shm,
                                     int64_t n_items, unsigned* blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && shm > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, shm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t need = (n_items + threads - 1) / threads;
  const int64_t resident = (int64_t)per_sm * sms;
  *blocks = (unsigned)(need < resident ? need : resident);
  return cudaSuccess;
}

}  // namespace tardis
