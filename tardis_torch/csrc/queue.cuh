// Slots of a device counter for lanes that take their work from a list:
// K1's grids and K7's take packet ids, K6's walk takes entries of its list
// of moving packets; and the size of such a persistent grid.
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
