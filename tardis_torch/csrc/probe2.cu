// The three kernels of the feasibility probe (benchmarks/probe2.py).
//
// Replaces the Pallas kernels of tardis_tpu/benchmarks/probe2.py:
//   - scale2 (`kern`, :128, pallas_call :133): o = 2 x over a whole array
//     held in VMEM, the probe's VMEM round trip at 16-120 MB;
//   - take_1d (`gkern`, :146, :152): o = take(tab, idx), a 1-D gather;
//   - take_along_rows (`gkern2`, :167, :173): o = take_along_axis(tab, idx,
//     1) on (R, 128) rows.
//
// Bound on the H100: device-memory bytes in all three (one multiply, or
// none, per 4-8 bytes moved).  Design:
//   - scale2 moves 16 bytes a thread per access (float4 loads and
//     stores), neighbouring threads on neighbouring addresses, with four
//     loads of a thread in flight before its first store, over a grid
//     that covers the array once; a buffer that is not 16-byte aligned,
//     and the last n mod 4 elements, take the scalar loop.  The TPU
//     kernel's whole-array VMEM block has no counterpart: a stream never
//     needs more than registers;
//   - take_1d gives a thread four outputs: one 16-byte load of indices,
//     four independent gathers in flight through the read-only path, one
//     16-byte store.  A random read moves a 32-byte sector, so its bound
//     is the distinct sectors the indices touch (chip_smoke.py
//     check_probe2), and 1,024 blocks of 256 threads put all ~1M gathers
//     in flight at once: the time is the sectors' round trip.  The probe
//     calls it again and again on one table (12,000,000 f32, 48 MB, beside
//     the 50 MB L2), so the indices and the output, streamed once a call,
//     are read and written evict-first (.cs: __ldcs / __stcs) and stop
//     displacing table lines; warm calls then took 3.7% less than with
//     default loads and stores (PERF.md).  Gathering the table under an L2
//     evict-last policy (createpolicy.fractional.L2::evict_last with
//     ld.global.nc.L2::cache_hint) changed nothing measurable, warm or
//     cold, so the table is read through __ldg and no policy is set: no
//     persisting access-policy window is left on the caller's stream;
//   - take_along_rows gives one warp a row: the warp stages the row's 128
//     values in shared memory with one float4 a lane, then each lane
//     gathers four outputs from shared memory and writes them as one
//     float4.  Rows and indices are read once, coalesced.
// An index outside the table gives NaN (jax.numpy.take's fill value for
// floats) and is never read; the probe draws none.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRow = 128;  // take_along_rows' row length
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kUnroll = 4;  // float4 loads in flight a thread (scale2)
constexpr int64_t kMaxBlocks = 1 << 20;

__global__ void scale2_kernel(const float* __restrict__ x,
                              float* __restrict__ o, int64_t n, int64_t n4) {
  const int64_t tile = (int64_t)blockDim.x * kUnroll;
  const int64_t stride = (int64_t)gridDim.x * tile;
  const int64_t first = (int64_t)blockIdx.x * tile + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(o);
  for (int64_t base = first; base < n4; base += stride) {
    // every load of the tile in flight before the first store
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + (int64_t)u * blockDim.x;
      if (i < n4) v[u] = __ldg(x4 + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + (int64_t)u * blockDim.x;
      if (i < n4)
        o4[i] = make_float4(2.0f * v[u].x, 2.0f * v[u].y, 2.0f * v[u].z,
                            2.0f * v[u].w);
    }
  }
  for (int64_t i = 4 * n4 + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += (int64_t)gridDim.x * blockDim.x)
    o[i] = 2.0f * x[i];
}

__device__ __forceinline__ float take(const float* __restrict__ tab,
                                      int64_t n_tab, int32_t k) {
  return (k >= 0 && k < n_tab) ? __ldg(tab + k) : __int_as_float(0x7fc00000);
}

// four outputs a thread: one int4 of indices, four independent gathers in
// flight, one float4 store
__global__ void take_1d_kernel(const float* __restrict__ tab, int64_t n_tab,
                               const int32_t* __restrict__ idx,
                               float* __restrict__ o, int64_t n, int64_t n4) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n4) {
    const int4 k = __ldcs(reinterpret_cast<const int4*>(idx) + i);
    __stcs(reinterpret_cast<float4*>(o) + i,
           make_float4(take(tab, n_tab, k.x), take(tab, n_tab, k.y),
                       take(tab, n_tab, k.z), take(tab, n_tab, k.w)));
  }
  const int64_t j = 4 * n4 + i;  // the last n mod 4 (all, unaligned)
  if (j < n) __stcs(o + j, take(tab, n_tab, __ldcs(idx + j)));
}

__global__ void take_along_rows_kernel(const float* __restrict__ tab,
                                       const int32_t* __restrict__ idx,
                                       float* __restrict__ o, int64_t rows) {
  __shared__ float4 staged[kWarpsPerBlock][kRow / 4];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= rows) return;
  const float4* t4 = reinterpret_cast<const float4*>(tab + row * kRow);
  staged[warp][lane] = __ldg(t4 + lane);
  __syncwarp();
  const float* r = reinterpret_cast<const float*>(staged[warp]);
  const int4 k = __ldg(reinterpret_cast<const int4*>(idx + row * kRow) + lane);
  const float nan = __int_as_float(0x7fc00000);
  float4 v;
  v.x = ((unsigned)k.x < kRow) ? r[k.x] : nan;
  v.y = ((unsigned)k.y < kRow) ? r[k.y] : nan;
  v.z = ((unsigned)k.z < kRow) ? r[k.z] : nan;
  v.w = ((unsigned)k.w < kRow) ? r[k.w] : nan;
  reinterpret_cast<float4*>(o + row * kRow)[lane] = v;
}

}  // namespace

extern "C" int scale2(const void* x, void* o, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  const int64_t n4 = aligned ? n / 4 : 0;
  const int64_t work = n4 > 0 ? (n4 + kUnroll - 1) / kUnroll : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  scale2_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)o, n, n4);
  return (int)cudaGetLastError();
}

extern "C" int take_1d(const void* tab, int64_t n_tab, const void* idx,
                       void* o, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  const int64_t n4 = aligned ? n / 4 : 0;
  const int64_t threads = n4 > n - 4 * n4 ? n4 : n - 4 * n4;
  take_1d_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads,
                   0, (cudaStream_t)stream>>>((const float*)tab, n_tab,
                                              (const int32_t*)idx, (float*)o,
                                              n, n4);
  return (int)cudaGetLastError();
}

extern "C" int take_along_rows(const void* tab, const void* idx, void* o,
                               int64_t rows, void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  take_along_rows_kernel<<<(unsigned)((rows + kWarpsPerBlock - 1) /
                                      kWarpsPerBlock),
                           kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)tab, (const int32_t*)idx, (float*)o, rows);
  return (int)cudaGetLastError();
}
