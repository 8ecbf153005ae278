// K2 blackbody_source: the packet pool (mu, nu_cmf[, w]) of one iteration.
//
// Replaces: tardis_tpu/transport/source.py:31 `sample_blackbody_packets`
// (Bjorkman & Wood blackbody frequencies, mu = sqrt(xi)), :58
// `sample_blackbody_packets_weighted` and :89
// `sample_blackbody_packets_relativistic`, vmapped JAX programs over packet
// ids; `mode` selects the pool (0 simple, 1 relativistic, 2 weighted), a
// template parameter, so the simple pool's instantiation carries none of
// the others' code.
//
// Bound on the H100: operations.  Each packet derives its key with one
// threefry2x32 hash and draws up to six uniforms with six more (~120
// integer operations each), does a ten-step binary search over the
// 999-entry l-table and one log; it writes 8 or 12 bytes.  Design: one
// thread per packet, no shared state; the l-table (4 KB) stays in L1/L2.
// Logs and exponentials are taken in f64 and rounded to f32, so this kernel
// and its plain version (tardis_torch/transport/source.py) agree bit for
// bit, and both sit within an ulp of JAX's f32 functions.  Built with
// --fmad=false (see tardis_torch/cuda.py).
//
// The weighted pool divides w by its mean: each block sums its weights in
// f64 (warp shuffles, then one shared slot per warp) and adds the block sum
// to one global f64 with one atomic; a second, elementwise launch divides.
#include <cuda_runtime.h>
#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kSimple = 0;
constexpr int kRelativistic = 1;
constexpr int kWeighted = 2;
constexpr int kThreads = 256;
constexpr uint32_t kRelMuFold = 7;

struct Params {
  tardis::Key key;
  int64_t n;
  const float* l_array;
  int n_l;
  float l_coef, nu_coef, nu_unit;
  float beta, bb, two_beta, w_rel;     // relativistic pool
  float log_lo, log_span, h, kt, x_lo, x_hi;  // weighted pool
  float* mu;
  float* nu;
  float* w;
  double* w_sum;
};

__device__ __forceinline__ float uniform01(tardis::Key k, uint32_t column) {
  return tardis::uniform_f32(tardis::random_bits(k, column), 0.0f, 1.0f);
}

template <int kMode>
__global__ void blackbody_source_kernel(Params p) {
  const int64_t pid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  double w_here = 0.0;
  if (pid < p.n) {
    const tardis::Key k = tardis::fold_in(p.key, (uint32_t)pid);
    if constexpr (kMode == kWeighted) {
      const float nu = (float)exp((double)(p.log_lo + uniform01(k, 0) * p.log_span));
      const float x = fminf(fmaxf(((p.h * nu) * p.nu_unit) / p.kt, p.x_lo), p.x_hi);
      const float w = ((nu * nu) * (nu * nu)) / (float)expm1((double)x);
      p.nu[pid] = nu;
      p.mu[pid] = sqrtf(uniform01(k, 1));
      p.w[pid] = w;
      w_here = (double)w;
    } else {
      float xi[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) xi[j] = uniform01(k, (uint32_t)j);
      // searchsorted(l_array, xi0 * l_coef, side="left") + 1
      const float v = xi[0] * p.l_coef;
      int lo = 0, hi = p.n_l;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (p.l_array[mid] < v) lo = mid + 1;
        else hi = mid;
      }
      const float l_min = (float)(lo + 1);
      const float prod = fmaxf(((xi[1] * xi[2]) * xi[3]) * xi[4], 1e-37f);
      const float x = (float)(-log((double)prod)) / l_min;
      p.nu[pid] = (x * p.nu_coef) / p.nu_unit;
      if constexpr (kMode == kSimple) {
        p.mu[pid] = sqrtf(xi[5]);
      } else {
        const float z = uniform01(tardis::fold_in(k, kRelMuFold), 0);
        p.mu[pid] = -p.beta + sqrtf((p.bb + p.two_beta * z) + z);
        p.w[pid] = p.w_rel;
      }
    }
  }
  if constexpr (kMode == kWeighted) {
    // block sum of the weights in f64, one atomic per block
    __shared__ double warp_sums[kThreads / 32];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      w_here += __shfl_down_sync(0xffffffffu, w_here, off);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = w_here;
    __syncthreads();
    if (threadIdx.x < 32) {
      double s = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.0;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
      if (threadIdx.x == 0) atomicAdd(p.w_sum, s);
    }
  }
}

// w /= mean(w), the mean rounded to f32 as the plain version rounds it
__global__ void normalize_weights_kernel(float* w, const double* w_sum, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float mean = (float)(*w_sum / (double)n);
  w[i] = w[i] / mean;
}

}  // namespace

extern "C" int blackbody_source(
    uint32_t k0, uint32_t k1, int64_t n, const void* l_array, int n_l,
    float l_coef, float nu_coef, float nu_unit, int mode, float beta,
    float bb, float two_beta, float w_rel, float log_lo, float log_span,
    float h, float kt, float x_lo, float x_hi, void* mu, void* nu, void* w,
    void* w_sum, void* stream) {
  Params p;
  p.key = tardis::Key{k0, k1};
  p.n = n;
  p.l_array = (const float*)l_array;
  p.n_l = n_l;
  p.l_coef = l_coef;
  p.nu_coef = nu_coef;
  p.nu_unit = nu_unit;
  p.beta = beta;
  p.bb = bb;
  p.two_beta = two_beta;
  p.w_rel = w_rel;
  p.log_lo = log_lo;
  p.log_span = log_span;
  p.h = h;
  p.kt = kt;
  p.x_lo = x_lo;
  p.x_hi = x_hi;
  p.mu = (float*)mu;
  p.nu = (float*)nu;
  p.w = (float*)w;
  p.w_sum = (double*)w_sum;
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    cudaStream_t s = (cudaStream_t)stream;
    if (mode == kSimple) {
      blackbody_source_kernel<kSimple><<<blocks, kThreads, 0, s>>>(p);
    } else if (mode == kRelativistic) {
      blackbody_source_kernel<kRelativistic><<<blocks, kThreads, 0, s>>>(p);
    } else {
      blackbody_source_kernel<kWeighted><<<blocks, kThreads, 0, s>>>(p);
      normalize_weights_kernel<<<blocks, kThreads, 0, s>>>(p.w, p.w_sum, n);
    }
  }
  return (int)cudaGetLastError();
}
