// K2 blackbody_source: the packet pool (mu, nu_cmf) of one iteration.
//
// Replaces: tardis_tpu/transport/source.py:31 `sample_blackbody_packets`
// (Bjorkman & Wood blackbody frequencies, mu = sqrt(xi)), a vmapped JAX
// program over packet ids.
//
// Bound on the H100: operations.  Each packet derives its key with one
// threefry2x32 hash and draws six uniforms with six more (~120 integer
// operations each), does a ten-step binary search over the 999-entry
// l-table and one log; it writes only 8 bytes.  Design: one thread per
// packet, no shared state; the l-table (4 KB) stays in L1/L2.  The log is
// taken in f64 and rounded to f32, so this kernel and its plain version
// (tardis_torch/transport/source.py) agree bit for bit, and both sit within
// an ulp of JAX's f32 log.  Built with --fmad=false (see tardis_torch/cuda.py).
#include <cuda_runtime.h>
#include <cstdint>

#include "threefry.cuh"

namespace {

__global__ void blackbody_source_kernel(
    tardis::Key key, int64_t n, const float* __restrict__ l_array, int n_l,
    float l_coef, float nu_coef, float nu_unit, float* __restrict__ mu,
    float* __restrict__ nu) {
  int64_t pid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (pid >= n) return;
  tardis::Key k = tardis::fold_in(key, (uint32_t)pid);
  float xi[6];
#pragma unroll
  for (int j = 0; j < 6; ++j)
    xi[j] = tardis::uniform_f32(tardis::random_bits(k, (uint32_t)j), 0.0f, 1.0f);
  // searchsorted(l_array, xi0 * l_coef, side="left") + 1
  float v = xi[0] * l_coef;
  int lo = 0, hi = n_l;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (l_array[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  float l_min = (float)(lo + 1);
  float prod = fmaxf(((xi[1] * xi[2]) * xi[3]) * xi[4], 1e-37f);
  float x = (float)(-log((double)prod)) / l_min;
  nu[pid] = (x * nu_coef) / nu_unit;
  mu[pid] = sqrtf(xi[5]);
}

}  // namespace

extern "C" int blackbody_source(uint32_t k0, uint32_t k1, int64_t n,
                                const void* l_array, int n_l, float l_coef,
                                float nu_coef, float nu_unit, void* mu,
                                void* nu, void* stream) {
  if (n > 0) {
    const int threads = 256;
    blackbody_source_kernel<<<(unsigned)((n + threads - 1) / threads), threads,
                              0, (cudaStream_t)stream>>>(
        tardis::Key{k0, k1}, n, (const float*)l_array, n_l, l_coef, nu_coef,
        nu_unit, (float*)mu, (float*)nu);
  }
  return (int)cudaGetLastError();
}
