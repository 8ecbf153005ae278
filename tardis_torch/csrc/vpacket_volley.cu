// K4 vpacket_volley: trace every (spawn record, virtual packet) ray to the
// outer edge and add its attenuated energy to the virtual spectrum.
//
// Replaces: tardis_tpu/transport/vpacket.py:224 `_trace_vpacket_records_chunk`
// with `_trace_tau` (:41), driven by `trace_vpacket_records` (:129).  The
// full-relativity branch (:96-111,260-287: directions stratified in the
// comoving frame and aberrated back, the relativistic inner-boundary weight,
// gamma in the Doppler factors, the segment threshold and chi_e) is a
// template parameter; the library holds the one instantiation its
// VV_FULL_RELATIVITY flag selects.
//
// Bound on the H100: memory latency.  A ray walks up to 2S + 2 shell
// segments; each segment binary-searches the f32 line list (~18 dependent
// probes) and reads two entries of the f64 tau prefix of its shell (29 MB at
// bench scale, resident in the 50 MB L2); the ray ends in a ~14-probe
// search of the bin edges and one f64 atomic add.  Design:
//   - one thread per ray, record-major: the V rays of one record sit on
//     adjacent threads and start their searches from the same shell and
//     line, so their probes hit the same lines;
//   - a segment's search starts at the ray's current line (the result is
//     max(search, current line) in the JAX package), which shortens it;
//   - the JAX package's two-float prefix difference (`df32_diff`) becomes
//     an f64 difference rounded to f32, and its 3-level tiled searches plain
//     binary searches;
//   - e^-tau is taken in f64 and rounded to f32, built with --fmad=false,
//     so the plain PyTorch version (tardis_torch/transport/vpacket.py)
//     reproduces every ray's energy bit for bit;
//   - the histogram (10,000 bins on the main path) takes global f64
//     atomics; the segment count is summed per block in shared memory and
//     flushed once per block, for the bound.
#include <cuda_runtime.h>
#include <cstdint>

#ifndef VV_FULL_RELATIVITY
#define VV_FULL_RELATIVITY 0
#endif

namespace {

__device__ __forceinline__ float lorentz_gamma(float r) {
  return 1.0f / sqrtf(fmaxf(1.0f - r * r, 1e-12f));
}

struct Params {
  const float* records;  // (n_records, 8)
  const float* r_inner;
  const float* r_outer;
  const float* chi_e;
  const float* line_nu;  // (L,) descending
  const double* prefix;  // (S, L+1)
  const float* edges;    // (M+1,) ascending
  double* hist;          // (M,)
  unsigned long long* n_segments;
  float* ray_nu;  // (n_records * V,) or null
  float* ray_e;
  int64_t n_records;
  int64_t L;
  int V, S, M;
  float spawn_lo, spawn_hi;
};

template <bool kRel>
__device__ unsigned trace_ray(const Params& p, int64_t ray) {
  const int64_t rec = ray / p.V;
  const int v = (int)(ray - rec * p.V);
  const float4 a = reinterpret_cast<const float4*>(p.records)[2 * rec];
  const float4 b = reinterpret_cast<const float4*>(p.records)[2 * rec + 1];
  const float r0 = a.x, mu0 = a.y, nu0 = a.z, e0 = a.w;
  int shell = (int)b.x;
  int64_t i_cur = (int64_t)b.y;
  const int S = p.S;
  const int64_t L = p.L;
  const float beta_inner = p.r_inner[0];
  const bool valid = (e0 > 0.0f) && (nu0 >= p.spawn_lo) && (nu0 <= p.spawn_hi);

  // stratified direction and Kerzendorf & Sim weight
  const float vf = (float)p.V;
  const float frac = ((float)v + 0.5f) / vf;
  const bool on_inner = r0 <= beta_inner * 1.000001f;
  const float r_ratio = fminf(fmaxf(beta_inner / fmaxf(r0, beta_inner), 0.0f), 1.0f);
  float mu_min = on_inner ? 0.0f : -sqrtf(fmaxf(1.0f - r_ratio * r_ratio, 0.0f));
  if constexpr (kRel) mu_min = on_inner ? 0.0f : (mu_min - r0) / (1.0f - r0 * mu_min);
  float mu = mu_min + frac * (1.0f - mu_min);
  float weight, ratio;
  if constexpr (kRel) {
    weight = on_inner ? (2.0f * (mu + beta_inner)) / ((2.0f * beta_inner + 1.0f) * vf)
                      : (1.0f - mu_min) / (2.0f * vf);
    mu = (mu + r0) / (1.0f + r0 * mu);
    const float gamma_r = lorentz_gamma(r0);
    ratio = ((1.0f - mu0 * r0) * gamma_r) / ((1.0f - mu * r0) * gamma_r);
  } else {
    weight = on_inner ? (2.0f * mu) / vf : (1.0f - mu_min) / (2.0f * vf);
    ratio = (1.0f - mu0 * r0) / (1.0f - mu * r0);
  }
  const float nu = nu0 * ratio;
  const float e_vp = (e0 * weight) * ratio;

  // optical depth to the outer edge, one shell segment at a time
  const float p2 = fmaxf((r0 * r0) * (1.0f - mu * mu), 0.0f);
  float z = mu * r0;
  float tau = 0.0f;
  unsigned segs = 0;
  for (int seg = 0; seg < 2 * S + 2; ++seg) {
    if (shell < 0 || shell >= S || !(tau < 70.0f)) break;
    ++segs;
    const float r_in = p.r_inner[shell];
    const float r_out = p.r_outer[shell];
    const bool reaches_inner = (z < 0.0f) && (p2 < r_in * r_in);
    const float z_next = reaches_inner ? -sqrtf(fmaxf(r_in * r_in - p2, 0.0f))
                                       : sqrtf(fmaxf(r_out * r_out - p2, 0.0f));
    float nu_cmf_next = nu * (1.0f - z_next);
    if constexpr (kRel) nu_cmf_next = nu_cmf_next * lorentz_gamma(reaches_inner ? r_in : r_out);
    // first line at or after i_cur with nu_line <= nu_cmf_next
    int64_t lo = i_cur, hi = L;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (p.line_nu[mid] > nu_cmf_next) lo = mid + 1;
      else hi = mid;
    }
    const double* prow = p.prefix + (int64_t)shell * (L + 1);
    const float d_line = (float)(prow[lo] - prow[i_cur]);
    float chi_e = p.chi_e[shell];
    if constexpr (kRel) chi_e = (chi_e * (1.0f - z)) * lorentz_gamma(sqrtf(p2 + z * z));
    tau = tau + (d_line + chi_e * fmaxf(z_next - z, 0.0f));
    z = z_next;
    i_cur = lo;
    shell += reaches_inner ? -1 : 1;
  }

  float e_out = valid ? e_vp * (float)exp(-(double)tau) : 0.0f;
  // bin = searchsorted(edges, nu, right) - 1, clipped to [0, M-1]
  int lo = 0, hi = p.M + 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (p.edges[mid] <= nu) lo = mid + 1;
    else hi = mid;
  }
  const int bin = min(max(lo - 1, 0), p.M - 1);
  if (!((nu >= p.edges[0]) && (nu < p.edges[p.M]))) e_out = 0.0f;
  if (e_out != 0.0f) atomicAdd(&p.hist[bin], (double)e_out);
  if (p.ray_nu != nullptr) {
    p.ray_nu[ray] = nu;
    p.ray_e[ray] = e_out;
  }
  return segs;
}

__global__ void vpacket_volley_kernel(Params p) {
  __shared__ unsigned long long sh_segments;
  if (threadIdx.x == 0) sh_segments = 0;
  __syncthreads();
  const int64_t ray = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (ray < p.n_records * p.V)
    atomicAdd(&sh_segments, (unsigned long long)trace_ray<VV_FULL_RELATIVITY != 0>(p, ray));
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(p.n_segments, sh_segments);
}

}  // namespace

extern "C" int vpacket_volley(
    const void* records, int64_t n_records, int V, const void* r_inner,
    const void* r_outer, const void* chi_e, const void* line_nu,
    const void* prefix, int64_t L, int S, const void* edges, int M,
    float spawn_lo, float spawn_hi, void* hist, void* n_segments,
    void* ray_nu, void* ray_e, void* stream) {
  Params p;
  p.records = (const float*)records;
  p.r_inner = (const float*)r_inner;
  p.r_outer = (const float*)r_outer;
  p.chi_e = (const float*)chi_e;
  p.line_nu = (const float*)line_nu;
  p.prefix = (const double*)prefix;
  p.edges = (const float*)edges;
  p.hist = (double*)hist;
  p.n_segments = (unsigned long long*)n_segments;
  p.ray_nu = (float*)ray_nu;
  p.ray_e = (float*)ray_e;
  p.n_records = n_records;
  p.L = L;
  p.V = V;
  p.S = S;
  p.M = M;
  p.spawn_lo = spawn_lo;
  p.spawn_hi = spawn_hi;
  const int64_t n_rays = n_records * V;
  if (n_rays > 0) {
    const int threads = 256;
    vpacket_volley_kernel<<<(unsigned)((n_rays + threads - 1) / threads), threads,
                            0, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
