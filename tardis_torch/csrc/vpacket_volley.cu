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
// Bound on the H100: the number of dependent scattered loads.  A ray walks
// up to 2S + 2 shell segments (19.2 on average and at most 20 on the bench
// problem); each segment finds the first line at or after the ray's current
// line whose frequency is at or below the comoving frequency at the
// segment's end, and reads two f64 entries of its shell's tau prefix (29 MB
// at bench scale, in the 50 MB L2); the ray ends in one bin of the spectrum
// and one f64 add.  A plain bisection of the line list (732 KB at L =
// 183,060) took ~17 dependent probes a segment, each on a new cache line.
// Design:
//   - a bucketed index of the line list (vpacket.py `bucket_table`, built
//     once for the tables as torch ops): a positive f32's bit pattern rises
//     with its value, so bits >> shift name a bucket, and a table of the
//     count of lines at or below each bucket's key brackets the answer
//     between the lines above the bucket and those at or above its bottom;
//     only that bracket (a few dozen lines, one or two cache lines of the
//     list) is bisected, from the ray's current line on.  The bisection of
//     a monotone array over a bracket that holds the answer returns the
//     full bisection's index, so every ray stays bitwise.  The table (at
//     most 8,192 entries, 32 KB) is read through the L1: staged in shared
//     memory it measured 3.3x slower (H100 80GB HBM3, 700 W);
//   - the ray's bin is a direct index on the uniform frequency grid,
//     checked against the edges on both sides (exactly searchsorted(edges,
//     nu, right) - 1 for any ascending edges);
//   - one thread a ray in blocks of 512, rays record-major, so the V rays
//     of a record sit on adjacent lanes and start from the same shell and
//     line.  Rays are nearly equal in length (at most 20 segments against
//     19.2 on average), so a persistent grid whose lanes refill from a
//     counter has no idle lanes to fill: it measured 1.9-3.6x slower, the
//     counter's atomics (one a ray) and the shared table costing more than
//     the launch of one thread a ray;
//   - the JAX package's two-float prefix difference (`df32_diff`) becomes
//     an f64 difference rounded to f32;
//   - e^-tau is taken in f64 and rounded to f32, built with --fmad=false,
//     so the plain PyTorch version (tardis_torch/transport/vpacket.py)
//     reproduces every ray's energy bit for bit;
//   - the histogram takes global f64 atomics (10,000 bins on the main path):
//     a block-private histogram in shared memory (80 KB) needs a persistent
//     grid to flush it once a block, and in one it measured from 9% faster
//     to 8% slower than the atomics; the segment count is summed per block
//     in shared memory and flushed once a block.
#include <cuda_runtime.h>
#include <cstdint>

#ifndef VV_FULL_RELATIVITY
#define VV_FULL_RELATIVITY 0
#endif

namespace {

constexpr int kThreads = 512;
constexpr float kTauStop = 70.0f;

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
  const int32_t* buckets;  // (n_buckets,) lines whose key is <= base + t
  const float* edges;    // (M+1,) ascending
  double* hist;          // (M,)
  unsigned long long* n_segments;
  float* ray_nu;  // (n_records * V,) or null
  float* ray_e;
  int64_t n_records;
  int64_t L;
  int V, S, M, n_buckets, bucket_base, bucket_shift;
  float spawn_lo, spawn_hi;
};

// the first line at or after i_cur whose frequency is at or below x: the
// bucket of x's key brackets the count of lines above x between L - (lines
// with key <= key(x)) and L - (lines with key < key(x)); a NaN counts every
// line above it, as searchsorted sorts NaN last
__device__ __forceinline__ int64_t first_line_at_or_below(const Params& p, float x,
                                                          int64_t i_cur) {
  const int32_t* tab = p.buckets;
  const int nb = p.n_buckets - 1;
  const int j = (x != x) ? -1 : (__float_as_int(x) >> p.bucket_shift) - p.bucket_base;
  const int a = min(max(j - 1, 0), nb);
  const int b = min(max(j, 0), nb);
  int64_t lo = p.L - tab[b];
  int64_t hi = p.L - tab[a];
  lo = lo > i_cur ? lo : i_cur;
  hi = hi > i_cur ? hi : i_cur;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (p.line_nu[mid] > x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// One ray on its lane: its direction, frequency and energy from its record,
// then one shell segment a step.
template <bool kRel>
struct Ray {
  int64_t id = 0;
  float nu = 0.0f, e_vp = 0.0f, p2 = 0.0f, z = 0.0f, tau = 0.0f;
  int64_t i_cur = 0;
  int shell = 0, segs = 0;
  bool valid = false;

  __device__ __forceinline__ void start(const Params& p, int64_t ray) {
    id = ray;
    const int64_t rec = ray / p.V;
    const int v = (int)(ray - rec * p.V);
    const float4 a = reinterpret_cast<const float4*>(p.records)[2 * rec];
    const float4 b = reinterpret_cast<const float4*>(p.records)[2 * rec + 1];
    const float r0 = a.x, mu0 = a.y, nu0 = a.z, e0 = a.w;
    shell = (int)b.x;
    i_cur = (int64_t)b.y;
    const float beta_inner = p.r_inner[0];
    valid = (e0 > 0.0f) && (nu0 >= p.spawn_lo) && (nu0 <= p.spawn_hi);

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
    nu = nu0 * ratio;
    e_vp = (e0 * weight) * ratio;
    p2 = fmaxf((r0 * r0) * (1.0f - mu * mu), 0.0f);
    z = mu * r0;
    tau = 0.0f;
    segs = 0;
  }

  // one segment; false once the ray has left the shells, reached
  // kTauStop or walked 2S + 2 segments
  __device__ __forceinline__ bool segment(const Params& p) {
    const int S = p.S;
    if (shell < 0 || shell >= S || !(tau < kTauStop) || segs >= 2 * S + 2) return false;
    ++segs;
    const float r_in = p.r_inner[shell];
    const float r_out = p.r_outer[shell];
    const bool reaches_inner = (z < 0.0f) && (p2 < r_in * r_in);
    const float z_next = reaches_inner ? -sqrtf(fmaxf(r_in * r_in - p2, 0.0f))
                                       : sqrtf(fmaxf(r_out * r_out - p2, 0.0f));
    float nu_cmf_next = nu * (1.0f - z_next);
    if constexpr (kRel) nu_cmf_next = nu_cmf_next * lorentz_gamma(reaches_inner ? r_in : r_out);
    const int64_t i_next = first_line_at_or_below(p, nu_cmf_next, i_cur);
    const double* prow = p.prefix + (int64_t)shell * (p.L + 1);
    const float d_line = (float)(prow[i_next] - prow[i_cur]);
    float chi_e = p.chi_e[shell];
    if constexpr (kRel) chi_e = (chi_e * (1.0f - z)) * lorentz_gamma(sqrtf(p2 + z * z));
    tau = tau + (d_line + chi_e * fmaxf(z_next - z, 0.0f));
    z = z_next;
    i_cur = i_next;
    shell += reaches_inner ? -1 : 1;
    return true;
  }

  // the attenuated energy into the bin of the ray's lab frequency: a
  // direct index on the uniform grid, moved down then up until
  // edges[bin] <= nu < edges[bin + 1] (bin = searchsorted(edges, nu,
  // right) - 1 for any ascending edges inside [edges[0], edges[M]))
  __device__ __forceinline__ void finish(const Params& p) {
    float e_out = valid ? e_vp * (float)exp(-(double)tau) : 0.0f;
    const int M = p.M;
    if (!((nu >= p.edges[0]) && (nu < p.edges[M]))) e_out = 0.0f;
    if (e_out != 0.0f) {
      const float inv_width = (float)M / (p.edges[M] - p.edges[0]);
      int bin = (int)((nu - p.edges[0]) * inv_width);
      bin = min(max(bin, 0), M - 1);
      while (bin > 0 && p.edges[bin] > nu) --bin;
      while (bin < M - 1 && p.edges[bin + 1] <= nu) ++bin;
      atomicAdd(&p.hist[bin], (double)e_out);
    }
    if (p.ray_nu != nullptr) {
      p.ray_nu[id] = nu;
      p.ray_e[id] = e_out;
    }
  }
};

__global__ void __launch_bounds__(kThreads) vpacket_volley_kernel(Params p) {
  __shared__ unsigned long long sh_segments;
  if (threadIdx.x == 0) sh_segments = 0;
  __syncthreads();
  const int64_t id = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (id < p.n_records * p.V) {
    Ray<VV_FULL_RELATIVITY != 0> ray;
    ray.start(p, id);
    while (ray.segment(p)) {
    }
    ray.finish(p);
    atomicAdd(&sh_segments, (unsigned long long)ray.segs);
  }
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(p.n_segments, sh_segments);
}

}  // namespace

extern "C" int vpacket_volley(
    const void* records, int64_t n_records, int V, const void* r_inner,
    const void* r_outer, const void* chi_e, const void* line_nu,
    const void* prefix, int64_t L, int S, const void* buckets, int n_buckets,
    int bucket_base, int bucket_shift, const void* edges, int M,
    float spawn_lo, float spawn_hi, void* hist, void* n_segments, void* ray_nu,
    void* ray_e, void* stream) {
  Params p;
  p.records = (const float*)records;
  p.r_inner = (const float*)r_inner;
  p.r_outer = (const float*)r_outer;
  p.chi_e = (const float*)chi_e;
  p.line_nu = (const float*)line_nu;
  p.prefix = (const double*)prefix;
  p.buckets = (const int32_t*)buckets;
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
  p.n_buckets = n_buckets;
  p.bucket_base = bucket_base;
  p.bucket_shift = bucket_shift;
  p.spawn_lo = spawn_lo;
  p.spawn_hi = spawn_hi;
  if (n_buckets < 1) return (int)cudaErrorInvalidValue;
  const int64_t n_rays = n_records * V;
  if (n_rays > 0)
    vpacket_volley_kernel<<<(unsigned)((n_rays + kThreads - 1) / kThreads), kThreads, 0,
                            (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
