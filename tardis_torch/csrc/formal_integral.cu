// K5 formal_integral: the emergent intensity of every (frequency, impact
// parameter) ray through the source-function tables (Lucy 1999).
//
// Replaces: tardis_tpu/spectrum/formal_integral.py:137 `_integrate_rays`, a
// lockstep while_loop over all F x P rays with one event per step.
//
// Bound on the H100: memory latency.  A ray walks every line whose
// resonance it crosses (thousands at bench scale) and each shell boundary;
// each event reads the line's frequency and two to four f32 table entries
// and does ~20 f32 operations, all dependent on the previous event.
// Design:
//   - one thread per ray runs the JAX step loop until the ray leaves the
//     shells, so no ray waits for the longest one;
//   - the four (S, L) f32 tables are laid out shell-major, so a ray's walk
//     along the lines of its shell reads consecutive addresses (the JAX
//     package indexes line * S + shell, stride S);
//   - the start line is a binary search of the descending line list, the
//     count of lines with nu_line >= nu (1 - z0);
//   - the arithmetic and its order are the JAX step's (the `first` flag, the
//     previous line's J_red clipped at line 0, the averaged J on boundary
//     segments, the collected electron-scattering source, z_line =
//     max(zeta, z)), in f32 and built with --fmad=false, so the plain
//     PyTorch version (tardis_torch/spectrum/formal_integral.py) gives the
//     same bits per ray;
//   - a ray still going after max_events events (L + 2S + 2, more than a
//     ray can meet) is stopped and counted; line and boundary events are
//     counted too, summed per block in shared memory, for the bound.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

struct Params {
  const float* nu_grid;  // (F,)
  const float* p_grid;   // (P,)
  const float* r_inner;  // (S,)
  const float* r_outer;
  const float* chi_e;
  const float* line_nu;  // (L,) descending
  const float* exp_tau;  // (S, L)
  const float* att_S;
  const float* j_red;
  const float* j_blue;
  const float* i_inner;  // (F,)
  float* i_p;            // (F, P)
  unsigned long long* counts;  // [line events, boundary events, capped rays]
  int64_t L;
  int64_t max_events;
  int F, P, S;
};

__device__ __forceinline__ float zb(float r, float p2) {
  return sqrtf(fmaxf(r * r - p2, 0.0f));
}

__device__ void integrate_ray(const Params& p, int64_t ray,
                              unsigned long long* sh_counts) {
  const int f = (int)(ray / p.P);
  const int k = (int)(ray - (int64_t)f * p.P);
  const int S = p.S;
  const int64_t L = p.L;
  const float nu = p.nu_grid[f];
  const float pp = p.p_grid[k];
  const float p2 = pp * pp;
  const float beta_inner = p.r_inner[0];
  const float r_max = p.r_outer[S - 1];
  const bool photosphere = pp < beta_inner;
  float z = photosphere ? zb(beta_inner, p2) : -zb(r_max, p2);
  int shell = photosphere ? 0 : S - 1;
  float intensity = photosphere ? p.i_inner[f] : 0.0f;

  // start line: the number of lines with nu_line >= nu_cmf(z0)
  const float nu_cmf0 = nu * (1.0f - z);
  int64_t lo = 0, hi = L;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (p.line_nu[mid] >= nu_cmf0) lo = mid + 1;
    else hi = mid;
  }
  int64_t line = lo;

  float z_seg = z;
  float escat = 0.0f;
  bool first = true;
  unsigned long long n_line = 0, n_boundary = 0;
  bool active = pp < r_max;
  int64_t ev = 0;
  while (active) {
    if (ev >= p.max_events) {
      atomicAdd(&sh_counts[2], 1ull);
      break;
    }
    ++ev;
    const float chi = p.chi_e[shell];
    const float r_in = p.r_inner[shell];
    const bool reaches_inner = (z < 0.0f) && (p2 < r_in * r_in);
    const float z_bound = reaches_inner ? -zb(r_in, p2) : zb(p.r_outer[shell], p2);
    const int64_t line_c = line < L - 1 ? line : L - 1;
    const bool has_line = line < L;
    const float zeta = 1.0f - p.line_nu[line_c] / nu;
    const float z_line = fmaxf(zeta, z);
    const int64_t row = (int64_t)shell * L;
    const float jb = p.j_blue[row + line_c];
    const float jr_prev = p.j_red[row + (line_c > 0 ? line_c - 1 : 0)];
    const float jbar_bound = 0.5f * (jr_prev + jb);
    if (has_line && z_line <= z_bound) {
      const float jbar = first ? jb : jbar_bound;
      const float d_es = ((z_line - z_seg) * chi) * (jbar - intensity);
      intensity = ((intensity + escat) + d_es) * p.exp_tau[row + line_c] +
                  p.att_S[row + line_c];
      escat = 0.0f;
      z = z_line;
      ++line;
      first = false;
      ++n_line;
    } else {
      escat = escat + ((z_bound - z_seg) * chi) * (jbar_bound - intensity);
      z = z_bound;
      shell += reaches_inner ? -1 : 1;
      active = shell >= 0 && shell < S;
      ++n_boundary;
    }
    z_seg = z;
  }
  p.i_p[ray] = intensity * pp;
  atomicAdd(&sh_counts[0], n_line);
  atomicAdd(&sh_counts[1], n_boundary);
}

__global__ void formal_integral_kernel(Params p) {
  __shared__ unsigned long long sh_counts[3];
  if (threadIdx.x < 3) sh_counts[threadIdx.x] = 0;
  __syncthreads();
  const int64_t ray = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (ray < (int64_t)p.F * p.P) integrate_ray(p, ray, sh_counts);
  __syncthreads();
  if (threadIdx.x < 3) atomicAdd(&p.counts[threadIdx.x], sh_counts[threadIdx.x]);
}

}  // namespace

extern "C" int formal_integral(
    const void* nu_grid, const void* p_grid, const void* r_inner,
    const void* r_outer, const void* chi_e, const void* line_nu,
    const void* exp_tau, const void* att_S, const void* j_red,
    const void* j_blue, const void* i_inner, int F, int P, int S, int64_t L,
    int64_t max_events, void* i_p, void* counts, void* stream) {
  Params p;
  p.nu_grid = (const float*)nu_grid;
  p.p_grid = (const float*)p_grid;
  p.r_inner = (const float*)r_inner;
  p.r_outer = (const float*)r_outer;
  p.chi_e = (const float*)chi_e;
  p.line_nu = (const float*)line_nu;
  p.exp_tau = (const float*)exp_tau;
  p.att_S = (const float*)att_S;
  p.j_red = (const float*)j_red;
  p.j_blue = (const float*)j_blue;
  p.i_inner = (const float*)i_inner;
  p.i_p = (float*)i_p;
  p.counts = (unsigned long long*)counts;
  p.L = L;
  p.max_events = max_events;
  p.F = F;
  p.P = P;
  p.S = S;
  const int64_t n_rays = (int64_t)F * P;
  if (n_rays > 0) {
    const int threads = 128;
    formal_integral_kernel<<<(unsigned)((n_rays + threads - 1) / threads), threads,
                             0, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
