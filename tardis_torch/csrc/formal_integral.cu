// K5 formal_integral: the emergent intensity of every (frequency, impact
// parameter) ray through the source-function tables (Lucy 1999).
//
// Replaces: tardis_tpu/spectrum/formal_integral.py:137 `_integrate_rays`, a
// lockstep while_loop over all F x P rays with one event per step.
//
// Bound on the H100: a ray's events are a serial recurrence in its
// intensity I, one line resonance or shell boundary after another (119 on
// average at bench scale, 640 on the longest ray: 80,000 rays, 7,947,657
// line and 1,596,000 boundary events), and with one thread a ray each event
// first waited on its own loads of the line's frequency and of two to four
// entries of the (S, L) tables (58.6 MB, more than the L2); the one wave of
// 80,000 threads then lasted as long as its longest ray.  Which lines a ray
// meets, where (z_line), the electron-scattering path before each (z_seg),
// the mean intensities and the tables' entries follow from the geometry
// alone; only four f32 operations an event take the previous I.  Design:
//   - a group of kGroup = 4 lanes a ray, 8 rays a warp; persistent warps
//     (as many as are resident) whose groups take rays from a counter
//     (tardis::WarpRange, one atomic a warp's refill);
//   - rays handed out by impact parameter, the longest chord through the
//     shells first (each block ranks the P impact parameters once), every
//     frequency of one before the next: the longest rays start first and
//     the last ones handed out are short;
//   - a fresh ray's start line, the count of lines with nu_line >=
//     nu (1 - z0), by a 4-ary search of the descending line list: each round
//     the group's lanes probe evenly spaced lines and a ballot keeps the
//     bracket between the last that holds and the first that does not;
//   - a shell's run of line events kGroup lines at a time: lane k takes the
//     run's k-th next line, its frequency and its four table entries
//     (coalesced along the shell's row, the tables laid out (S, L)), and
//     computes z_line = max(zeta, z) (zeta rises with the line index, so the
//     running maximum of the plain loop is that of the chunk's first z), the
//     electron-scattering weight (z_line - z_seg) chi with z_seg the
//     previous lane's z_line, and the mean intensity (J_blue for the ray's
//     first line, else the average with the previous line's J_red); a ballot
//     of z_line <= z_bound ends the run at its first failing lane;
//   - the recurrence then walks the chunk's events from the warp's shared
//     memory (each lane of the group holds the same I), in the plain
//     version's order of f32 operations: I = ((I + escat) + w (J - I))
//     e^-tau + S, the next event's terms read while the current one's
//     arithmetic runs.  No parallel scan of the affine maps: it would
//     reassociate the sums;
//   - the next chunk's loads go out before the recurrence starts: its lines
//     do not depend on I (the run's next lines, or, where the run ends, the
//     next shell's row from the same line);
//   - a boundary event adds the electron-scattering source with the
//     boundary's averaged J (the next line's, lane n of the chunk) and moves
//     to the next shell, as the JAX step;
//   - the runs are short (5 lines on average between two boundaries), so a
//     wider group spends its lanes on lines past the boundary: on an H100
//     80GB HBM3 at 700 W groups of 2, 4, 8, 16 and 32 lanes took 0.36,
//     0.27, 0.31, 0.42 and 0.67 ms (the longest ray alone 0.28, 0.15, 0.09,
//     0.06 and 0.04 ms); at most 64 registers, 32 warps an SM;
//   - built with --fmad=false, so the plain PyTorch version
//     (tardis_torch/spectrum/formal_integral.py) gives the same bits per
//     ray;
//   - a ray still going after max_events events (L + 2S + 2, more than a
//     ray can meet) is stopped and counted; line and boundary events are
//     counted too, summed per block in shared memory, for the bound.
#include <cuda_runtime.h>
#include <cstdint>

#include "queue.cuh"


namespace {

constexpr int kWarps = 8;  // warps a block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroup = 4;  // lanes a ray
constexpr unsigned kGroupBits = kGroup == 32 ? kFull : (1u << kGroup) - 1u;
// rays a warp takes from the counter at a time: one for each of its groups
constexpr unsigned long long kRayRange = 32 / kGroup;

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

// what lane k of a group reads of the k-th line from ``line`` on in one
// shell's row: the line's frequency, J_blue, the previous line's J_red,
// e^-tau and the attenuated source (the last line stands in past the
// list's end)
struct ChunkLoads {
  float line_nu, jb, jr_prev, e, s;
};

__device__ __forceinline__ ChunkLoads load_chunk(const Params& p, int64_t row, int64_t line,
                                                 int k) {
  const int64_t i = line + k;
  const int64_t ic = i < p.L ? i : p.L - 1;
  return ChunkLoads{p.line_nu[ic], p.j_blue[row + ic], p.j_red[row + (ic > 0 ? ic - 1 : 0)],
                    p.exp_tau[row + ic], p.att_S[row + ic]};
}

// a ray's state, the same in every lane of its group
struct Ray {
  int64_t id = 0, line = 0, ev = 0;
  float nu = 0.0f, pp = 0.0f, p2 = 0.0f, z = 0.0f, z_seg = 0.0f, intensity = 0.0f,
        escat = 0.0f;
  int shell = 0;
  bool first = true;
};

// Every group of kGroup lanes walks one ray; the warp runs one chunk step
// of each of its rays a loop iteration, all lanes converged.
// four blocks an SM: at most 64 registers a lane
__global__ void __launch_bounds__(kWarps * 32, 4)
    formal_integral_kernel(Params p, unsigned long long* taken) {
  __shared__ unsigned long long sh_counts[3];
  __shared__ float4 terms[kWarps][32];
  extern __shared__ int order[];  // impact parameters, longest chord first
  if (threadIdx.x < 3) sh_counts[threadIdx.x] = 0;
  {
    const float rin2 = p.r_inner[0] * p.r_inner[0];
    const float rmax2 = p.r_outer[p.S - 1] * p.r_outer[p.S - 1];
    auto chord = [&](int j) {
      const float q2 = p.p_grid[j] * p.p_grid[j];
      if (!(q2 < rmax2)) return 0.0f;
      const float out = sqrtf(rmax2 - q2);
      return q2 < rin2 ? out - sqrtf(rin2 - q2) : 2.0f * out;
    };
    for (int j = threadIdx.x; j < p.P; j += blockDim.x) {
      const float cj = chord(j);
      int rank = 0;
      for (int i = 0; i < p.P; ++i) {
        const float ci = chord(i);
        rank += (ci > cj || (ci == cj && i < j)) ? 1 : 0;
      }
      order[rank] = j;
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = lane % kGroup;        // the lane's place in its group
  const int base = lane - k;          // the group's first lane
  const int S = p.S;
  const int64_t L = p.L;
  const unsigned long long n_rays = (unsigned long long)p.F * p.P;
  const float beta_inner = p.r_inner[0];
  const float r_max = p.r_outer[S - 1];
  unsigned long long n_line = 0, n_boundary = 0, n_capped = 0;
  tardis::WarpRange range;
  Ray ray;
  ChunkLoads c{};
  bool have = false, done = false;
  for (;;) {
    // groups without a ray take the next ids, consecutive in group order
    const unsigned need = __ballot_sync(kFull, k == 0 && !have && !done);
    bool fresh = false;
    if (need != 0) {
      unsigned long long id = range.take<kRayRange>(taken, need, lane);
      id = __shfl_sync(kFull, id, base);
      if (!have && !done) {
        if (id >= n_rays) {
          done = true;
        } else {
          // rays in order of their impact parameter's chord, longest
          // first, every frequency of one before the next
          const int r = (int)(id / p.F);
          const int f = (int)(id - (unsigned long long)r * p.F);
          const int j = order[r];
          ray = Ray{};
          ray.id = (int64_t)f * p.P + j;
          ray.nu = p.nu_grid[f];
          ray.pp = p.p_grid[j];
          ray.p2 = ray.pp * ray.pp;
          const bool photosphere = ray.pp < beta_inner;
          ray.z = photosphere ? zb(beta_inner, ray.p2) : -zb(r_max, ray.p2);
          ray.z_seg = ray.z;
          ray.shell = photosphere ? 0 : S - 1;
          ray.intensity = photosphere ? p.i_inner[f] : 0.0f;
          if (ray.pp < r_max) {
            fresh = true;
            have = true;
          } else if (k == 0) {
            p.i_p[ray.id] = ray.intensity * ray.pp;  // a ray that misses the shells
          }
        }
      }
    }
    if (__ballot_sync(kFull, have) == 0) {
      if (__ballot_sync(kFull, !done) == 0) break;
      continue;
    }
    // a fresh ray's start line, the count of lines with nu_line >=
    // nu (1 - z0), by a kGroup-ary search: the group's probes that hold form
    // a prefix, and the answer lies after the last of them and at or
    // before the next probe
    if (__ballot_sync(kFull, fresh) != 0) {
      int64_t lo = 0, hi = fresh ? L : 0;
      const float x = ray.nu * (1.0f - ray.z);
      for (;;) {
        const bool searching = lo < hi;
        if (__ballot_sync(kFull, searching) == 0) break;
        const int64_t step = (hi - lo + kGroup - 1) / kGroup;
        const int64_t probe = lo + (int64_t)k * step;
        const bool holds = searching && probe < hi && p.line_nu[probe] >= x;
        const int n = __popc((__ballot_sync(kFull, holds) >> base) & kGroupBits);
        if (searching) {
          if (n == 0) {
            hi = lo;
          } else {
            const int64_t next = lo + (int64_t)n * step;
            hi = next < hi ? next : hi;
            lo = lo + (int64_t)(n - 1) * step + 1;
          }
        }
      }
      if (fresh) {
        ray.line = lo;
        c = load_chunk(p, (int64_t)ray.shell * L, ray.line, k);
      }
    }

    // one chunk step of every ray: the run's line events up to the first
    // line past the boundary, at most kGroup
    const int sc = ray.shell < 0 ? 0 : (ray.shell >= S ? S - 1 : ray.shell);
    const float chi = p.chi_e[sc];
    const float r_in = p.r_inner[sc];
    const bool reaches_inner = (ray.z < 0.0f) && (ray.p2 < r_in * r_in);
    const float z_bound = reaches_inner ? -zb(r_in, ray.p2) : zb(p.r_outer[sc], ray.p2);
    const float zeta = 1.0f - c.line_nu / ray.nu;
    const float z_line = fmaxf(zeta, ray.z);
    const unsigned ok =
        (__ballot_sync(kFull, have && ray.line + k < L && z_line <= z_bound) >> base) &
        kGroupBits;
    int n = ok == kGroupBits ? kGroup : __ffs(~ok) - 1;
    const int64_t left = p.max_events - ray.ev;
    if ((int64_t)n > left) n = (int)left;
    const bool run_ends = n < kGroup;
    // the next chunk is known before the recurrence runs: the run's next
    // lines, or, where the run ends, the next shell's from the same line
    const int next_shell = run_ends ? ray.shell + (reaches_inner ? -1 : 1) : ray.shell;
    ChunkLoads next = c;
    if (have && next_shell >= 0 && next_shell < S)
      next = load_chunk(p, (int64_t)next_shell * L, ray.line + n, k);
    const float z_prev = __shfl_up_sync(kFull, z_line, 1, kGroup);
    const float zs = k == 0 ? ray.z_seg : z_prev;
    const float jbar_bound = 0.5f * (c.jr_prev + c.jb);
    const float jbar = (ray.first && k == 0) ? c.jb : jbar_bound;
    __syncwarp();
    terms[warp][lane] = make_float4((z_line - zs) * chi, jbar, c.e, c.s);
    __syncwarp();
    // the recurrence, in the plain version's order of f32 operations; the
    // next event's terms are read while the current one's arithmetic runs
    const int n_max = (int)__reduce_max_sync(kFull, (unsigned)n);
    float4 t_next = terms[warp][base];
    for (int t = 0; t < n_max; ++t) {
      const float4 cur = t_next;
      if (t + 1 < n_max) t_next = terms[warp][base + t + 1];
      if (t < n) {
        const float d_es = cur.x * (cur.y - ray.intensity);
        ray.intensity = ((ray.intensity + ray.escat) + d_es) * cur.z + cur.w;
        ray.escat = 0.0f;
      }
    }
    const float z_last = __shfl_sync(kFull, z_line, n > 0 ? n - 1 : 0, kGroup);
    const float jbar_next = __shfl_sync(kFull, jbar_bound, n < kGroup ? n : kGroup - 1, kGroup);
    if (have) {
      if (n > 0) {
        ray.z = z_last;
        ray.z_seg = ray.z;
        ray.line += n;
        ray.ev += n;
        ray.first = false;
        if (k == 0) n_line += (unsigned long long)n;
      }
      bool ended = false;
      if (ray.ev >= p.max_events) {
        ended = true;
        if (k == 0) ++n_capped;
      } else if (run_ends) {
        // the boundary event: electron scattering with the next line's
        // mean J (lane n of the chunk), then the next shell
        ray.escat = ray.escat + ((z_bound - ray.z_seg) * chi) * (jbar_next - ray.intensity);
        ray.z = z_bound;
        ray.z_seg = ray.z;
        ray.shell = next_shell;
        ray.ev += 1;
        if (k == 0) ++n_boundary;
        if (ray.shell < 0 || ray.shell >= S) {
          ended = true;
        } else if (ray.ev >= p.max_events) {
          ended = true;
          if (k == 0) ++n_capped;
        }
      }
      if (ended) {
        if (k == 0) p.i_p[ray.id] = ray.intensity * ray.pp;
        have = false;
      }
      c = next;
    }
  }
  if (k == 0) {
    atomicAdd(&sh_counts[0], n_line);
    atomicAdd(&sh_counts[1], n_boundary);
    atomicAdd(&sh_counts[2], n_capped);
  }
  __syncthreads();
  if (threadIdx.x < 3) atomicAdd(&p.counts[threadIdx.x], sh_counts[threadIdx.x]);
}

}  // namespace

extern "C" int formal_integral(
    const void* nu_grid, const void* p_grid, const void* r_inner,
    const void* r_outer, const void* chi_e, const void* line_nu,
    const void* exp_tau, const void* att_S, const void* j_red,
    const void* j_blue, const void* i_inner, int F, int P, int S, int64_t L,
    int64_t max_events, void* i_p, void* counts, void* taken, void* stream) {
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
  if (taken == nullptr || L < 1) return (int)cudaErrorInvalidValue;
  const int64_t n_rays = (int64_t)F * P;
  if (n_rays > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(taken, 0, sizeof(unsigned long long), s);
    if (err != cudaSuccess) return (int)err;
    unsigned blocks = 0;
    const size_t shm = (size_t)P * sizeof(int);
    err = tardis::persistent_blocks(formal_integral_kernel, kWarps * 32, shm, n_rays * kGroup,
                                    &blocks);
    if (err != cudaSuccess) return (int)err;
    formal_integral_kernel<<<blocks, kWarps * 32, shm, s>>>(p, (unsigned long long*)taken);
  }
  return (int)cudaGetLastError();
}
