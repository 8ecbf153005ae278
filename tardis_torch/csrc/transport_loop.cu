// K1 transport_loop: the Monte Carlo packet event loop of one iteration
// (classic mode: homologous flow, no continuum, scatter / downbranch /
// macroatom line interaction), with the iteration's luminosity summary.
//
// Replaces: tardis_tpu/transport/kernel.py:425 `make_transport_step` with
// `_step_uniforms` (:209), `_distance_boundary` (:256), `_chain_emission`
// (:329), tiled_search.py:468 `predicate_search_packed` and :67
// `tiled_searchsorted`, driven by `transport_loop` (:1121) / `run_transport`
// (:1177), plus transport/solver.py:142 `_device_summary`.
//
// Bound on the H100: memory latency, not bandwidth or arithmetic.  An event
// hashes four uniforms (threefry, ~700 integer operations), runs a
// dependent binary search of ~18 probes into the f64 tau prefix of its
// shell (29 MB at bench scale, resident in the 50 MB L2), and scatters four
// f64 atomics into the line difference array.  Design:
//   - one thread per packet walks the packet's whole life, so there are no
//     lockstep lanes, no refill and no repacking; threads that finish early
//     free their warp slot to the scheduler;
//   - the event search reads the flat f64 prefix directly (no two-float
//     pairs and no 128-ary packed rows, which only the TPU needed);
//   - the bulk j / nu-bar estimators and the luminosity sums go to S + a few
//     addresses, so they accumulate in shared memory and each block
//     flushes once with global f64 atomics; the line difference array is
//     spread over (L+1)*S*2 addresses, so it takes global f64 atomics;
//   - per-packet state stays f32, as in the JAX package; prefix
//     differences are taken in f64 and rounded to f32;
//   - tau_event = -log(u) is computed in f64 and rounded to f32, so the
//     plain PyTorch version (tardis_torch/transport/kernel.py) reproduces
//     this kernel bit for bit; built with --fmad=false for the same reason;
//   - a packet still alive after max_events events is stopped without
//     output and counted (summary[3]); the caller warns with the count;
//   - with a record capacity > 0 (the final iteration with virtual packets)
//     every birth and every interaction appends a spawn record
//     (kernel.py:520-545,987-1008).  The slot comes from one global counter,
//     taken once per group of converged threads (a warp-aggregated
//     atomicAdd); attempts past the capacity are counted and dropped, as
//     the JAX package's mode="drop" scatter does.  Slots race, so the record
//     order differs from run to run: compare records as a multiset.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kLineScatter = 0;
constexpr int kLineMacroatom = 2;
constexpr int kEvBoundary = 0;
constexpr int kEvLine = 1;
constexpr int kEvEscat = 2;
constexpr float kUMin = 1e-9f;

struct Params {
  const float* pool_mu;
  const float* pool_nu;
  const float* r_inner;
  const float* r_outer;
  const float* chi_e;
  const float* line_nu;
  const double* prefix;
  const int32_t* line2macro;
  const float* chain_cdf;
  const float* emit_cdf;
  float* out;          // (N, 2): signed nu, energy
  double* est_j;       // (S,)
  double* est_nubar;   // (S,)
  double* line_diff;   // ((L+1)*S*2,)
  double* summary;     // [emitted in window, reabsorbed, events, immortal]
  float* vp_records;   // (vp_capacity, 8) spawn records
  unsigned long long* vp_count;  // records attempted
  int64_t vp_capacity;
  int64_t n_packets;
  int64_t L;
  int64_t max_events;
  int S, M, W, We, mode, disable_line_scattering;
  float nu_lo, nu_hi;
  tardis::Key key;
};

__device__ __forceinline__ float draw(tardis::Key k, uint32_t column) {
  return tardis::uniform_f32(tardis::random_bits(k, column), kUMin, 1.0f);
}

// first index in [lo, hi) whose value is >= u (the count of entries < u on
// a non-decreasing CDF row)
__device__ __forceinline__ int cdf_lower_bound(const float* row, int n, float u) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (row[mid] < u) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// one spawn record [r, mu, nu, energy, shell, next_line, li_type, out_line]
__device__ __forceinline__ void spawn_record(const Params& p, float r, float mu,
                                             float nu, float energy, int shell,
                                             int64_t next_line, float li_type,
                                             float out_line) {
  namespace cg = cooperative_groups;
  cg::coalesced_group g = cg::coalesced_threads();
  unsigned long long base = 0;
  if (g.thread_rank() == 0) base = atomicAdd(p.vp_count, (unsigned long long)g.size());
  base = g.shfl(base, 0) + g.thread_rank();
  if (base < (unsigned long long)p.vp_capacity) {
    float4* row = reinterpret_cast<float4*>(p.vp_records + base * 8);
    row[0] = make_float4(r, mu, nu, energy);
    row[1] = make_float4((float)shell, (float)next_line, li_type, out_line);
  }
}

__device__ void walk_packet(const Params& p, int64_t pid, double* sh_j,
                            double* sh_nubar, double* sh_sum) {
  const int S = p.S;
  const int64_t L = p.L;
  const float beta_inner = p.r_inner[0];

  // birth: next_line = number of lines with nu_line >= nu_cmf
  float mu = p.pool_mu[pid];
  const float nu_cmf0 = p.pool_nu[pid];
  int64_t lo = 0, hi = L;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (p.line_nu[mid] >= nu_cmf0) lo = mid + 1;
    else hi = mid;
  }
  int64_t next_line = lo;
  const float inv_dop0 = 1.0f / (1.0f - mu * beta_inner);
  float nu = nu_cmf0 * inv_dop0;
  float energy = inv_dop0;
  float r = beta_inner;
  int shell = 0;
  const tardis::Key kp = tardis::fold_in(p.key, (uint32_t)pid);
  if (p.vp_capacity > 0)
    spawn_record(p, r, mu, nu, energy, 0, next_line, -1.0f, -1.0f);

  int64_t ev = 0;
  for (;; ++ev) {
    if (ev >= p.max_events) {
      atomicAdd(&sh_sum[3], 1.0);
      break;
    }
    const tardis::Key ke = tardis::fold_in(kp, (uint32_t)ev);
    const float chi = p.chi_e[shell];
    const float r_in = p.r_inner[shell];
    const float r_out = p.r_outer[shell];
    const float z = mu * r;
    const float dop = 1.0f - z;
    const float nu_cmf = nu * dop;

    // distance to the shell boundary; a tangential ray (mu == 0) grazes
    // and exits outward
    const float out_d =
        sqrtf(fmaxf(r_out * r_out + (mu * mu - 1.0f) * r * r, 0.0f)) - r * mu;
    const float check = r_in * r_in + r * r * (mu * mu - 1.0f);
    const bool hits_inner = (mu < 0.0f) && (check >= 0.0f);
    const float in_d = -r * mu - sqrtf(fmaxf(check, 0.0f));
    const float d_b = fmaxf(hits_inner ? in_d : out_d, 0.0f);
    const int delta = hits_inner ? -1 : 1;

    const float tau_event = (float)(-log((double)draw(ke, 0)));

    // event search: first i in [next_line, L] with i == L, or nu_i beyond
    // the boundary, or optical depth to line i above tau_event
    const double* prow = p.prefix + (int64_t)shell * (L + 1);
    const double c0 = prow[next_line];
    const float nu_thresh = nu * (1.0f - (z + d_b));
    lo = next_line;
    hi = L;
    while (lo < hi) {
      int64_t mid = (lo + hi) >> 1;
      const float nl = p.line_nu[mid];
      const float s = fmaxf((1.0f - nl / nu) - z, 0.0f);
      const float g = (float)(prow[mid + 1] - c0) + chi * s;
      if ((nl <= nu_thresh) || (g > tau_event)) hi = mid;
      else lo = mid + 1;
    }
    const int64_t i_ev = lo;
    const float nu_ev = i_ev < L ? p.line_nu[i_ev] : __int_as_float(0xff800000);
    const bool found = (i_ev < L) && (nu_ev > nu_thresh);
    const float s_ev = fmaxf((1.0f - nu_ev / nu) - z, 0.0f);
    const float tau_at = (float)(prow[i_ev] - c0);
    const float d_cont = fmaxf((tau_event - tau_at) / chi, 0.0f);
    const bool escat_f = p.disable_line_scattering || (d_cont < s_ev);
    const bool escat_nf = d_cont < d_b;
    int event;
    float distance;
    if (found) {
      event = escat_f ? kEvEscat : kEvLine;
      distance = escat_f ? d_cont : s_ev;
    } else {
      event = escat_nf ? kEvEscat : kEvBoundary;
      distance = escat_nf ? d_cont : d_b;
    }
    const int64_t end_line = (event == kEvLine) ? i_ev + 1 : i_ev;

    // estimators
    const float w_j = (energy * dop) * distance;
    atomicAdd(&sh_j[shell], (double)w_j);
    atomicAdd(&sh_nubar[shell], (double)(w_j * nu_cmf));
    if (end_line != next_line) {
      const float w1 = energy / (nu * nu);
      const float w2 = energy / nu;
      double* a = p.line_diff + (next_line * S + shell) * 2;
      double* b = p.line_diff + (end_line * S + shell) * 2;
      atomicAdd(a, (double)w1);
      atomicAdd(a + 1, (double)w2);
      atomicAdd(b, -(double)w1);
      atomicAdd(b + 1, -(double)w2);
    }

    // move
    const float r_new = sqrtf(fmaxf(
        r * r + distance * distance + 2.0f * r * distance * mu, 1e-20f));
    const float mu_new = (mu * r + distance) / r_new;

    if (event == kEvBoundary) {
      const int new_shell = shell + delta;
      if (new_shell >= S || new_shell < 0) {
        const bool emitted = new_shell >= S;
        p.out[2 * pid] = emitted ? nu : -nu;
        p.out[2 * pid + 1] = energy;
        if (emitted) {
          if (nu > p.nu_lo && nu < p.nu_hi) atomicAdd(&sh_sum[0], (double)energy);
        } else {
          atomicAdd(&sh_sum[1], (double)energy);
        }
        break;
      }
      shell = new_shell;
      r = r_new;
      mu = mu_new;
      next_line = end_line;
      continue;
    }

    // Thomson scatter or line interaction: new direction drawn in the CMF
    const float mu_draw = 2.0f * draw(ke, 1) - 1.0f;
    const float dop_old_pos = 1.0f - mu_new * r_new;
    const float inv_dop_new = 1.0f / (1.0f - mu_draw * r_new);
    if (event == kEvEscat) {
      nu = nu * dop_old_pos * inv_dop_new;
      next_line = end_line;
    } else {
      int64_t em_line = i_ev;
      float nu_em = nu_ev;
      if (p.mode != kLineScatter) {
        int j = p.line2macro[i_ev];
        const int64_t row0 = (int64_t)shell * p.M;
        if (p.mode == kLineMacroatom) {
          const float* row = p.chain_cdf + (row0 + j) * (p.W + 1);
          const int k = min(cdf_lower_bound(row, p.W, draw(ke, 6)), p.W - 1);
          j = (int)row[p.W] + k;
        }
        const float* erow = p.emit_cdf + (row0 + j) * (3 * p.We);
        const int k2 = min(cdf_lower_bound(erow, p.We, draw(ke, 7)), p.We - 1);
        em_line = (int64_t)erow[p.We + k2];
        nu_em = erow[2 * p.We + k2];
      }
      nu = nu_em * inv_dop_new;
      next_line = em_line + 1;
    }
    energy = energy * dop_old_pos * inv_dop_new;
    r = r_new;
    mu = mu_draw;
    if (p.vp_capacity > 0) {
      const bool line = event == kEvLine;
      spawn_record(p, r, mu, nu, energy, shell, next_line, line ? 2.0f : 1.0f,
                   line ? (float)(next_line - 1) : -1.0f);
    }
  }
  atomicAdd(&sh_sum[2], (double)(ev + 1 > p.max_events ? p.max_events : ev + 1));
}

__global__ void transport_loop_kernel(Params p) {
  extern __shared__ double shm[];
  double* sh_j = shm;
  double* sh_nubar = shm + p.S;
  double* sh_sum = shm + 2 * p.S;
  for (int i = threadIdx.x; i < 2 * p.S + 4; i += blockDim.x) shm[i] = 0.0;
  __syncthreads();
  const int64_t pid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (pid < p.n_packets) walk_packet(p, pid, sh_j, sh_nubar, sh_sum);
  __syncthreads();
  for (int i = threadIdx.x; i < p.S; i += blockDim.x) {
    atomicAdd(&p.est_j[i], sh_j[i]);
    atomicAdd(&p.est_nubar[i], sh_nubar[i]);
  }
  if (threadIdx.x < 4) atomicAdd(&p.summary[threadIdx.x], sh_sum[threadIdx.x]);
}

}  // namespace

extern "C" int transport_loop(
    const void* pool_mu, const void* pool_nu, int64_t n_packets,
    const void* r_inner, const void* r_outer, const void* chi_e,
    const void* line_nu, const void* prefix, const void* line2macro,
    const void* chain_cdf, const void* emit_cdf, int64_t L, int S, int M,
    int W, int We, int mode, int disable_line_scattering, uint32_t k0,
    uint32_t k1, float nu_lo, float nu_hi, int64_t max_events, void* out,
    void* est_j, void* est_nubar, void* line_diff, void* summary,
    void* vp_records, void* vp_count, int64_t vp_capacity, void* stream) {
  Params p;
  p.pool_mu = (const float*)pool_mu;
  p.pool_nu = (const float*)pool_nu;
  p.r_inner = (const float*)r_inner;
  p.r_outer = (const float*)r_outer;
  p.chi_e = (const float*)chi_e;
  p.line_nu = (const float*)line_nu;
  p.prefix = (const double*)prefix;
  p.line2macro = (const int32_t*)line2macro;
  p.chain_cdf = (const float*)chain_cdf;
  p.emit_cdf = (const float*)emit_cdf;
  p.out = (float*)out;
  p.est_j = (double*)est_j;
  p.est_nubar = (double*)est_nubar;
  p.line_diff = (double*)line_diff;
  p.summary = (double*)summary;
  p.vp_records = (float*)vp_records;
  p.vp_count = (unsigned long long*)vp_count;
  p.vp_capacity = vp_capacity;
  p.n_packets = n_packets;
  p.L = L;
  p.max_events = max_events;
  p.S = S;
  p.M = M;
  p.W = W;
  p.We = We;
  p.mode = mode;
  p.disable_line_scattering = disable_line_scattering;
  p.nu_lo = nu_lo;
  p.nu_hi = nu_hi;
  p.key = tardis::Key{k0, k1};
  if (n_packets > 0) {
    const int threads = 128;
    const size_t shm = (size_t)(2 * S + 4) * sizeof(double);
    transport_loop_kernel<<<(unsigned)((n_packets + threads - 1) / threads),
                            threads, shm, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
