// K6 gamma_step: one time step of gamma-ray packet transport through the
// expanding ejecta (Compton scatter, photoabsorption, pair creation, shell
// and time-step boundaries), with the per-shell deposition, the escape
// histogram and the path-length estimators.
//
// Replaces: tardis_tpu/energy_input/gamma_kernel.py:249
// `gamma_step_transport` with `sample_kn_cos` (:218), the opacities
// (:54-186: compton_opacity, photoabsorption_opacity(_kasen),
// pair_creation_opacity(_artis), average_compton_fraction,
// deposition_estimator_kasen) and utils/search.py:16
// `searchsorted_unrolled`.
//
// Bound on the H100.  On the gamma-ray workflow's path a step moves
// 0.8-4.5% of the pool (the packets born in the step and those still in
// flight), scattered over it, since the pool is drawn at random: the least
// time of a step is the pass-through of every packet's state (~56 bytes a
// packet, 0.07 ms at 4,194,304) plus the movers' events.  Each event is
// dependent arithmetic: two to five hashed uniforms (a fold_in of the step
// key by the event count, then one per column: ~600 integer operations at
// most), two to four f64 transcendental calls rounded to f32, and on a
// Compton event a bilinear lookup of the Klein-Nishina table and an f64
// cos.  Design, two launches a step:
//   1. gamma_compact, one thread a slot: copies the state of every packet
//      that does not move to the outputs with 0 events, and appends the
//      index of every packet of status 0 to a list on the card (one
//      atomicAdd a warp).  The count stays on the card: the host never
//      waits for it;
//   2. gamma_walk, a persistent grid (as many blocks as are resident),
//      each block staging the tables (KN 64 x 128, the energy edges, the
//      100 quadrature points: 33 KB) in shared memory once.  Each lane
//      takes the next list entry from a counter (a warp-aggregated
//      atomicAdd) up to the count, runs one event per loop iteration, and
//      when its packet ends (the end of the step, its death or max_steps
//      events) writes it at its own index and takes the next.  No lane
//      waits on another lane's packet while the list has work, and no
//      block is spent on slots that do not move.
//   The JAX package steps every packet of status 0 on each lockstep
//   iteration, so its global iteration is the packet's own event count and
//   packet i's draws are random_bits(fold_in(fold_in(key, event), j),
//   counter i): a lane reproduces them from the index alone, so a packet
//   ends bit for bit the same whichever lane walks it.  The columns are
//   hashed only where an event reads them (the bits are counter-based, so
//   a lazy draw is the same draw).
//   Sums: each lane adds its deposition and its three estimator terms in
//   f64 registers while its packets stay in one shell, and adds them to
//   the block's shared f64 sums when the shell changes and when the lane
//   leaves; each escaping packet adds its weight to the shared escape
//   histogram; each block adds its sums to the outputs with global f64
//   atomics once (the JAX package sums f32 per lockstep iteration).
//   The Kasen deposition estimator's mean Compton fraction (the 100-point
//   quadrature, its terms in f32 and its two sums in f64 in the order of
//   the points, as the plain version sums them) depends on the energy
//   alone, which changes only at a Compton scatter or a pair creation:
//   each lane keeps the last value with the energy it was computed for.
//   log, cos and the fractional powers (-3.13, -3.0, -3.5) are taken in
//   f64 and rounded to f32, divisions are true divisions, and the build
//   uses --fmad=false, so the plain PyTorch version
//   (tardis_torch/energy_input/gamma_kernel.py) reproduces every packet
//   bit for bit; the f32 constants come from the wrapper (GammaConstants).
//
// Options, each a compile-time template parameter chosen by -D flags
// (GS_GREY, GS_KASEN, GS_ARTIS, GS_ESTIMATORS): the grey absorption
// (Compton and pair creation off), the Kasen photoabsorption, the ARTIS
// pair creation, and the three path-length estimators.
#include <cuda_runtime.h>
#include <cstdint>

#include "queue.cuh"
#include "threefry.cuh"

#ifndef GS_GREY
#define GS_GREY 0
#endif
#ifndef GS_KASEN
#define GS_KASEN 0
#endif
#ifndef GS_ARTIS
#define GS_ARTIS 0
#endif
#ifndef GS_ESTIMATORS
#define GS_ESTIMATORS 0
#endif

// the opacities' f32 constants; laid out as GammaConstants in
// tardis_torch/energy_input/gamma_kernel.py
struct GammaConstants {
  float rest_kev, sigma_t, si_coef, fe_coef, mass_si, mass_fe, pair_si, pair_fe,
      kasen_coef, sqrt2, m_p, pcs_coef, two_pi;
};

namespace {

constexpr float kUMin = 1e-9f;
constexpr int kQuadrature = 100;
constexpr int kStatusActive = 0, kStatusEscaped = 1, kStatusAbsorbed = 2,
              kStatusTime = 3;
constexpr int kCompactThreads = 256;
constexpr int kWalkThreads = 256;

struct Params {
  const float* r;
  const float* mu;
  const float* energy;
  const float* weight;
  const int32_t* shell;
  const int32_t* status;
  const float* budget;
  const float* r_inner;
  const float* r_outer;
  const float* electron_density;
  const float* density;
  const float* iron;
  const float* kasen_z4;
  const float* kn_log_e;   // (n_e,)
  const float* kn_table;   // (n_e, n_q)
  const float* ebin_edges;  // (E+1,)
  const float* mus;        // (100,) quadrature points
  float* r_out;
  float* mu_out;
  float* energy_out;
  float* weight_out;
  int32_t* shell_out;
  int32_t* status_out;
  double* deposition;   // (S,)
  double* escape_hist;  // (E,)
  double* estimators;   // (3, S)
  int32_t* events;      // (B,)
  int64_t n_packets;
  int S, E, n_e, n_q, max_steps;
  float grey;
  tardis::Key key;
  GammaConstants c;
};

__device__ __forceinline__ float uniform(tardis::Key k, uint32_t counter, float lo) {
  return tardis::uniform_f32(tardis::random_bits(k, counter), lo, 1.0f);
}

__device__ __forceinline__ float kappa_e(const GammaConstants& c, float e) {
  return e / c.rest_kev;
}

__device__ __forceinline__ float pow_f64(float x, double exponent) {
  return (float)pow((double)x, exponent);
}

__device__ __forceinline__ float compton_opacity(const GammaConstants& c, float e,
                                                 float ne) {
  const float k = fmaxf(kappa_e(c, e), 1e-6f);
  float s;
  if (k < 0.05f) {
    s = 1.0f - 2.0f * k + 5.2f * k * k;
  } else {
    const float a = 1.0f + 2.0f * k;
    const float log_a = (float)log((double)a);
    s = 0.75f * ((1.0f + k) / (k * k * k) * (2.0f * k * (1.0f + k) / a - log_a) +
                 log_a / (2.0f * k) - (1.0f + 3.0f * k) / (a * a));
  }
  return ne * (c.sigma_t * s);
}

// f32 values below the smallest normal flushed to zero
__device__ __forceinline__ float flush_subnormal(float x) {
  return fabsf(x) < 1.17549435e-38f ? 0.0f : x;
}

// the product coefficient x (E / 100 keV)^-n x rho leaves f32's normal
// range in thin ejecta; the JAX package's platforms flush it to zero, and
// so does the port (the plain version's flush_subnormal)
__device__ __forceinline__ float photoabsorption_opacity(const GammaConstants& c,
                                                         float e, float rho,
                                                         float f) {
  const float x = e / 100.0f;
  const float si =
      flush_subnormal(c.si_coef * pow_f64(x, -3.13) * rho) / c.mass_si * (1.0f - f);
  const float fe = flush_subnormal(c.fe_coef * pow_f64(x, -3.0) * rho) / c.mass_fe * f;
  return si + fe;
}

__device__ __forceinline__ float photoabsorption_opacity_kasen(const GammaConstants& c,
                                                               float e, float z4) {
  const float k = fmaxf(kappa_e(c, e), 1e-6f);
  return c.kasen_coef * c.sqrt2 * pow_f64(k, -3.5) * z4;
}

__device__ __forceinline__ float pair_creation_opacity(const GammaConstants& c,
                                                       float e, float rho, float f) {
  const float mult = rho * (c.pair_si * (1.0f - f) + c.pair_fe * f);
  const float e_mev = e / 1000.0f;
  if (e >= 1500.0f) return mult * (0.0481f + 0.301f * (e_mev - 1.5f)) * 1.0e-27f;
  if (e > 1022.0f) return mult * 1.0063f * (e_mev - 1.022f) * 1.0e-27f;
  return 0.0f;
}

__device__ __forceinline__ float pair_creation_opacity_artis(const GammaConstants& c,
                                                             float e, float rho,
                                                             float f) {
  if (!(e > 1022.0f)) return 0.0f;
  const bool high = e > 1500.0f;
  const float si = high ? (0.0481f + 0.301f * (e - 1500.0f)) * 196.0e-27f
                        : 1.0063f * (e - 1022.0f) * 196.0e-27f;
  const float fe = high ? (0.0481f + 0.301f * (e - 1500.0f)) * 784.0e-27f
                        : 1.0063f * (e - 1022.0f) * 784.0e-27f;
  const float per_p = rho / c.m_p;
  const float op_si = si * (per_p / 28.0f);
  const float op_fe = fe * (per_p / 56.0f);
  return op_fe * f + op_si * (1.0f - f);
}

// mean retained energy fraction over the Klein-Nishina angles: 100-point
// quadrature, f32 terms, f64 sums in the order of the points
__device__ __forceinline__ float average_compton_fraction(const GammaConstants& c,
                                                          const float* mus, float e) {
  const float x = kappa_e(c, e);
  double num = 0.0, den = 0.0;
  for (int j = 0; j < kQuadrature; ++j) {
    const float mu = mus[j];
    const float f = 1.0f / (1.0f + x * (1.0f - mu));
    const float cs = f * f * (f + 1.0f / f - (1.0f - mu * mu));
    num += (double)(cs * f);
    den += (double)cs;
  }
  return (float)(num / den);
}

// cos theta by bilinear lookup of the inverse-CDF table at (log E, u)
__device__ __forceinline__ float sample_kn_cos(const Params& p, const float* log_e,
                                               const float* table, float e, float u) {
  const int n_e = p.n_e, n_q = p.n_q;
  const float le = (float)log((double)fmaxf(e, 1.0f));
  const float fi = (le - log_e[0]) / (log_e[n_e - 1] - log_e[0]) * (float)(n_e - 1);
  const int i0 = min(max((int)fi, 0), n_e - 2);
  const float wi = fminf(fmaxf(fi - (float)i0, 0.0f), 1.0f);
  const float fq = u * (float)(n_q - 1);
  const int q0 = min(max((int)fq, 0), n_q - 2);
  const float wq = fq - (float)q0;
  const float* row0 = table + i0 * n_q + q0;
  const float* row1 = row0 + n_q;
  return (1.0f - wi) * ((1.0f - wq) * row0[0] + wq * row0[1]) +
         wi * ((1.0f - wq) * row1[0] + wq * row1[1]);
}

// a packet in a lane: its state and its index in the pool
struct Packet {
  float r, mu, e, w, budget;
  int shell, status, ev;
  uint32_t i;
};

// a lane's sums while its packets stay in shell ``sh`` (-1: none yet)
struct Run {
  int sh = -1;
  double dep = 0.0;
  double est[3] = {0.0, 0.0, 0.0};
};

// the mean Compton fraction ``frac`` of energy ``e`` (no energy is negative)
struct FracCache {
  float e = -1.0f;
  float frac = 0.0f;
};

// the tables a block stages in shared memory
struct Tables {
  const float* log_e;
  const float* kn;
  const float* edges;
  const float* mus;
};

template <bool kEst>
__device__ __forceinline__ void flush(Run& run, int S, double* sh_dep, double* sh_est) {
  if (run.sh < 0) return;
  if (run.dep != 0.0) atomicAdd(&sh_dep[run.sh], run.dep);
  run.dep = 0.0;
  if constexpr (kEst) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (run.est[k] != 0.0) atomicAdd(&sh_est[k * S + run.sh], run.est[k]);
      run.est[k] = 0.0;
    }
  }
}

// one event of packet q (status 0): the move to the interaction, the shell
// boundary or the end of the step, and what happens there
template <bool kGrey, bool kKasen, bool kArtis, bool kEst>
__device__ __forceinline__ void event(const Params& p, const Tables& t, Packet& q,
                                      Run& run, FracCache& fc, double* sh_dep,
                                      double* sh_esc, double* sh_est) {
  const GammaConstants& c = p.c;
  const int S = p.S;
  const float r = q.r, mu = q.mu, e = q.e, w = q.w;
  const tardis::Key k = tardis::fold_in(p.key, (uint32_t)q.ev);
  const uint32_t ctr = q.i;
  const int sh = min(max(q.shell, 0), S - 1);
  if (sh != run.sh) {
    flush<kEst>(run, S, sh_dep, sh_est);
    run.sh = sh;
  }
  const float rho = p.density[sh];
  const float ne = p.electron_density[sh];
  const float fe = p.iron[sh];
  float chi_c, chi_pa, chi_pp;
  if constexpr (kGrey) {
    chi_c = 0.0f;
    chi_pp = 0.0f;
    chi_pa = p.grey * rho;
  } else {
    chi_c = compton_opacity(c, e, ne);
    if constexpr (kKasen) chi_pa = photoabsorption_opacity_kasen(c, e, p.kasen_z4[sh]);
    else chi_pa = photoabsorption_opacity(c, e, rho, fe);
    if constexpr (kArtis) chi_pp = pair_creation_opacity_artis(c, e, rho, fe);
    else chi_pp = pair_creation_opacity(c, e, rho, fe);
  }
  const float chi_tot = chi_c + chi_pa + chi_pp;
  const float chi_floor = fmaxf(chi_tot, 1e-30f);
  const float u1 = uniform(tardis::fold_in(k, 0u), ctr, kUMin);
  const float tau = (float)(-log((double)u1));
  const float d_int = tau / chi_floor;

  const float r_in = p.r_inner[sh];
  const float r_o = p.r_outer[sh];
  const float out_d =
      sqrtf(fmaxf(r_o * r_o + (mu * mu - 1.0f) * (r * r), 0.0f)) - r * mu;
  const float check = r_in * r_in + (r * r) * (mu * mu - 1.0f);
  const bool hits_inner = (mu < 0.0f) && (check >= 0.0f);
  const float d_b =
      fmaxf(hits_inner ? -r * mu - sqrtf(fmaxf(check, 0.0f)) : out_d, 0.0f);
  const int delta = hits_inner ? -1 : 1;
  const float d_first = fminf(d_int, d_b);
  const float d = fminf(d_first, q.budget);
  const bool ev_time = q.budget <= d_first;
  const bool ev_bound = !ev_time && (d_b < d_int);
  const bool ev_int = !ev_time && !ev_bound;

  const float r_new = sqrtf(fmaxf(r * r + d * d + 2.0f * r * d * mu, 1e-10f));
  const float mu_new = (mu * r + d) / r_new;
  q.budget = q.budget - d;

  if constexpr (kEst) {
    if (e != fc.e) {
      fc.frac = average_compton_fraction(c, t.mus, e);
      fc.e = e;
    }
    // the deposition opacity reads the Compton and the tardis
    // photoabsorption opacities, which chi_c and chi_pa already are
    // outside the grey and Kasen modes
    const float chi_compton = kGrey ? compton_opacity(c, e, ne) : chi_c;
    const float chi_photo =
        (kGrey || kKasen) ? photoabsorption_opacity(c, e, rho, fe) : chi_pa;
    const float kap_dep = fc.frac * chi_compton + chi_photo;
    const float ff = 1.0f + kappa_e(c, e) * (1.0f - mu);
    const float pcs = c.pcs_coef / (ff * ff) * (ff + 1.0f / ff + mu * mu - 1.0f);
    run.est[0] += (double)(w * kap_dep * d);
    run.est[1] += (double)(w * pcs * d / ff);
    run.est[2] += (double)(chi_pp * (1022.0f / fmaxf(e, 1.0f)) * w * d);
  }

  float e_out = e, w_out = w, mu_out = mu_new;
  int new_status = ev_time ? kStatusTime : kStatusActive;
  if (ev_int) {
    const float u2 = uniform(tardis::fold_in(k, 1u), ctr, 0.0f);
    const float p_c = chi_c / chi_floor;
    const float p_pa = chi_pa / chi_floor;
    float dep;
    if (u2 < p_c) {  // Compton scatter
      const float u3 = uniform(tardis::fold_in(k, 2u), ctr, 0.0f);
      const float phi_u = uniform(tardis::fold_in(k, 3u), ctr, 0.0f);
      const float cos_t = sample_kn_cos(p, t.log_e, t.kn, e, u3);
      const float e_new = e / (1.0f + kappa_e(c, e) * (1.0f - cos_t));
      const float frac = e_new / e;
      const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
      const float sin_old = sqrtf(fmaxf(1.0f - mu_new * mu_new, 0.0f));
      const float cos_phi = (float)cos((double)(c.two_pi * phi_u));
      mu_out = fminf(fmaxf(mu_new * cos_t + sin_old * sin_t * cos_phi, -1.0f), 1.0f);
      dep = w * (1.0f - frac);
      e_out = e_new;
      w_out = w * frac;
    } else if (u2 < p_c + p_pa) {  // photoabsorption
      dep = w;
      new_status = kStatusAbsorbed;
    } else {  // pair creation: one 511 keV packet, isotropic
      const float phi_u = uniform(tardis::fold_in(k, 3u), ctr, 0.0f);
      const float pair_frac = fminf(fmaxf(1022.0f / fmaxf(e, 511.0f), 0.0f), 1.0f);
      dep = w * (1.0f - pair_frac);
      e_out = 511.0f;
      w_out = w * pair_frac;
      mu_out = 2.0f * phi_u - 1.0f;
    }
    run.dep += (double)dep;
  }
  if (ev_bound) {
    const int new_shell = q.shell + delta;
    if (new_shell >= S) {
      // the escape spectrum: last edge <= E (side right), clipped
      int lo = 0, hi = p.E + 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (t.edges[mid] <= e_out) lo = mid + 1;
        else hi = mid;
      }
      atomicAdd(&sh_esc[min(max(lo - 1, 0), p.E - 1)], (double)w_out);
      new_status = kStatusEscaped;
    } else if (new_shell < 0) {
      new_status = kStatusAbsorbed;
    } else {
      q.shell = new_shell;
    }
  }
  q.r = r_new;
  q.mu = mu_out;
  q.e = e_out;
  q.w = w_out;
  q.status = new_status;
}

// Launch 1: the pass-through of every packet that does not move (state and
// 0 events; a packet that entered inactive keeps its budget, which is not
// an output: the workflow sets it anew every step), and the list of the
// packets of status 0, appended a warp at a time; counters[0] ends as
// their number
__global__ void __launch_bounds__(kCompactThreads)
    gamma_compact(Params p, uint32_t* counters, uint32_t* list) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < p.n_packets;
  const bool moves = in && p.status[i] == kStatusActive;
  if (in && !moves) {
    p.r_out[i] = p.r[i];
    p.mu_out[i] = p.mu[i];
    p.energy_out[i] = p.energy[i];
    p.weight_out[i] = p.weight[i];
    p.shell_out[i] = p.shell[i];
    p.status_out[i] = p.status[i];
    p.events[i] = 0;
  }
  const unsigned movers = __ballot_sync(0xffffffffu, moves);
  if (movers == 0u) return;
  const unsigned lane = threadIdx.x & 31u;
  unsigned base = 0u;
  if (lane == 0u) base = atomicAdd(&counters[0], (unsigned)__popc(movers));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (moves) list[base + __popc(movers & ((1u << lane) - 1u))] = (uint32_t)i;
}

// Launch 2: the persistent grid over the list (counters[0] entries, taken
// through counters[1])
template <bool kGrey, bool kKasen, bool kArtis, bool kEst>
__global__ void __launch_bounds__(kWalkThreads)
    gamma_walk(Params p, uint32_t* counters, const uint32_t* list) {
  extern __shared__ double shm[];
  const int S = p.S, E = p.E;
  const int n_acc = S + E + (kEst ? 3 * S : 0);
  double* sh_dep = shm;
  double* sh_esc = shm + S;
  double* sh_est = shm + S + E;
  float* sh_kn = reinterpret_cast<float*>(shm + n_acc);
  float* sh_log_e = sh_kn + p.n_e * p.n_q;
  float* sh_edges = sh_log_e + p.n_e;
  float* sh_mus = sh_edges + E + 1;
  for (int j = threadIdx.x; j < n_acc; j += blockDim.x) shm[j] = 0.0;
  for (int j = threadIdx.x; j < p.n_e * p.n_q; j += blockDim.x) sh_kn[j] = p.kn_table[j];
  for (int j = threadIdx.x; j < p.n_e; j += blockDim.x) sh_log_e[j] = p.kn_log_e[j];
  for (int j = threadIdx.x; j < E + 1; j += blockDim.x) sh_edges[j] = p.ebin_edges[j];
  for (int j = threadIdx.x; j < kQuadrature; j += blockDim.x) sh_mus[j] = p.mus[j];
  __syncthreads();
  const Tables t{sh_log_e, sh_kn, sh_edges, sh_mus};
  const uint32_t n_moving = counters[0];
  Packet q;
  Run run;
  FracCache fc;
  bool have = false;
  for (;;) {
    if (!have) {
      const uint32_t slot = tardis::take_slot(&counters[1]);
      if (slot >= n_moving) break;
      const uint32_t i = list[slot];
      q = Packet{p.r[i], p.mu[i], p.energy[i], p.weight[i], p.budget[i],
                 p.shell[i], kStatusActive, 0, i};
      have = true;
    }
    if (q.ev < p.max_steps) {
      event<kGrey, kKasen, kArtis, kEst>(p, t, q, run, fc, sh_dep, sh_esc, sh_est);
      ++q.ev;
    }
    if (q.status != kStatusActive || q.ev >= p.max_steps) {
      const uint32_t i = q.i;
      p.r_out[i] = q.r;
      p.mu_out[i] = q.mu;
      p.energy_out[i] = q.e;
      p.weight_out[i] = q.w;
      p.shell_out[i] = q.shell;
      p.status_out[i] = q.status;
      p.events[i] = q.ev;
      have = false;
    }
  }
  flush<kEst>(run, S, sh_dep, sh_est);
  __syncthreads();
  for (int j = threadIdx.x; j < S; j += blockDim.x)
    if (sh_dep[j] != 0.0) atomicAdd(&p.deposition[j], sh_dep[j]);
  for (int j = threadIdx.x; j < E; j += blockDim.x)
    if (sh_esc[j] != 0.0) atomicAdd(&p.escape_hist[j], sh_esc[j]);
  if constexpr (kEst) {
    for (int j = threadIdx.x; j < 3 * S; j += blockDim.x)
      if (sh_est[j] != 0.0) atomicAdd(&p.estimators[j], sh_est[j]);
  }
}

}  // namespace

// ``queue``: (2 + n_packets) uint32 of scratch, the two counters (zeroed
// here on the stream) and the list of moving packets
extern "C" int gamma_step(
    const void* r, const void* mu, const void* energy, const void* weight,
    const void* shell, const void* status, const void* budget,
    const void* r_inner, const void* r_outer, const void* electron_density,
    const void* density, const void* iron, const void* kasen_z4,
    const void* kn_log_e, const void* kn_table, const void* ebin_edges,
    const void* mus, int64_t n_packets, int S, int E, int n_e, int n_q,
    int max_steps, uint32_t k0, uint32_t k1, float grey,
    const GammaConstants* constants, void* r_out, void* mu_out,
    void* energy_out, void* weight_out, void* shell_out, void* status_out,
    void* deposition, void* escape_hist, void* estimators, void* events,
    void* queue, void* stream) {
  constexpr bool kEst = GS_ESTIMATORS != 0;
  Params p;
  p.r = (const float*)r;
  p.mu = (const float*)mu;
  p.energy = (const float*)energy;
  p.weight = (const float*)weight;
  p.shell = (const int32_t*)shell;
  p.status = (const int32_t*)status;
  p.budget = (const float*)budget;
  p.r_inner = (const float*)r_inner;
  p.r_outer = (const float*)r_outer;
  p.electron_density = (const float*)electron_density;
  p.density = (const float*)density;
  p.iron = (const float*)iron;
  p.kasen_z4 = (const float*)kasen_z4;
  p.kn_log_e = (const float*)kn_log_e;
  p.kn_table = (const float*)kn_table;
  p.ebin_edges = (const float*)ebin_edges;
  p.mus = (const float*)mus;
  p.r_out = (float*)r_out;
  p.mu_out = (float*)mu_out;
  p.energy_out = (float*)energy_out;
  p.weight_out = (float*)weight_out;
  p.shell_out = (int32_t*)shell_out;
  p.status_out = (int32_t*)status_out;
  p.deposition = (double*)deposition;
  p.escape_hist = (double*)escape_hist;
  p.estimators = (double*)estimators;
  p.events = (int32_t*)events;
  p.n_packets = n_packets;
  p.S = S;
  p.E = E;
  p.n_e = n_e;
  p.n_q = n_q;
  p.max_steps = max_steps;
  p.grey = grey;
  p.key = tardis::Key{k0, k1};
  p.c = *constants;
  if (n_packets <= 0) return (int)cudaSuccess;
  if (n_packets > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* counters = (uint32_t*)queue;
  uint32_t* list = counters + 2;
  cudaError_t err = cudaMemsetAsync(counters, 0, 2 * sizeof(uint32_t), s);
  if (err != cudaSuccess) return (int)err;
  gamma_compact<<<(unsigned)((n_packets + kCompactThreads - 1) / kCompactThreads),
                  kCompactThreads, 0, s>>>(p, counters, list);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto walk = gamma_walk<GS_GREY != 0, GS_KASEN != 0, GS_ARTIS != 0, kEst>;
  const size_t shm = (size_t)(S + E + (kEst ? 3 * S : 0)) * sizeof(double) +
                     (size_t)(n_e * n_q + n_e + E + 1 + kQuadrature) * sizeof(float);
  unsigned blocks = 0;
  err = tardis::persistent_blocks(walk, kWalkThreads, shm, n_packets, &blocks);
  if (err != cudaSuccess) return (int)err;
  walk<<<blocks, kWalkThreads, shm, s>>>(p, counters, list);
  return (int)cudaGetLastError();
}
