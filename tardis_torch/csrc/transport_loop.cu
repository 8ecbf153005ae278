// K1 transport_loop: the Monte Carlo packet event loop of one iteration
// (homologous flow; scatter / downbranch / macroatom line interaction, or
// the Type IIP continuum mode with its absorbing-Markov macro atom), with
// the iteration's luminosity summary.
//
// Replaces: tardis_tpu/transport/kernel.py:425 `make_transport_step` with
// `_step_uniforms` (:209), `_distance_boundary` (:256), `_chain_emission`
// (:329), tiled_search.py:468 `predicate_search_packed` and :67
// `tiled_searchsorted`, driven by `transport_loop` (:1121) / `run_transport`
// (:1177), plus transport/solver.py:142 `_device_summary`.
//
// Bound on the H100: what an event waits on.  An event hashes two to four
// uniforms (threefry), searches the f64 tau prefix of its shell (29 MB at
// bench scale, beside the 0.7 MB line list) for its event line, and, where
// its caller reads them, scatters four f64 atomics into the line
// difference array (58.6 MB at bench scale: with the prefix, more than the
// 50 MB L2).  Timing variants that each removed one mechanism (on an H100
// 80GB HBM3 at 700 W, 2,097,152 packets, 40.3M events) showed that the
// search's scattered probes and the line difference atomics held the
// classic loop, not the hashes, the shared-memory estimator atomics or the
// block size.  Design:
//   - the event search gallops from the packet's next line (probes at
//     offsets 0, 1, 3, 7, ...) to the first probe past the event, then
//     bisects the bracket: the event line lies a few to a few hundred
//     lines on, so every probe reads rows near next_line (a bisection of
//     [next_line, L] reads rows up to L away, a cache line each).  Where
//     the predicate is monotone in the line index the gallop finds the
//     index of the plain version's bisection of [next_line, L].  Without
//     full relativity it is, even in f32, on a non-decreasing prefix row
//     (each term is a correctly rounded, monotone function of sorted
//     inputs).  The full-relativity predicate is not: the f32 root of the
//     resonance quadratic can dip by an ulp from one line frequency to the
//     next lower one.  There a margin guard (rel_search_proven, below)
//     proves from the optical depths at the lines on either side of the
//     event line, as the search computed them, that the predicate is
//     monotone on [next_line, L]; where it cannot, the bisection loop runs
//     again as the plain version's bisection of [next_line, L], and the
//     search is counted.  Bisecting every search made the relativity
//     path's final launch slower than one thread a packet (PERF.md);
//   - the line difference array only in the instantiations whose caller
//     reads it (TL_LINE_ESTIMATORS; the final iteration): the convergence
//     iterations write none;
//   - one launch of a persistent grid whose lanes take packets from a
//     queue (tardis::lane_loop, event_loop.cuh): a lane whose packet ends
//     takes the next at once, where one thread a packet held its warp's
//     slots until the warp's longest packet ended (at the bench shape a
//     warp of 32 consecutive packets kept its lanes 68% busy);
//   - __launch_bounds__(128, 9): at most 56 registers a lane, 36 resident
//     warps an SM, each a chain of dependent loads;
//   - the bulk j / nu-bar estimators go to each lane's run (tardis::
//     ShellRun), flushed to the block's shared sums at a shell change; the
//     luminosity sums to shared memory; each block flushes once with global
//     f64 atomics; the line difference array is spread over (L+1)*S*2
//     addresses, so it takes global f64 atomics;
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
//
// Options.  The JAX package's static config switches five branches of the
// step; here each is a template parameter of the kernel, and the library
// is built with one instantiation, chosen by -D flags (TL_FULL_RELATIVITY,
// TL_LAST_INTERACTION, TL_TRACKER, TL_REFLECTIVE, TL_WEIGHTS, TL_WALK, and the
// continuum's TL_CONTINUUM, TL_TWO_PHOTON, TL_ADIABATIC, TL_RECORDS; the wrapper
// builds one library per combination it is asked for).  An option that is
// off compiles to nothing, so the classic instantiation, which every
// convergence iteration of the main path runs, carries no register or
// branch for the others:
//   - full relativity (kernel.py:491-498,565-570,609-611,625-663,697,
//     742-750,811-821, tiled_search.py:494-500): gamma and aberration at
//     birth and scatter, dop = (1 - mu r) gamma(r), chi_e * dop, the
//     quadratic resonance distance in the search, the estimator path times
//     dop, line-independent j_blue / e_dot increments;
//   - last interaction (:969-985): one thread owns a packet, so the row
//     [type, in_line, out_line, shell, in_nu, r] lives in registers and is
//     written once, when the packet dies or the event cap stops it (a
//     packet that never interacts writes the zero row);
//   - tracker (:949-967): rows [r, nu, energy, shell, code, mu] after each
//     of the first K events, written as they happen;
//   - reflective inner boundary (:798-807,940-944): column 5 is hashed only
//     when a packet hits the core (the bits are counter-based, so a lazy
//     draw is the same draw);
//   - weights (:503-505): the birth energy times the pool's weight;
//   - walk (TL_WALK; kernel.py:281 `_macro_walk` with :229 and :240, wired
//     at :474-478,549-557,895-910): the RNG-walk macro atom instead of the
//     chain tables, where they do not fit the device budget or the solver
//     is told to walk (downbranch: the same instantiation with one jump).
//     A line interaction walks tardis::macro_walk (macro_walk.cuh, shared
//     with K7) from the event key, the global packet id's, and emits at
//     line_nu[em_line].  Each jump is a hash and a bisection of its
//     level's block; a plain, correct instantiation: the walk runs on the
//     lane of its packet's event, as K7's does;
//   - continuum (TL_CONTINUUM; the Type IIP workflow;
//     kernel.py:366-422,571-606,714-740,781-792,829-863,879-889): chi
//     = chi_e + chi_bf + chi_ff in the comoving frame.  One search on
//     the merged bound-free grid gives the cell and its weight; the C
//     continua's interpolated cross-sections are summed left to right
//     into one register, chi_bf, with no C-long array (C is a runtime
//     size: 10 at the synthetic IIP problem, more with real atom data),
//     and at a bound-free absorption the same running sum is
//     recomputed, with the same operations, to pick the continuum (the
//     JAX package takes it from the pre-move sum).  Each event adds
//     seven moments [w, w/nu, w nu, wb, wb/nu, wb nu, 1] to row gcell *
//     S + shell of a ((Ng-1) * S, 8) f64 array (29,280 addresses at the
//     IIP problem's 184-point grid and 20 shells; column 7 stays 0), and
//     w chi_ff to the per-shell free-free heating, through the lane's
//     run accumulator (Run, below).  A continuous event is a Thomson scatter if u2 < chi_e
//     / chi, else a continuum process; lines and continuum processes
//     activate the Markov macro atom: the absorbing state by a search
//     of its cumulative row (u6), then the channel in that state's
//     deactivation block (u7), each a first-true bisection clipped as
//     the JAX package clips it.  The channel emits a line, a free-bound
//     photon (u8 on the continuum's emission CDF, linear inverse
//     interpolation) or a free-free photon (-ln u9 kT/h, the log in f64
//     rounded to f32);
//   - two-photon (TL_TWO_PHOTON, :864-878): the two-photon channel's
//     frequency by linear interpolation of its inverse-CDF table (u8);
//   - adiabatic cooling (TL_ADIABATIC, :917-928,1016-1021): the channel
//     ends the packet with output (-nu before the interaction, energy 0);
//   - spawn records (TL_RECORDS, :520-545,987-1008): the continuum loop
//     writes them only in this instantiation (the classic loop tests the
//     capacity at run time), so the instantiation without records is the
//     same code as before they were added.  Births write [beta_inner, mu,
//     nu, energy, 0, birth_line, -1, -1]; every e-scatter, line and
//     continuum process the state after the emission, li_type 1, 2 or 3,
//     out_line = next_line - 1 for a line or a continuum process (both
//     activate the macro atom), -1 for an e-scatter; a packet the adiabatic
//     channel ends writes its row as well.  A random-walking IIP packet
//     makes thousands of attempts, so at the IIP shape nearly all are
//     counted and dropped, and which survive depends on the schedule of
//     the atomic claims (the JAX package keeps the first in step order).
//   Bound of the continuum instantiation: still latency, not bandwidth.
//   An event adds ~C x 12 operations and C x 4 table reads (the IIP
//   tables are 142 KB) to the classic event.  The Markov walk is
//   heavy-tailed (packets in continuum-thick shells random-walk 1e4-3e5
//   events, mean ~2,400), so one thread per packet in fixed blocks kept
//   whole blocks resident behind one long walk (7.7 s for 2.49e9 events
//   on an H100 80GB HBM3 at 700 W).  The continuum instantiations therefore run
//   their own loop (continuum_kernel, below), the counterpart of the JAX
//   package's lane refill and `_repack_jit` (kernel.py:1249-1266,1338,1360):
//   one launch of a persistent grid whose lanes take packets from a queue
//   and refill as soon as a packet ends, so no lane or block slot waits on
//   a long walk while the queue has work.  Every draw is keyed by
//   (pid_offset + pid, event index), so a packet's trajectory, row and
//   event count do not depend on the lane that runs it; only the order of
//   the f64 atomics does.  The classic instantiations run the same kind of
//   grid through tardis::lane_loop (ClassicWalker, below); the continuum
//   loop keeps its own, with its moment runs and staged tables.
//   Two more launches on the same stream follow it (launch_continuum):
//     - the drain tail.  Once the queue is empty and no more packets are
//       live than the tail kernel holds warps (2,112 on an H100 with the
//       IIP tables in shared memory), each lane parks its packet and
//       leaves, and continuum_tail_kernel runs each parked packet on a
//       whole warp: the draws hashed a column a lane, the searches
//       replayed from their probes evaluated on the lanes at once
//       (warp_bisect), the bound-free sums' terms a continuum a lane; every
//       packet's row, event count and draws are the ones its lane makes;
//     - the moments' sums.  Each SM adds its runs to a private copy of the
//       moments (moment_row), summed into them in a fixed order by
//       moments_reduce_kernel: the random walk's hot rows, added to by all
//       132 SMs in one copy, held the whole loop in the L2's atomics
//       (4.2 s of a launch at the IIP shape against 1.8 s; PERF.md).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "event_loop.cuh"
#include "macro_walk.cuh"
#include "queue.cuh"
#include "threefry.cuh"

#ifndef TL_FULL_RELATIVITY
#define TL_FULL_RELATIVITY 0
#endif
#ifndef TL_LAST_INTERACTION
#define TL_LAST_INTERACTION 0
#endif
#ifndef TL_TRACKER
#define TL_TRACKER 0
#endif
#ifndef TL_REFLECTIVE
#define TL_REFLECTIVE 0
#endif
#ifndef TL_WEIGHTS
#define TL_WEIGHTS 0
#endif
#ifndef TL_CONTINUUM
#define TL_CONTINUUM 0
#endif
#ifndef TL_TWO_PHOTON
#define TL_TWO_PHOTON 0
#endif
#ifndef TL_ADIABATIC
#define TL_ADIABATIC 0
#endif
#ifndef TL_RECORDS
#define TL_RECORDS 0
#endif
#ifndef TL_WALK
#define TL_WALK 0
#endif
#ifndef TL_LINE_ESTIMATORS
#define TL_LINE_ESTIMATORS 1
#endif

// the continuum tables and outputs (TL_CONTINUUM); laid out as
// ContinuumArgs in tardis_torch/transport/kernel.py
struct ContinuumArgs {
  const float* grid_nu;            // (Ng,) merged bound-free grid
  const float* xsect;              // (Ng * C,)
  const float* coef_a;             // (C * S,)
  const float* coef_b;             // (C * S,)
  const float* boltz_coef;         // (S,) h NU_UNIT / k T_e
  const float* ff_coef;            // (S,)
  const float* mk_cum_b;           // (S * M * M,)
  const int32_t* deact_block_start;  // (M + 1,)
  const float* deact_cum_prob;     // (D * S,)
  const int8_t* deact_kind;        // (D,)
  const int32_t* deact_id;         // (D,)
  const int32_t* line2state;       // (L,)
  const int32_t* photo_ion_state;  // (C,)
  const float* fb_cdf;             // (P * S,)
  const float* fb_nu;              // (P,)
  const int32_t* pion_block_start;  // (C + 1,)
  const float* two_photon_nu;      // (TPN,)
  double* moments;                 // ((Ng - 1) * S * 8,)
  double* ff_heat;                 // (S,)
  int32_t* events;                 // (N,) events of each packet
  // the drain tail (continuum_tail_kernel): the packets handed to it
  // (min(N, tail_threshold) ContPacket entries) and its two counts
  // [packets handed off, events run there]
  void* park;
  double* tail;
  // moment_copies private copies of moments, one an SM (by %smid, modulo
  // the copies), summed into moments in a fixed order after the loop
  double* moments_private;
  int n_grid, n_continua, n_states, k_state, n_two_photon;
  int n_deact, n_fb;               // D, P
  int moment_copies;
  // hand a packet to the tail once the queue is empty and at most this many
  // packets are taken and not ended (0: never; N or more: every packet, at
  // birth)
  int64_t tail_threshold;
};

// bytes of shared memory that stage_tables takes (each table's bytes
// rounded up to 16) for L lines and S shells
__host__ __device__ inline int64_t round16(int64_t b) { return (b + 15) & ~(int64_t)15; }

__host__ __device__ inline int64_t continuum_table_bytes(const ContinuumArgs& c, int64_t L,
                                                         int64_t S) {
  const int64_t Ng = c.n_grid, C = c.n_continua, M = c.n_states;
  const int64_t D = c.n_deact, P = c.n_fb;
  return round16(8 * S * (L + 1)) + 3 * round16(4 * S) + round16(4 * L)
         + round16(4 * Ng) + round16(4 * Ng * C) + 2 * round16(4 * C * S)
         + 2 * round16(4 * S) + round16(4 * S * M * M) + round16(4 * (M + 1))
         + round16(4 * D * S) + round16(D) + round16(4 * D) + round16(4 * L)
         + round16(4 * C) + round16(4 * P * S) + round16(4 * P) + round16(4 * (C + 1))
         + round16(4 * (int64_t)c.n_two_photon);
}

// the continuum loop's blocks: 128 lanes reading the tables from device
// memory, or 512 with the tables staged in shared memory
constexpr int kContThreads = 128;
constexpr int kSmemThreads = 512;
// terms of a lane's run accumulator and of its shell run (Run, below)
constexpr int kAccTerms = 8;
constexpr int kShellTerms = 3;

// dynamic shared memory of one continuum block: the per-shell sums, the
// lanes' run accumulators and, with smem_tables, the staged tables
inline size_t continuum_shared_bytes(const ContinuumArgs& c, int64_t L, int S,
                                     bool smem_tables) {
  const int threads = smem_tables ? kSmemThreads : kContThreads;
  return (size_t)(3 * S + 4 + (kAccTerms + kShellTerms) * threads) * sizeof(double)
         + (size_t)(smem_tables ? continuum_table_bytes(c, L, S) : 0);
}

// the tail kernel's: the per-shell sums (each warp keeps its run in
// registers) and the same staged tables
inline size_t tail_shared_bytes(const ContinuumArgs& c, int64_t L, int S, bool smem_tables) {
  return (size_t)(3 * S + 4) * sizeof(double)
         + (size_t)(smem_tables ? continuum_table_bytes(c, L, S) : 0);
}

namespace {

constexpr int kLineScatter = 0;
constexpr int kLineMacroatom = 2;
constexpr int kEvBoundary = 0;
constexpr int kEvLine = 1;
constexpr int kEvEscat = 2;
constexpr float kUMin = 1e-9f;
constexpr float kGammaFloor = 1e-12f;
constexpr uint32_t kColEscat = 2, kColBfFf = 3, kColContSel = 4;
constexpr uint32_t kColAlbedo = 5;
constexpr uint32_t kColMkRow = 6, kColMkDeact = 7, kColFb = 8, kColFf = 9;
// deactivation kinds of the Markov macro atom (continuum_macro.py EMIT_*)
constexpr int kEmitLine = 0, kEmitBf = 1, kEmitTwoPhoton = 3, kEmitAdiabatic = 4;


struct Params {
  const float* pool_mu;
  const float* pool_nu;
  const float* pool_w;  // (N,) weights (weights instantiation only)
  const float* r_inner;
  const float* r_outer;
  const float* chi_e;
  const float* line_nu;
  const double* prefix;
  const int32_t* line2macro;
  const float* chain_cdf;
  const float* emit_cdf;
  // the walk tables (TL_WALK): per-block cumulative probabilities (T, S),
  // block offsets (M + 1), and per transition its destination level,
  // whether it emits, and its line
  const float* cum_prob;
  const int32_t* block_start;
  const int32_t* dest;
  const bool* emit;
  const int32_t* mline;
  float* out;          // (N, 2): signed nu, energy
  double* est_j;       // (S,)
  double* est_nubar;   // (S,)
  double* line_diff;   // ((L+1)*S*2,)
  double* summary;     // [emitted in window, reabsorbed, events, immortal]
  float* vp_records;   // (vp_capacity, 8) spawn records
  unsigned long long* vp_count;  // records attempted
  float* last_interaction;  // (N, 6)
  float* tracker;           // (N, K, 6)
  int64_t vp_capacity;
  int64_t n_packets;
  int64_t L;
  int64_t max_events;
  // global id of this launch's first packet: a shard of a pool split over
  // devices hashes the ids of the whole pool (parallel/transport.py), and
  // reads and writes its own rows by the local id
  int64_t pid_offset;
  int S, M, W, We, mode, disable_line_scattering, tracker_length;
  int max_jumps;  // jumps of one walk (TL_WALK: 40, downbranch 1)
  float nu_lo, nu_hi, albedo;
  tardis::Key key;
  ContinuumArgs cont;
};

__device__ __forceinline__ float draw(tardis::Key k, uint32_t column) {
  return tardis::uniform_f32(tardis::random_bits(k, column), kUMin, 1.0f);
}

__device__ __forceinline__ float lorentz_gamma(float r) {
  return 1.0f / sqrtf(fmaxf(1.0f - r * r, kGammaFloor));
}

// path to the resonance of nu_line (f32, as the plain version): the
// quadratic root under full relativity, 1 - nu_line / nu - z otherwise
template <bool kRel>
__device__ __forceinline__ float resonance_distance(float nu_line, float nu, float z,
                                                    float p2) {
  if constexpr (kRel) {
    const float a = nu_line * nu_line;
    const float b = nu * nu;
    const float disc = fmaxf(a * (a - (a + b) * p2), 0.0f);
    const float y = (b - sqrtf(disc)) / (a + b);
    return fmaxf(y - z, 0.0f);
  } else {
    return fmaxf((1.0f - nu_line / nu) - z, 0.0f);
  }
}

// The margin guard of the full-relativity search: true where the event
// predicate P(i) = (nu_i <= nu_thresh) || (g_i > tau), g_i = (f32)(prefix
// difference) + chi s_i, is proven monotone on [start, L], so that the
// gallop's index k (P(k-1) false or k == start, P(k) true or k == L) is the
// only such index and the bisection of [start, L] finds it too.
//
// Let G_i = D_i + chi S_i in exact arithmetic, with D_i the f32 prefix
// difference as computed and S_i the resonance distance with every
// operation exact on the same f32 inputs.  D_i is a rounded monotone
// function of a non-decreasing f64 row, so non-decreasing.  In units N =
// nu_i^2 + nu^2, A = nu_i^2 / N, B = 1 - A: S = max(B - sqrt(A (A - p2)) -
// z, 0) (the root B for A <= p2), whose derivative in A is negative, and A
// grows with nu_i, so S never falls as nu_i falls (line_nu is sorted
// descending).  Hence G is non-decreasing in i.
//
// delta bounds |x_i - G_i|, x_i = D_i + fl(chi s_i) before the sum is
// rounded, for every line with nu_i > nu_thresh (the others fire anyway).
// With u = 2^-24 and A, B, |z|, p2 < 1, first-order in u (the slack in the
// constants covers the rest; no intermediate leaves f32's normal range at
// frequencies in units of 1e15 Hz, save a tiny p2, whose absolute error is
// far below u N):
//   - a - (a + b) p2 = N (A - p2 + e_t), |e_t| <= 2u A + 4.01u p2 (a, a+b
//     and the product each round once, then the difference);
//   - disc / N^2 = A (A - p2) + e_D, |e_D| <= u (4.02 A^2 + 6.03 A p2) <=
//     u (4.1 + 6.1 p2) =: eps_D;
//   - sqrt: |sqrt(x) - sqrt(x')| <= |x - x'| / sqrt(x').  Where nu_thresh
//     >= nu / 2 and p2 <= 0.1 (at every velocity a model holds: p2 <= r^2,
//     and nu_thresh ~ 0.8-0.95 nu), a line with nu_i > nu_thresh has A >
//     1/5, so A (A - p2) > 0.02, and the root's error is at most eps_sq =
//     eps_D / sqrt(0.02) <= 7.08 eps_D; elsewhere the guard proves nothing
//     and the search falls back;
//   - b - sqrt(disc) cancels, so its error is absolute: u (B + sqrt(A (A -
//     p2)) + |y|) <= 2u (B + A) = 2u, plus eps_sq, in units of N (it
//     scales with b / (a + b), not with y); the division by a + b adds 3u
//     |y| <= 3u and the subtraction of z 2u: |s~ - S| <= 7.1u + 1.02 eps_sq;
//   - chi s rounds once more (s < 2): |fl(chi s~) - chi S| <= chi (9.2u +
//     1.03 eps_sq) <= chi (10u + 1.1 eps_sq) <= chi u (42 + 48 p2) =: delta.
// Then for i < k - 1, x_i <= G_i + delta <= G_{k-1} + delta <= x_{k-1} +
// 2 delta <= g_{k-1} (1 + u) + 2 delta, and g_i = fl(x_i) <= tau once that
// is below tau (tau is an f32); for k < i with nu_i > nu_thresh, x_i >= g_k
// (1 - u) - 2 delta, and g_i > tau once that exceeds tau (1 + 2u), the
// next f32 above tau.  So P is monotone where
//   - k == start, or g_{k-1} (1 + 2u) + 2 delta < tau; and
//   - k == L, or nu_k <= nu_thresh, or g_k (1 - 2u) - 2 delta > tau (1 + 4u),
// at least one u more on each side than the argument needs.  The test runs in f32
// with every step rounded outward (__fmul_ru, __fadd_ru, __fsub_rd,
// __fmul_rd), so each side is bounded the safe way.  g_{k-1} is the value
// the search computed at its last probe that did not fire (-inf for k ==
// start), g_k the one its probe at k computed, taken again from the event
// line's resonance distance (+inf for k == L or nu_k <= nu_thresh).
__device__ __forceinline__ bool rel_search_proven(float g_lo, float g_hi, float nu, float p2,
                                                  float chi, float tau_event, float nu_thresh) {
  if (!(2.0f * nu_thresh >= nu && p2 <= 0.1f)) return false;
  constexpr float u2 = 1.1920928955078125e-7f;  // 2u = 2^-23
  const float two_delta = __fmul_ru(__fmul_ru(chi, u2), __fadd_ru(42.0f, __fmul_ru(48.0f, p2)));
  return __fadd_ru(__fmul_ru(g_lo, 1.0f + u2), two_delta) < tau_event &&
         __fsub_rd(__fmul_rd(g_hi, 1.0f - u2), two_delta) > __fmul_ru(tau_event, 1.0f + 2.0f * u2);
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

// first t in [lo, hi) with col[t * S + shell] >= u (hi if none), on a
// column non-decreasing over [lo, hi)
__device__ __forceinline__ int strided_lower_bound(const float* col, int lo, int hi,
                                                   int S, int shell, float u) {
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (col[(int64_t)mid * S + shell] < u) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// the running bound-free sum over the continua at (gcell, tfrac, boltz),
// left to right; with stop_at >= 0 it returns instead the first continuum
// whose running sum reaches stop_at (C if none), the JAX package's count
// of entries below it
__device__ __forceinline__ float bound_free_sum(const ContinuumArgs& c, int S, int shell,
                                               int gcell, float tfrac, float boltz,
                                               float stop_at, int* first) {
  const int C = c.n_continua;
  const float* x0 = c.xsect + (int64_t)gcell * C;
  const float* x1 = x0 + C;
  float cum = 0.0f;
  for (int k = 0; k < C; ++k) {
    const float xs = x0[k] + tfrac * (x1[k] - x0[k]);
    const float a = c.coef_a[k * S + shell];
    const float b = c.coef_b[k * S + shell];
    cum = cum + fmaxf(xs * (a - b * boltz), 0.0f);
    if (first != nullptr && cum >= stop_at) {
      *first = k;
      return cum;
    }
  }
  if (first != nullptr) *first = C;
  return cum;
}

// free-bound emission frequency of continuum cont_id (kernel.py:401-422)
__device__ __forceinline__ float free_bound_nu(const ContinuumArgs& c, int S, int shell,
                                               int cont_id, float z) {
  const int cc = min(max(cont_id, 0), c.n_continua - 1);
  const int b0 = c.pion_block_start[cc];
  const int b1 = c.pion_block_start[cc + 1];
  int idx = strided_lower_bound(c.fb_cdf, b0, b1, S, shell, z);
  idx = min(max(idx, b0 + 1), max(b1 - 1, b0 + 1));
  const float cdf_i = c.fb_cdf[(int64_t)idx * S + shell];
  const float cdf_im = c.fb_cdf[(int64_t)(idx - 1) * S + shell];
  const float nu_i = c.fb_nu[idx];
  const float nu_im = c.fb_nu[idx - 1];
  const float frac = cdf_i > cdf_im ? (cdf_i - z) / (cdf_i - cdf_im) : 0.0f;
  return nu_i - frac * (nu_i - nu_im);
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

// the last-interaction row a packet carries in registers
struct LastInteraction {
  float type = 0.0f, in_line = 0.0f, out_line = 0.0f, shell = 0.0f, in_nu = 0.0f,
        r = 0.0f;
};

// lanes of a classic block, and the blocks an SM must hold (at most 56
// registers a lane)
constexpr int kClassicThreads = 128;
constexpr int kClassicMinBlocks = 9;

// the count of the searches the margin guard sent to the full bisection:
// a pointer under full relativity, nothing (an empty base, so the walker's
// layout does not change) otherwise
template <bool kRel>
struct FallbackCount {
  __device__ explicit FallbackCount(unsigned long long*) {}
};
template <>
struct FallbackCount<true> {
  unsigned long long* search_fallbacks;
  __device__ explicit FallbackCount(unsigned long long* count) : search_fallbacks(count) {}
  __device__ __forceinline__ void count_fallback() { atomicAdd(search_fallbacks, 1ull); }
};

// One classic packet on its lane (tardis::lane_loop's Walker): the state
// between two events, the lane's estimator run, and one event of the
// event loop (kernel.py:425).
template <bool kRel, bool kLast, bool kTrack, bool kReflect, bool kWeights, bool kWalk,
          bool kLineEst>
struct ClassicWalker : FallbackCount<kRel> {
  const Params& p;
  double* sh_j;
  double* sh_nubar;
  double* sh_sum;
  tardis::ShellRun run;
  float r = 0.0f, mu = 0.0f, nu = 0.0f, energy = 0.0f;
  int shell = 0;
  int64_t next_line = 0, ev = 0, pid = 0;
  tardis::Key kp{0u, 0u};
  LastInteraction li;

  __device__ ClassicWalker(const Params& params, double* j, double* nubar, double* sum,
                           unsigned long long* fallbacks)
      : FallbackCount<kRel>(fallbacks), p(params), sh_j(j), sh_nubar(nubar), sh_sum(sum) {}

  // birth: next_line = number of lines with nu_line >= nu_cmf
  __device__ __forceinline__ void birth(int64_t id) {
    const float beta_inner = p.r_inner[0];
    pid = id;
    mu = p.pool_mu[pid];
    const float nu_cmf0 = p.pool_nu[pid];
    int64_t lo = 0, hi = p.L;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (p.line_nu[mid] >= nu_cmf0) lo = mid + 1;
      else hi = mid;
    }
    next_line = lo;
    float inv_dop0;
    if constexpr (kRel) {
      const float gamma_in = 1.0f / sqrtf(1.0f - beta_inner * beta_inner);
      inv_dop0 = (1.0f + mu * beta_inner) * gamma_in;
      mu = (mu + beta_inner) / (1.0f + beta_inner * mu);
    } else {
      inv_dop0 = 1.0f / (1.0f - mu * beta_inner);
    }
    nu = nu_cmf0 * inv_dop0;
    energy = inv_dop0;
    if constexpr (kWeights) energy = energy * p.pool_w[pid];
    r = beta_inner;
    shell = 0;
    ev = 0;
    kp = tardis::fold_in(p.key, (uint32_t)(p.pid_offset + pid));
    if (p.vp_capacity > 0) spawn_record(p, r, mu, nu, energy, 0, next_line, -1.0f, -1.0f);
    if constexpr (kLast) li = LastInteraction{};
  }

  __device__ __forceinline__ void track(float tr, float tnu, float ten, float code, float tmu) {
    if constexpr (kTrack) {
      if (ev < p.tracker_length) {
        float2* row = reinterpret_cast<float2*>(p.tracker + (pid * p.tracker_length + ev) * 6);
        row[0] = make_float2(tr, tnu);
        row[1] = make_float2(ten, (float)shell);
        row[2] = make_float2(code, tmu);
      }
    }
  }

  __device__ __forceinline__ bool event() {
    const int S = p.S;
    const int64_t L = p.L;
    const tardis::Key ke = tardis::fold_in(kp, (uint32_t)ev);
    const float chi_e = p.chi_e[shell];
    const float r_in = p.r_inner[shell];
    const float r_out = p.r_outer[shell];
    const float z = mu * r;
    float dop;
    if constexpr (kRel) dop = (1.0f - z) * lorentz_gamma(r);
    else dop = 1.0f - z;
    const float nu_cmf = nu * dop;
    float chi = chi_e;
    if constexpr (kRel) chi = chi * dop;

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
    float nu_thresh, p2 = 0.0f;
    if constexpr (kRel) {
      p2 = fmaxf((r * r) * (1.0f - mu * mu), 0.0f);
      const float rb2 = (r * r + d_b * d_b) + ((2.0f * r) * d_b) * mu;
      nu_thresh = (nu * (1.0f - (z + d_b))) / sqrtf(fmaxf(1.0f - rb2, kGammaFloor));
    } else {
      nu_thresh = nu * (1.0f - (z + d_b));
    }
    int64_t lo = next_line, hi = L;
    // under full relativity the margin guard's input from the probes: the
    // optical depth at the last that did not fire (line lo - 1; -inf if
    // none)
    float g_lo = __int_as_float(0xff800000);
    {
      int64_t probe = next_line, span = 1;
      while (probe < L) {
        const float nl = p.line_nu[probe];
        const float s = resonance_distance<kRel>(nl, nu, z, p2);
        const float g = (float)(prow[probe + 1] - c0) + chi * s;
        if ((nl <= nu_thresh) || (g > tau_event)) {
          hi = probe;
          break;
        }
        lo = probe + 1;
        if constexpr (kRel) g_lo = g;
        span *= 2;
        probe = next_line + span - 1;
      }
    }
    int64_t i_ev;
    float nu_ev, s_ev;
    bool found, again = false;
    do {
      while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        const float nl = p.line_nu[mid];
        const float s = resonance_distance<kRel>(nl, nu, z, p2);
        const float g = (float)(prow[mid + 1] - c0) + chi * s;
        if ((nl <= nu_thresh) || (g > tau_event)) {
          hi = mid;
        } else {
          lo = mid + 1;
          if constexpr (kRel) g_lo = g;
        }
      }
      i_ev = lo;
      nu_ev = i_ev < L ? p.line_nu[i_ev] : __int_as_float(0xff800000);
      found = (i_ev < L) && (nu_ev > nu_thresh);
      s_ev = resonance_distance<kRel>(nu_ev, nu, z, p2);
      if constexpr (kRel) {
        // the guard, on the first pass only, with the optical depth at
        // line i_ev as its probe computed it (+inf where the line's
        // frequency fired it, or none did); where it fails, the loop runs
        // again as the plain version's bisection of [next_line, L]
        again = !again && !rel_search_proven(
                              g_lo,
                              found ? (float)(prow[i_ev + 1] - c0) + chi * s_ev
                                    : __int_as_float(0x7f800000),
                              nu, p2, chi, tau_event, nu_thresh);
        if (again) {
          this->count_fallback();
          lo = next_line;
          hi = L;
        }
      }
    } while (again);
    const float tau_at = (float)(prow[i_ev] - c0);
    const float d_cont = fmaxf((tau_event - tau_at) / chi, 0.0f);
    const bool escat_f = p.disable_line_scattering || (d_cont < s_ev);
    const bool escat_nf = d_cont < d_b;
    int kind;
    float distance;
    if (found) {
      kind = escat_f ? kEvEscat : kEvLine;
      distance = escat_f ? d_cont : s_ev;
    } else {
      kind = escat_nf ? kEvEscat : kEvBoundary;
      distance = escat_nf ? d_cont : d_b;
    }
    const int64_t end_line = (kind == kEvLine) ? i_ev + 1 : i_ev;

    // estimators: the bulk terms into the lane's run; the line difference
    // array only in the instantiation whose caller reads it
    float w_j;
    if constexpr (kRel) w_j = (energy * dop) * (distance * dop);
    else w_j = (energy * dop) * distance;
    tardis::shell_run_add(run, shell, w_j, w_j * nu_cmf, sh_j, sh_nubar);
    if constexpr (kLineEst) {
      if (end_line != next_line) {
        float w1, w2;
        if constexpr (kRel) {
          w1 = energy / nu;
          w2 = energy;
        } else {
          w1 = energy / (nu * nu);
          w2 = energy / nu;
        }
        double* a = p.line_diff + (next_line * S + shell) * 2;
        double* b = p.line_diff + (end_line * S + shell) * 2;
        atomicAdd(a, (double)w1);
        atomicAdd(a + 1, (double)w2);
        atomicAdd(b, -(double)w1);
        atomicAdd(b + 1, -(double)w2);
      }
    }

    // move
    const float r_new = sqrtf(fmaxf(
        r * r + distance * distance + 2.0f * r * distance * mu, 1e-20f));
    const float mu_new = (mu * r + distance) / r_new;

    if (kind == kEvBoundary) {
      const int new_shell = shell + delta;
      bool reflected = false;
      if constexpr (kReflect)
        reflected = new_shell < 0 && draw(ke, kColAlbedo) < p.albedo;
      if (!reflected && (new_shell >= S || new_shell < 0)) {
        const bool emitted = new_shell >= S;
        track(r_new, nu, energy, 3.0f, mu_new);
        p.out[2 * pid] = emitted ? nu : -nu;
        p.out[2 * pid + 1] = energy;
        if (emitted) {
          if (nu > p.nu_lo && nu < p.nu_hi) atomicAdd(&sh_sum[0], (double)energy);
        } else {
          atomicAdd(&sh_sum[1], (double)energy);
        }
        return false;
      }
      if (!reflected) shell = new_shell;
      r = r_new;
      mu = reflected ? -mu_new : mu_new;
      next_line = end_line;
      track(r, nu, energy, 3.0f, mu);
      return true;
    }

    // Thomson scatter or absorption: new direction drawn in the CMF
    const float mu_draw = 2.0f * draw(ke, 1) - 1.0f;
    float dop_old_pos, inv_dop_new, mu_emit;
    if constexpr (kRel) {
      const float gamma_new = lorentz_gamma(r_new);
      dop_old_pos = (1.0f - mu_new * r_new) * gamma_new;
      inv_dop_new = (1.0f + mu_draw * r_new) * gamma_new;
      mu_emit = (mu_draw + r_new) / (1.0f + r_new * mu_draw);
    } else {
      dop_old_pos = 1.0f - mu_new * r_new;
      inv_dop_new = 1.0f / (1.0f - mu_draw * r_new);
      mu_emit = mu_draw;
    }
    const float nu_in = nu;
    if (kind == kEvEscat) {
      nu = nu * dop_old_pos * inv_dop_new;
      next_line = end_line;
      if constexpr (kLast) {
        li.type = 1.0f;
        li.in_line = -1.0f;
        li.out_line = -1.0f;
      }
    } else {
      int64_t em_line = i_ev;
      float nu_em = nu_ev;
      if constexpr (kWalk) {
        // the walk instantiation (downbranch and macroatom): the emitted
        // line's frequency from the line list (kernel.py:907-909)
        if (p.mode != kLineScatter) {
          em_line = tardis::macro_walk(p, ke, shell, i_ev);
          nu_em = p.line_nu[em_line];
        }
      } else if (p.mode != kLineScatter) {
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
      if constexpr (kLast) {
        li.type = 2.0f;
        li.in_line = (float)i_ev;
        li.out_line = (float)em_line;
      }
    }
    if constexpr (kLast) {
      li.shell = (float)shell;
      li.in_nu = nu_in;
      li.r = r_new;
    }
    energy = energy * dop_old_pos * inv_dop_new;
    r = r_new;
    mu = mu_emit;
    track(r, nu, energy, kind == kEvLine ? 2.0f : 1.0f, mu);
    if (p.vp_capacity > 0) {
      const bool line = kind == kEvLine;
      spawn_record(p, r, mu, nu, energy, shell, next_line, line ? 2.0f : 1.0f,
                   line ? (float)(next_line - 1) : -1.0f);
    }
    return true;
  }

  // a packet leaves the lane after n_ev events (dead, or stopped by the cap
  // with no output)
  __device__ __forceinline__ void finish(int64_t n_ev, bool stopped) {
    if (stopped) atomicAdd(&sh_sum[3], 1.0);
    if constexpr (kLast) {
      float2* row = reinterpret_cast<float2*>(p.last_interaction + pid * 6);
      row[0] = make_float2(li.type, li.in_line);
      row[1] = make_float2(li.out_line, li.shell);
      row[2] = make_float2(li.in_nu, li.r);
    }
    atomicAdd(&sh_sum[2], (double)n_ev);
  }

  __device__ __forceinline__ void flush() { tardis::shell_run_flush(run, sh_j, sh_nubar); }
};

// The classic loop: a persistent grid whose lanes walk the packet queue
// (tardis::lane_loop); the block's shared sums flush once, at exit.
template <bool kRel, bool kLast, bool kTrack, bool kReflect, bool kWeights, bool kWalk,
          bool kLineEst>
__global__ void __launch_bounds__(kClassicThreads, kClassicMinBlocks)
    transport_loop_kernel(Params p, unsigned long long* taken) {
  extern __shared__ double shm[];
  double* sh_j = shm;
  double* sh_nubar = shm + p.S;
  double* sh_sum = shm + 2 * p.S;
  const int n_shared = 2 * p.S + 4;
  for (int i = threadIdx.x; i < n_shared; i += blockDim.x) shm[i] = 0.0;
  __syncthreads();
  ClassicWalker<kRel, kLast, kTrack, kReflect, kWeights, kWalk, kLineEst> w(p, sh_j, sh_nubar,
                                                                            sh_sum, taken + 1);
  tardis::lane_loop(w, taken, p.n_packets, p.max_events);
  __syncthreads();
  for (int i = threadIdx.x; i < p.S; i += blockDim.x) {
    atomicAdd(&p.est_j[i], sh_j[i]);
    atomicAdd(&p.est_nubar[i], sh_nubar[i]);
  }
  if (threadIdx.x < 4) atomicAdd(&p.summary[threadIdx.x], sh_sum[threadIdx.x]);
}

// ---- the continuum instantiations (TL_CONTINUUM): a persistent grid
// whose lanes walk a packet queue

// a continuum packet between two events
struct ContPacket {
  float r, mu, nu, energy;
  int shell;
  int64_t next_line;
  int64_t ev;   // index of the packet's next event
  int64_t pid;  // local: rows are written by it, bits hashed by pid_offset + pid
  LastInteraction li;
};

// a lane's run accumulator: the estimator terms of consecutive events in
// one moment row (grid cell x shell), summed per thread in shared memory
// (acc[k * blockDim.x], k < kAccTerms: the seven moments [w, w/nu, w nu,
// wb, wb/nu, wb nu, 1] and the free-free heating w chi_ff; est_j and
// est_nubar are the moments w and w nu) and added to the moments when the
// row changes or the packet leaves the lane.  A packet random-walking
// through a continuum-thick shell keeps its row for many events, so the
// hot rows take far fewer atomics.  The row's est_j, est_nubar and
// free-free terms go on to the lane's shell run (acc[(kAccTerms + k) *
// blockDim.x], k < kShellTerms), added to the block's sums when the
// lane's shell changes and when it leaves the loop: the block's 512 lanes
// in a few hot shells, each adding at every row change, spent a tenth of
// the loop in the shared f64 atomics' compare-and-swap.  The sums change
// only in their order.

struct Run {
  int row = -1;  // gcell * S + shell of the terms in acc; -1: empty
  int shell = 0;
  int sum_shell = -1;  // the shell of the shell run; -1: empty
};

__device__ __forceinline__ void shell_flush(Run& run, double* acc, double* sh_j,
                                            double* sh_nubar, double* sh_ff) {
  if (run.sum_shell < 0) return;
  double* sums = acc + kAccTerms * blockDim.x;
  const int B = blockDim.x;
  atomicAdd(&sh_j[run.sum_shell], sums[0]);
  atomicAdd(&sh_nubar[run.sum_shell], sums[B]);
  atomicAdd(&sh_ff[run.sum_shell], sums[2 * B]);
#pragma unroll
  for (int k = 0; k < kShellTerms; ++k) sums[k * B] = 0.0;
  run.sum_shell = -1;
}

// moment row ``row`` of this SM's private copy: the hot rows of a random
// walk, added to by every SM, held the loop up in the L2's atomics
__device__ __forceinline__ double* moment_row(const Params& p, int row) {
  unsigned smid;
  asm("mov.u32 %0, %%smid;" : "=r"(smid));
  const ContinuumArgs& c = p.cont;
  return c.moments_private
         + ((int64_t)(smid % (unsigned)c.moment_copies) * (c.n_grid - 1) * p.S + row) * 8;
}

__device__ __forceinline__ void cont_flush(const Params& p, Run& run, double* acc,
                                           double* sh_j, double* sh_nubar,
                                           double* sh_ff) {
  if (run.row < 0) return;
  const int B = blockDim.x;
  double* m = moment_row(p, run.row);
#pragma unroll
  for (int k = 0; k < 7; ++k) atomicAdd(m + k, acc[k * B]);
  if (run.shell != run.sum_shell) {
    shell_flush(run, acc, sh_j, sh_nubar, sh_ff);
    run.sum_shell = run.shell;
  }
  double* sums = acc + kAccTerms * B;
  sums[0] += acc[0];
  sums[B] += acc[2 * B];
  sums[2 * B] += acc[7 * B];
#pragma unroll
  for (int k = 0; k < kAccTerms; ++k) acc[k * B] = 0.0;
  run.row = -1;
}

// copy n entries of src into the shared memory at dst (advanced past them,
// rounded up to 16 bytes); returns the copy
template <typename T>
__device__ __forceinline__ T* stage(char*& dst, const T* src, int64_t n) {
  T* out = reinterpret_cast<T*>(dst);
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) out[i] = src[i];
  dst += round16(n * (int64_t)sizeof(T));
  return out;
}

// the tables a continuum event reads, copied into shared memory at dst
// (continuum_table_bytes of them) once per block: p with its table
// pointers moved there (the caller synchronizes the block)
__device__ __forceinline__ void stage_tables(Params& p, char* dst) {
  const int64_t S = p.S, L = p.L;
  ContinuumArgs& c = p.cont;
  const int64_t Ng = c.n_grid, C = c.n_continua, M = c.n_states;
  const int64_t D = c.n_deact, P = c.n_fb;
  p.prefix = stage(dst, p.prefix, S * (L + 1));
  p.r_inner = stage(dst, p.r_inner, S);
  p.r_outer = stage(dst, p.r_outer, S);
  p.chi_e = stage(dst, p.chi_e, S);
  p.line_nu = stage(dst, p.line_nu, L);
  c.grid_nu = stage(dst, c.grid_nu, Ng);
  c.xsect = stage(dst, c.xsect, Ng * C);
  c.coef_a = stage(dst, c.coef_a, C * S);
  c.coef_b = stage(dst, c.coef_b, C * S);
  c.boltz_coef = stage(dst, c.boltz_coef, S);
  c.ff_coef = stage(dst, c.ff_coef, S);
  c.mk_cum_b = stage(dst, c.mk_cum_b, S * M * M);
  c.deact_block_start = stage(dst, c.deact_block_start, M + 1);
  c.deact_cum_prob = stage(dst, c.deact_cum_prob, D * S);
  c.deact_kind = stage(dst, c.deact_kind, D);
  c.deact_id = stage(dst, c.deact_id, D);
  c.line2state = stage(dst, c.line2state, L);
  c.photo_ion_state = stage(dst, c.photo_ion_state, C);
  c.fb_cdf = stage(dst, c.fb_cdf, P * S);
  c.fb_nu = stage(dst, c.fb_nu, P);
  c.pion_block_start = stage(dst, c.pion_block_start, C + 1);
  c.two_photon_nu = stage(dst, c.two_photon_nu, (int64_t)c.n_two_photon);
}

template <bool kRel, bool kWeights>
__device__ __forceinline__ void cont_birth(const Params& p, int64_t pid, ContPacket& q) {
  const float beta_inner = p.r_inner[0];
  float mu = p.pool_mu[pid];
  const float nu_cmf0 = p.pool_nu[pid];
  int64_t lo = 0, hi = p.L;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (p.line_nu[mid] >= nu_cmf0) lo = mid + 1;
    else hi = mid;
  }
  float inv_dop0;
  if constexpr (kRel) {
    const float gamma_in = 1.0f / sqrtf(1.0f - beta_inner * beta_inner);
    inv_dop0 = (1.0f + mu * beta_inner) * gamma_in;
    mu = (mu + beta_inner) / (1.0f + beta_inner * mu);
  } else {
    inv_dop0 = 1.0f / (1.0f - mu * beta_inner);
  }
  q.r = beta_inner;
  q.mu = mu;
  q.nu = nu_cmf0 * inv_dop0;
  q.energy = inv_dop0;
  if constexpr (kWeights) q.energy = q.energy * p.pool_w[pid];
  q.shell = 0;
  q.next_line = lo;
  q.ev = 0;
  q.pid = pid;
  q.li = LastInteraction{};
}

// one event of a continuum packet (ClassicWalker::event with the continuum
// opacity, estimators and Markov macro atom, and the event search a
// bisection of [next_line, L], as the plain version's; with kRecords an
// interaction appends its spawn record, kernel.py:987-1008); returns false
// when the packet dies, its output row and sums written
template <bool kRel, bool kTrack, bool kReflect, bool kTwoPhoton, bool kAdiabatic,
          bool kRecords>
__device__ __forceinline__ bool cont_event(const Params& p, ContPacket& q, tardis::Key kp,
                                           Run& run, double* acc, double* sh_j,
                                           double* sh_nubar, double* sh_sum,
                                           double* sh_ff) {
  const int S = p.S;
  const int64_t L = p.L;
  const ContinuumArgs& cont = p.cont;
  const int64_t ev = q.ev;
  const int64_t pid = q.pid;
  float& r = q.r;
  float& mu = q.mu;
  float& nu = q.nu;
  float& energy = q.energy;
  int& shell = q.shell;
  int64_t& next_line = q.next_line;
  LastInteraction& li = q.li;

  const tardis::Key ke = tardis::fold_in(kp, (uint32_t)ev);
  const float chi_e = p.chi_e[shell];
  const float r_in = p.r_inner[shell];
  const float r_out = p.r_outer[shell];
  const float z = mu * r;
  float dop;
  if constexpr (kRel) dop = (1.0f - z) * lorentz_gamma(r);
  else dop = 1.0f - z;
  const float nu_cmf = nu * dop;

  // continuum opacity in the comoving frame: the grid cell (last knot <=
  // nu_cmf, clipped), its weight, b = exp(-h nu / k T_e), chi_bf and chi_ff
  int glo = 0, ghi = cont.n_grid;
  while (glo < ghi) {
    const int mid = (glo + ghi) >> 1;
    if (cont.grid_nu[mid] <= nu_cmf) glo = mid + 1;
    else ghi = mid;
  }
  const int gcell = min(max(glo - 1, 0), cont.n_grid - 2);
  const float g0 = cont.grid_nu[gcell];
  const float dg = cont.grid_nu[gcell + 1] - g0;
  const float tfrac = fminf(fmaxf((nu_cmf - g0) / fmaxf(dg, 1e-30f), 0.0f), 1.0f);
  const float boltz = (float)exp(-(double)(nu_cmf * cont.boltz_coef[shell]));
  const float chi_bf = bound_free_sum(cont, S, shell, gcell, tfrac, boltz, 0.0f, nullptr);
  const float nuc = fmaxf(nu_cmf, 1e-30f);
  const float chi_ff = cont.ff_coef[shell] / ((nuc * nuc) * nuc) * (1.0f - boltz);
  const float chi_cmf = chi_e + chi_bf + chi_ff;
  float chi = chi_cmf;
  if constexpr (kRel) chi = chi * dop;

  // distance to the shell boundary; a tangential ray (mu == 0) grazes and
  // exits outward
  const float out_d =
      sqrtf(fmaxf(r_out * r_out + (mu * mu - 1.0f) * r * r, 0.0f)) - r * mu;
  const float check = r_in * r_in + r * r * (mu * mu - 1.0f);
  const bool hits_inner = (mu < 0.0f) && (check >= 0.0f);
  const float in_d = -r * mu - sqrtf(fmaxf(check, 0.0f));
  const float d_b = fmaxf(hits_inner ? in_d : out_d, 0.0f);
  const int delta = hits_inner ? -1 : 1;

  const float tau_event = (float)(-log((double)draw(ke, 0)));

  // event search: first i in [next_line, L] with i == L, or nu_i beyond the
  // boundary, or optical depth to line i above tau_event
  const double* prow = p.prefix + (int64_t)shell * (L + 1);
  const double c0 = prow[next_line];
  float nu_thresh, p2 = 0.0f;
  if constexpr (kRel) {
    p2 = fmaxf((r * r) * (1.0f - mu * mu), 0.0f);
    const float rb2 = (r * r + d_b * d_b) + ((2.0f * r) * d_b) * mu;
    nu_thresh = (nu * (1.0f - (z + d_b))) / sqrtf(fmaxf(1.0f - rb2, kGammaFloor));
  } else {
    nu_thresh = nu * (1.0f - (z + d_b));
  }
  int64_t lo = next_line, hi = L;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    const float nl = p.line_nu[mid];
    const float s = resonance_distance<kRel>(nl, nu, z, p2);
    const float g = (float)(prow[mid + 1] - c0) + chi * s;
    if ((nl <= nu_thresh) || (g > tau_event)) hi = mid;
    else lo = mid + 1;
  }
  const int64_t i_ev = lo;
  const float nu_ev = i_ev < L ? p.line_nu[i_ev] : __int_as_float(0xff800000);
  const bool found = (i_ev < L) && (nu_ev > nu_thresh);
  const float s_ev = resonance_distance<kRel>(nu_ev, nu, z, p2);
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

  // estimators: the seven moments of row gcell * S + shell and the
  // free-free heating, into the lane's run accumulator (est_j and
  // est_nubar are moments 0 and 2)
  float w_j;
  if constexpr (kRel) w_j = (energy * dop) * (distance * dop);
  else w_j = (energy * dop) * distance;
  {
    const int row = gcell * S + shell;
    if (row != run.row) {
      cont_flush(p, run, acc, sh_j, sh_nubar, sh_ff);
      run.row = row;
      run.shell = shell;
    }
    const int B = blockDim.x;
    const float inv_nu = 1.0f / fmaxf(nu_cmf, 1e-30f);
    const float wb = w_j * boltz;
    acc[0] += (double)w_j;
    acc[B] += (double)(w_j * inv_nu);
    acc[2 * B] += (double)(w_j * nu_cmf);
    acc[3 * B] += (double)wb;
    acc[4 * B] += (double)(wb * inv_nu);
    acc[5 * B] += (double)(wb * nu_cmf);
    acc[6 * B] += 1.0;
    acc[7 * B] += (double)(w_j * chi_ff);
  }
  if (end_line != next_line) {
    float w1, w2;
    if constexpr (kRel) {
      w1 = energy / nu;
      w2 = energy;
    } else {
      w1 = energy / (nu * nu);
      w2 = energy / nu;
    }
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
    bool reflected = false;
    if constexpr (kReflect)
      reflected = new_shell < 0 && draw(ke, kColAlbedo) < p.albedo;
    if (!reflected && (new_shell >= S || new_shell < 0)) {
      const bool emitted = new_shell >= S;
      if constexpr (kTrack) {
        if (ev < p.tracker_length) {
          float2* row = reinterpret_cast<float2*>(
              p.tracker + (pid * p.tracker_length + ev) * 6);
          row[0] = make_float2(r_new, nu);
          row[1] = make_float2(energy, (float)shell);
          row[2] = make_float2(3.0f, mu_new);
        }
      }
      p.out[2 * pid] = emitted ? nu : -nu;
      p.out[2 * pid + 1] = energy;
      if (emitted) {
        if (nu > p.nu_lo && nu < p.nu_hi) atomicAdd(&sh_sum[0], (double)energy);
      } else {
        atomicAdd(&sh_sum[1], (double)energy);
      }
      return false;
    }
    if (!reflected) shell = new_shell;
    r = r_new;
    mu = reflected ? -mu_new : mu_new;
    next_line = end_line;
    if constexpr (kTrack) {
      if (ev < p.tracker_length) {
        float2* row = reinterpret_cast<float2*>(
            p.tracker + (pid * p.tracker_length + ev) * 6);
        row[0] = make_float2(r, nu);
        row[1] = make_float2(energy, (float)shell);
        row[2] = make_float2(3.0f, mu);
      }
    }
    return true;
  }

  // a continuous event is a Thomson scatter or a continuum process (chi_e /
  // chi is the Thomson share)
  const bool contproc =
      event == kEvEscat && draw(ke, kColEscat) >= chi_e / fmaxf(chi_cmf, 1e-30f);

  // Thomson scatter or absorption: new direction drawn in the CMF
  const float mu_draw = 2.0f * draw(ke, 1) - 1.0f;
  float dop_old_pos, inv_dop_new, mu_emit;
  if constexpr (kRel) {
    const float gamma_new = lorentz_gamma(r_new);
    dop_old_pos = (1.0f - mu_new * r_new) * gamma_new;
    inv_dop_new = (1.0f + mu_draw * r_new) * gamma_new;
    mu_emit = (mu_draw + r_new) / (1.0f + r_new * mu_draw);
  } else {
    dop_old_pos = 1.0f - mu_new * r_new;
    inv_dop_new = 1.0f / (1.0f - mu_draw * r_new);
    mu_emit = mu_draw;
  }
  const float nu_in = nu;
  bool adiabatic = false;
  if (event == kEvEscat && !contproc) {
    nu = nu * dop_old_pos * inv_dop_new;
    next_line = end_line;
    li.type = 1.0f;
    li.in_line = -1.0f;
    li.out_line = -1.0f;
  } else {
    // the Markov macro atom, activated by the line's state, the chosen
    // continuum's i-packet state or the k-packet state
    int state0;
    if (event == kEvLine) {
      state0 = cont.line2state[i_ev];
    } else if (draw(ke, kColBfFf) < chi_bf / fmaxf(chi_bf + chi_ff, 1e-30f)) {
      int c_sel;
      bound_free_sum(cont, S, shell, gcell, tfrac, boltz,
                     draw(ke, kColContSel) * chi_bf, &c_sel);
      state0 = cont.photo_ion_state[min(c_sel, cont.n_continua - 1)];
    } else {
      state0 = cont.k_state;
    }
    const int M = cont.n_states;
    const float* brow = cont.mk_cum_b + ((int64_t)shell * M + state0) * M;
    const int a = min(cdf_lower_bound(brow, M, draw(ke, kColMkRow)), M - 1);
    const int b0 = cont.deact_block_start[a];
    const int b1 = cont.deact_block_start[a + 1];
    int t = strided_lower_bound(cont.deact_cum_prob, b0, b1, S, shell,
                                draw(ke, kColMkDeact));
    t = min(max(t, b0), max(b1 - 1, b0));
    const int kind = cont.deact_kind[t];
    const int chan = cont.deact_id[t];
    const int64_t em_line = chan < 0 ? 0 : (chan >= L ? L - 1 : (int64_t)chan);
    float nu_cmf_em;
    if (kind == kEmitLine) {
      nu_cmf_em = p.line_nu[em_line];
    } else if (kind == kEmitBf) {
      nu_cmf_em = free_bound_nu(cont, S, shell, chan, draw(ke, kColFb));
    } else if (kTwoPhoton && kind == kEmitTwoPhoton) {
      const int tpn = cont.n_two_photon;
      const float pos = draw(ke, kColFb) * (float)(tpn - 1);
      const int i_tp = min(max((int)pos, 0), tpn - 2);
      const float frac = pos - (float)i_tp;
      nu_cmf_em = cont.two_photon_nu[i_tp] * (1.0f - frac)
                  + cont.two_photon_nu[i_tp + 1] * frac;
    } else {
      nu_cmf_em = (float)(-log((double)draw(ke, kColFf))) / cont.boltz_coef[shell];
    }
    nu = nu_cmf_em * inv_dop_new;
    if (kind == kEmitLine) {
      next_line = em_line + 1;
    } else {
      int64_t nlo = 0, nhi = L;
      while (nlo < nhi) {
        const int64_t mid = (nlo + nhi) >> 1;
        if (p.line_nu[mid] >= nu_cmf_em) nlo = mid + 1;
        else nhi = mid;
      }
      next_line = nlo;
    }
    if constexpr (kAdiabatic) adiabatic = kind == kEmitAdiabatic;
    const bool line = event == kEvLine;
    li.type = line ? 2.0f : 3.0f;
    li.in_line = line ? (float)i_ev : -1.0f;
    li.out_line = line ? (float)em_line : -1.0f;
  }
  li.shell = (float)shell;
  li.in_nu = nu_in;
  li.r = r_new;
  energy = energy * dop_old_pos * inv_dop_new;
  r = r_new;
  mu = mu_emit;
  if constexpr (kTrack) {
    if (ev < p.tracker_length) {
      float2* row = reinterpret_cast<float2*>(
          p.tracker + (pid * p.tracker_length + ev) * 6);
      row[0] = make_float2(r, nu);
      row[1] = make_float2(energy, (float)shell);
      row[2] = make_float2(event == kEvLine ? 2.0f : (contproc ? 4.0f : 1.0f), mu);
    }
  }
  if constexpr (kRecords) {
    // the state after the emission; a packet the adiabatic channel ends
    // writes its row too, as the JAX package's (it is in `interacts`)
    const bool absorbs = !(event == kEvEscat && !contproc);
    spawn_record(p, r, mu, nu, energy, shell, next_line,
                 event == kEvLine ? 2.0f : (contproc ? 3.0f : 1.0f),
                 absorbs ? (float)(next_line - 1) : -1.0f);
  }
  if constexpr (kAdiabatic) {
    if (adiabatic) {
      // the energy went into expansion work: no luminosity either way
      p.out[2 * pid] = -nu_in;
      p.out[2 * pid + 1] = 0.0f;
      return false;
    }
  }
  return true;
}

// a packet leaves the loop after n_ev events (dead, or stopped by the cap)
template <bool kLast>
__device__ __forceinline__ void cont_finish(const Params& p, const ContPacket& q,
                                            int64_t n_ev, double* sh_sum) {
  if constexpr (kLast) {
    float2* row = reinterpret_cast<float2*>(p.last_interaction + q.pid * 6);
    row[0] = make_float2(q.li.type, q.li.in_line);
    row[1] = make_float2(q.li.out_line, q.li.shell);
    row[2] = make_float2(q.li.in_nu, q.li.r);
  }
  p.cont.events[q.pid] = (int32_t)n_ev;
  atomicAdd(&sh_sum[2], (double)n_ev);
}

// a lane of the continuum loop looks at the live count before every
// kTailCheck-th event of its packet
constexpr int64_t kTailCheck = 32;

// the drain's device counters, zeroed by the caller, after the packet
// queue: the packets ended in continuum_kernel, those it parked, and the
// tail kernel's queue of parked packets
struct DrainCounters {
  unsigned long long ended, parked, tail_taken;
};

// whether a lane hands its packet to the drain tail: the queue is empty
// and at most T packets are taken and not ended (T >= N: every packet, at
// birth).  Both counters only grow, and ended is read after the queue, so
// N - ended is never below the live count: no more than T packets are
// ever handed off.
__device__ __forceinline__ bool hand_off(const unsigned long long* taken,
                                         const DrainCounters* c, int64_t N, int64_t T) {
  if (T >= N) return true;
  if (T <= 0) return false;
  if (*(const volatile unsigned long long*)taken < (unsigned long long)N) return false;
  return N - (int64_t)*(const volatile unsigned long long*)&c->ended <= T;
}

// The continuum loop: a persistent grid (as many blocks as are resident)
// whose lanes take packet ids from a counter, a warp-aggregated atomicAdd
// at a time.  Each lane runs one event per loop iteration, so a lane whose
// packet ends takes the next packet at once, and no lane or block slot
// waits on a long packet while the queue has work.  A packet alive at
// max_events is stopped and counted.  Nothing waits on another block.
// Each lane sums its packet's estimator terms in its run accumulator (Run,
// above); the block's shared accumulators flush once, at exit.
//
// The drain tail: once the queue is empty, the few packets still walking
// hold a lane each, nearly alone in their warps.  When hand_off says so,
// a lane flushes its run, parks its packet's state in the parking list
// and leaves, and continuum_tail_kernel, queued behind this launch, runs
// each parked packet on a whole warp.
template <bool kRel, bool kLast, bool kTrack, bool kReflect, bool kWeights,
          bool kTwoPhoton, bool kAdiabatic, bool kRecords, bool kSmemTables>
__global__ void __launch_bounds__(kSmemTables ? kSmemThreads : kContThreads, 1)
    continuum_kernel(Params p, unsigned long long* taken, DrainCounters* ctr) {
  extern __shared__ double shm[];
  double* sh_j = shm;
  double* sh_nubar = shm + p.S;
  double* sh_sum = shm + 2 * p.S;
  double* sh_ff = shm + 2 * p.S + 4;
  double* acc = shm + 3 * p.S + 4 + threadIdx.x;  // (kAccTerms + kShellTerms, blockDim.x)
  const int n_shared = 3 * p.S + 4 + (kAccTerms + kShellTerms) * blockDim.x;
  for (int i = threadIdx.x; i < n_shared; i += blockDim.x) shm[i] = 0.0;
  if constexpr (kSmemTables) stage_tables(p, reinterpret_cast<char*>(shm + n_shared));
  __syncthreads();
  ContPacket q;
  Run run;
  tardis::Key kp{0u, 0u};
  bool have = false;
  for (;;) {
    if (!have) {
      const unsigned long long pid = tardis::take_slot(taken);
      if (pid >= (unsigned long long)p.n_packets) break;
      cont_birth<kRel, kWeights>(p, (int64_t)pid, q);
      if constexpr (kRecords)
        spawn_record(p, q.r, q.mu, q.nu, q.energy, 0, q.next_line, -1.0f, -1.0f);
      kp = tardis::fold_in(p.key, (uint32_t)(p.pid_offset + q.pid));
      have = true;
    }
    if ((q.ev & (kTailCheck - 1)) == 0
        && hand_off(taken, ctr, p.n_packets, p.cont.tail_threshold)) {
      cont_flush(p, run, acc, sh_j, sh_nubar, sh_ff);
      static_cast<ContPacket*>(p.cont.park)[tardis::take_slot(&ctr->parked)] = q;
      have = false;
      continue;
    }
    if (q.ev >= p.max_events) {
      atomicAdd(&sh_sum[3], 1.0);
      cont_finish<kLast>(p, q, p.max_events, sh_sum);
    } else {
      const bool alive = cont_event<kRel, kTrack, kReflect, kTwoPhoton, kAdiabatic, kRecords>(
          p, q, kp, run, acc, sh_j, sh_nubar, sh_sum, sh_ff);
      q.ev += 1;
      if (alive) continue;
      cont_finish<kLast>(p, q, q.ev, sh_sum);
    }
    atomicAdd(&ctr->ended, 1ull);
    cont_flush(p, run, acc, sh_j, sh_nubar, sh_ff);
    have = false;
  }
  shell_flush(run, acc, sh_j, sh_nubar, sh_ff);
  __syncthreads();
  for (int i = threadIdx.x; i < p.S; i += blockDim.x) {
    atomicAdd(&p.est_j[i], sh_j[i]);
    atomicAdd(&p.est_nubar[i], sh_nubar[i]);
    atomicAdd(&p.cont.ff_heat[i], sh_ff[i]);
  }
  if (threadIdx.x < 4) atomicAdd(&p.summary[threadIdx.x], sh_sum[threadIdx.x]);
}

// ---- the drain tail: one parked continuum packet a warp

constexpr unsigned kFull = 0xffffffffu;
// columns of an event key a continuum event may draw (kColFf is the last)
constexpr int kDraws = 10;

// The bisection `while (lo < hi) { mid = (lo + hi) >> 1; if (right(mid))
// lo = mid + 1; else hi = mid; }`, called by the 32 lanes of a warp with
// the same lo and hi.  Each round evaluates right() at once at every index
// the bisection may probe next, one a lane: where [lo, hi) is longer than
// 32, the 31 probes of its next five levels (lane l the node l + 1 of that
// subtree in heap order: node n's children are 2n where right() is false
// and 2n + 1 where it is true), else every index of [lo, hi).  Every lane
// then replays the bisection's own path on the ballot's bits, so the index
// is the bisection's bit for bit, also where right() is not monotone.
template <class Right>
__device__ __forceinline__ int warp_bisect(int lo, int hi, int lane, Right right) {
  while (hi - lo > 32) {
    const int node = lane + 1;
    const int depth = 31 - __clz(node);
    int a = lo, b = hi;
#pragma unroll
    for (int d = 3; d >= 0; --d) {
      if (d < depth) {
        const int mid = (a + b) >> 1;
        const bool r = (node >> d) & 1;
        a = r ? mid + 1 : a;
        b = r ? b : mid;
      }
    }
    const unsigned bits = __ballot_sync(kFull, lane < 31 && a < b && right((a + b) >> 1));
    unsigned n = 1;
#pragma unroll
    for (int level = 0; level < 5; ++level) {
      const int mid = (lo + hi) >> 1;
      const bool r = (bits >> (n - 1)) & 1u;
      lo = r ? mid + 1 : lo;
      hi = r ? hi : mid;
      n = 2 * n + r;
    }
  }
  if (lo < hi) {
    const int base = lo;
    const unsigned bits = __ballot_sync(kFull, lane < hi - lo && right(base + lane));
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const bool r = (bits >> (mid - base)) & 1u;
      lo = r ? mid + 1 : lo;
      hi = r ? hi : mid;
    }
  }
  return lo;
}

// bound_free_sum on a warp: lanes 0-15 compute the terms of 16 continua
// at a time, and every lane adds them left to right in the same f32 order,
// so the sum and the continuum picked are bound_free_sum's
__device__ __forceinline__ float warp_bound_free_sum(const ContinuumArgs& c, int S, int shell,
                                                    int gcell, float tfrac, float boltz,
                                                    int lane, float stop_at, int* first) {
  constexpr int kChunk = 16;
  const int C = c.n_continua;
  const float* x0 = c.xsect + (int64_t)gcell * C;
  const float* x1 = x0 + C;
  float cum = 0.0f;
  for (int k0 = 0; k0 < C; k0 += kChunk) {
    const int k = k0 + lane;
    float term = 0.0f;
    if (lane < kChunk && k < C) {
      const float xs = x0[k] + tfrac * (x1[k] - x0[k]);
      const float a = c.coef_a[k * S + shell];
      const float b = c.coef_b[k * S + shell];
      term = fmaxf(xs * (a - b * boltz), 0.0f);
    }
    float terms[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) terms[j] = __shfl_sync(kFull, term, j);
    const int n = min(kChunk, C - k0);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j < n) {
        cum = cum + terms[j];
        if (first != nullptr && cum >= stop_at) {
          *first = k0 + j;
          return cum;
        }
      }
    }
  }
  if (first != nullptr) *first = C;
  return cum;
}

// free_bound_nu with its search on the warp
__device__ __forceinline__ float warp_free_bound_nu(const ContinuumArgs& c, int S, int shell,
                                                   int cont_id, float z, int lane) {
  const int cc = min(max(cont_id, 0), c.n_continua - 1);
  const int b0 = c.pion_block_start[cc];
  const int b1 = c.pion_block_start[cc + 1];
  int idx = warp_bisect(b0, b1, lane, [&](int i) {
    return c.fb_cdf[(int64_t)i * S + shell] < z;
  });
  idx = min(max(idx, b0 + 1), max(b1 - 1, b0 + 1));
  const float cdf_i = c.fb_cdf[(int64_t)idx * S + shell];
  const float cdf_im = c.fb_cdf[(int64_t)(idx - 1) * S + shell];
  const float nu_i = c.fb_nu[idx];
  const float nu_im = c.fb_nu[idx - 1];
  const float frac = cdf_i > cdf_im ? (cdf_i - z) / (cdf_i - cdf_im) : 0.0f;
  return nu_i - frac * (nu_i - nu_im);
}

// cont_event's event search, the bisection of [lo, L], on the warp (L <
// 2^30, as the wrapper checks)
template <bool kRel>
__device__ __forceinline__ int64_t tail_line_search(const float* line_nu, const double* prow,
                                                    double c0, int64_t lo, int64_t L, float nu,
                                                    float z, float p2, float chi,
                                                    float tau_event, float nu_thresh,
                                                    int lane) {
  return warp_bisect((int)lo, (int)L, lane, [&](int mid) {
    const float nl = line_nu[mid];
    const float s = resonance_distance<kRel>(nl, nu, z, p2);
    const float g = (float)(prow[mid + 1] - c0) + chi * s;
    return !((nl <= nu_thresh) || (g > tau_event));
  });
}

// a warp's run accumulator: Run's terms in registers, the same in every
// lane; lane 0 adds them
struct TailRun {
  int row = -1;
  int shell = 0;
  double acc[kAccTerms] = {};
};

__device__ __forceinline__ void tail_flush(const Params& p, TailRun& run, int lane,
                                           double* sh_j, double* sh_nubar, double* sh_ff) {
  if (run.row < 0) return;
  if (lane == 0) {
    double* m = moment_row(p, run.row);
#pragma unroll
    for (int k = 0; k < 7; ++k) atomicAdd(m + k, run.acc[k]);
    atomicAdd(&sh_j[run.shell], run.acc[0]);
    atomicAdd(&sh_nubar[run.shell], run.acc[2]);
    atomicAdd(&sh_ff[run.shell], run.acc[7]);
  }
#pragma unroll
  for (int k = 0; k < kAccTerms; ++k) run.acc[k] = 0.0;
  run.row = -1;
}

// one event of a parked packet on a warp: cont_event's expressions, with
// the draws, the searches and the bound-free sums spread over the lanes.
// Every lane holds the packet's state and computes the same values; lane 0
// alone writes (atomics, rows, records).  ke is the event's key on entry
// and the next event's on return: lane c < kDraws hashes column c of the
// event key, lane kDraws the next event's key, in one round.
template <bool kRel, bool kTrack, bool kReflect, bool kTwoPhoton, bool kAdiabatic,
          bool kRecords>
__device__ __forceinline__ bool tail_event(const Params& p, ContPacket& q, tardis::Key kp,
                                           tardis::Key& ke, int lane, TailRun& run,
                                           double* sh_j, double* sh_nubar, double* sh_sum,
                                           double* sh_ff) {
  const int S = p.S;
  const int64_t L = p.L;
  const ContinuumArgs& cont = p.cont;
  const int64_t ev = q.ev;
  const int64_t pid = q.pid;
  float& r = q.r;
  float& mu = q.mu;
  float& nu = q.nu;
  float& energy = q.energy;
  int& shell = q.shell;
  int64_t& next_line = q.next_line;
  LastInteraction& li = q.li;
  const bool writer = lane == 0;

  float u[kDraws];
  {
    uint32_t x0 = 0u, x1 = lane < kDraws ? (uint32_t)lane : (uint32_t)(ev + 1);
    tardis::threefry2x32(lane < kDraws ? ke : kp, x0, x1);
    const float mine = tardis::uniform_f32(x0 ^ x1, kUMin, 1.0f);
#pragma unroll
    for (int c = 0; c < kDraws; ++c) u[c] = __shfl_sync(kFull, mine, c);
    ke = tardis::Key{__shfl_sync(kFull, x0, kDraws), __shfl_sync(kFull, x1, kDraws)};
  }

  const float chi_e = p.chi_e[shell];
  const float r_in = p.r_inner[shell];
  const float r_out = p.r_outer[shell];
  const float z = mu * r;
  float dop;
  if constexpr (kRel) dop = (1.0f - z) * lorentz_gamma(r);
  else dop = 1.0f - z;
  const float nu_cmf = nu * dop;

  const int glo = warp_bisect(0, cont.n_grid, lane, [&](int i) {
    return cont.grid_nu[i] <= nu_cmf;
  });
  const int gcell = min(max(glo - 1, 0), cont.n_grid - 2);
  const float g0 = cont.grid_nu[gcell];
  const float dg = cont.grid_nu[gcell + 1] - g0;
  const float tfrac = fminf(fmaxf((nu_cmf - g0) / fmaxf(dg, 1e-30f), 0.0f), 1.0f);
  const float boltz = (float)exp(-(double)(nu_cmf * cont.boltz_coef[shell]));
  const float chi_bf =
      warp_bound_free_sum(cont, S, shell, gcell, tfrac, boltz, lane, 0.0f, nullptr);
  const float nuc = fmaxf(nu_cmf, 1e-30f);
  const float chi_ff = cont.ff_coef[shell] / ((nuc * nuc) * nuc) * (1.0f - boltz);
  const float chi_cmf = chi_e + chi_bf + chi_ff;
  float chi = chi_cmf;
  if constexpr (kRel) chi = chi * dop;

  const float out_d =
      sqrtf(fmaxf(r_out * r_out + (mu * mu - 1.0f) * r * r, 0.0f)) - r * mu;
  const float check = r_in * r_in + r * r * (mu * mu - 1.0f);
  const bool hits_inner = (mu < 0.0f) && (check >= 0.0f);
  const float in_d = -r * mu - sqrtf(fmaxf(check, 0.0f));
  const float d_b = fmaxf(hits_inner ? in_d : out_d, 0.0f);
  const int delta = hits_inner ? -1 : 1;

  const float tau_event = (float)(-log((double)u[0]));

  const double* prow = p.prefix + (int64_t)shell * (L + 1);
  const double c0 = prow[next_line];
  float nu_thresh, p2 = 0.0f;
  if constexpr (kRel) {
    p2 = fmaxf((r * r) * (1.0f - mu * mu), 0.0f);
    const float rb2 = (r * r + d_b * d_b) + ((2.0f * r) * d_b) * mu;
    nu_thresh = (nu * (1.0f - (z + d_b))) / sqrtf(fmaxf(1.0f - rb2, kGammaFloor));
  } else {
    nu_thresh = nu * (1.0f - (z + d_b));
  }
  const int64_t i_ev = tail_line_search<kRel>(p.line_nu, prow, c0, next_line, L, nu, z, p2,
                                              chi, tau_event, nu_thresh, lane);
  const float nu_ev = i_ev < L ? p.line_nu[i_ev] : __int_as_float(0xff800000);
  const bool found = (i_ev < L) && (nu_ev > nu_thresh);
  const float s_ev = resonance_distance<kRel>(nu_ev, nu, z, p2);
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

  float w_j;
  if constexpr (kRel) w_j = (energy * dop) * (distance * dop);
  else w_j = (energy * dop) * distance;
  {
    const int row = gcell * S + shell;
    if (row != run.row) {
      tail_flush(p, run, lane, sh_j, sh_nubar, sh_ff);
      run.row = row;
      run.shell = shell;
    }
    const float inv_nu = 1.0f / fmaxf(nu_cmf, 1e-30f);
    const float wb = w_j * boltz;
    run.acc[0] += (double)w_j;
    run.acc[1] += (double)(w_j * inv_nu);
    run.acc[2] += (double)(w_j * nu_cmf);
    run.acc[3] += (double)wb;
    run.acc[4] += (double)(wb * inv_nu);
    run.acc[5] += (double)(wb * nu_cmf);
    run.acc[6] += 1.0;
    run.acc[7] += (double)(w_j * chi_ff);
  }
  if (writer && end_line != next_line) {
    float w1, w2;
    if constexpr (kRel) {
      w1 = energy / nu;
      w2 = energy;
    } else {
      w1 = energy / (nu * nu);
      w2 = energy / nu;
    }
    double* a = p.line_diff + (next_line * S + shell) * 2;
    double* b = p.line_diff + (end_line * S + shell) * 2;
    atomicAdd(a, (double)w1);
    atomicAdd(a + 1, (double)w2);
    atomicAdd(b, -(double)w1);
    atomicAdd(b + 1, -(double)w2);
  }

  const float r_new = sqrtf(fmaxf(
      r * r + distance * distance + 2.0f * r * distance * mu, 1e-20f));
  const float mu_new = (mu * r + distance) / r_new;

  if (event == kEvBoundary) {
    const int new_shell = shell + delta;
    bool reflected = false;
    if constexpr (kReflect) reflected = new_shell < 0 && u[kColAlbedo] < p.albedo;
    if (!reflected && (new_shell >= S || new_shell < 0)) {
      const bool emitted = new_shell >= S;
      if (writer) {
        if constexpr (kTrack) {
          if (ev < p.tracker_length) {
            float2* row = reinterpret_cast<float2*>(
                p.tracker + (pid * p.tracker_length + ev) * 6);
            row[0] = make_float2(r_new, nu);
            row[1] = make_float2(energy, (float)shell);
            row[2] = make_float2(3.0f, mu_new);
          }
        }
        p.out[2 * pid] = emitted ? nu : -nu;
        p.out[2 * pid + 1] = energy;
        if (emitted) {
          if (nu > p.nu_lo && nu < p.nu_hi) atomicAdd(&sh_sum[0], (double)energy);
        } else {
          atomicAdd(&sh_sum[1], (double)energy);
        }
      }
      return false;
    }
    if (!reflected) shell = new_shell;
    r = r_new;
    mu = reflected ? -mu_new : mu_new;
    next_line = end_line;
    if constexpr (kTrack) {
      if (writer && ev < p.tracker_length) {
        float2* row = reinterpret_cast<float2*>(
            p.tracker + (pid * p.tracker_length + ev) * 6);
        row[0] = make_float2(r, nu);
        row[1] = make_float2(energy, (float)shell);
        row[2] = make_float2(3.0f, mu);
      }
    }
    return true;
  }

  const bool contproc =
      event == kEvEscat && u[kColEscat] >= chi_e / fmaxf(chi_cmf, 1e-30f);

  const float mu_draw = 2.0f * u[1] - 1.0f;
  float dop_old_pos, inv_dop_new, mu_emit;
  if constexpr (kRel) {
    const float gamma_new = lorentz_gamma(r_new);
    dop_old_pos = (1.0f - mu_new * r_new) * gamma_new;
    inv_dop_new = (1.0f + mu_draw * r_new) * gamma_new;
    mu_emit = (mu_draw + r_new) / (1.0f + r_new * mu_draw);
  } else {
    dop_old_pos = 1.0f - mu_new * r_new;
    inv_dop_new = 1.0f / (1.0f - mu_draw * r_new);
    mu_emit = mu_draw;
  }
  const float nu_in = nu;
  bool adiabatic = false;
  if (event == kEvEscat && !contproc) {
    nu = nu * dop_old_pos * inv_dop_new;
    next_line = end_line;
    li.type = 1.0f;
    li.in_line = -1.0f;
    li.out_line = -1.0f;
  } else {
    int state0;
    if (event == kEvLine) {
      state0 = cont.line2state[i_ev];
    } else if (u[kColBfFf] < chi_bf / fmaxf(chi_bf + chi_ff, 1e-30f)) {
      int c_sel;
      warp_bound_free_sum(cont, S, shell, gcell, tfrac, boltz, lane,
                          u[kColContSel] * chi_bf, &c_sel);
      state0 = cont.photo_ion_state[min(c_sel, cont.n_continua - 1)];
    } else {
      state0 = cont.k_state;
    }
    const int M = cont.n_states;
    const float* brow = cont.mk_cum_b + ((int64_t)shell * M + state0) * M;
    const float u_row = u[kColMkRow];
    const int a = min(warp_bisect(0, M, lane, [&](int i) { return brow[i] < u_row; }), M - 1);
    const int b0 = cont.deact_block_start[a];
    const int b1 = cont.deact_block_start[a + 1];
    const float u_deact = u[kColMkDeact];
    int t = warp_bisect(b0, b1, lane, [&](int i) {
      return cont.deact_cum_prob[(int64_t)i * S + shell] < u_deact;
    });
    t = min(max(t, b0), max(b1 - 1, b0));
    const int kind = cont.deact_kind[t];
    const int chan = cont.deact_id[t];
    const int64_t em_line = chan < 0 ? 0 : (chan >= L ? L - 1 : (int64_t)chan);
    float nu_cmf_em;
    if (kind == kEmitLine) {
      nu_cmf_em = p.line_nu[em_line];
    } else if (kind == kEmitBf) {
      nu_cmf_em = warp_free_bound_nu(cont, S, shell, chan, u[kColFb], lane);
    } else if (kTwoPhoton && kind == kEmitTwoPhoton) {
      const int tpn = cont.n_two_photon;
      const float pos = u[kColFb] * (float)(tpn - 1);
      const int i_tp = min(max((int)pos, 0), tpn - 2);
      const float frac = pos - (float)i_tp;
      nu_cmf_em = cont.two_photon_nu[i_tp] * (1.0f - frac)
                  + cont.two_photon_nu[i_tp + 1] * frac;
    } else {
      nu_cmf_em = (float)(-log((double)u[kColFf])) / cont.boltz_coef[shell];
    }
    nu = nu_cmf_em * inv_dop_new;
    if (kind == kEmitLine) {
      next_line = em_line + 1;
    } else {
      next_line = warp_bisect(0, (int)L, lane, [&](int i) { return p.line_nu[i] >= nu_cmf_em; });
    }
    if constexpr (kAdiabatic) adiabatic = kind == kEmitAdiabatic;
    const bool line = event == kEvLine;
    li.type = line ? 2.0f : 3.0f;
    li.in_line = line ? (float)i_ev : -1.0f;
    li.out_line = line ? (float)em_line : -1.0f;
  }
  li.shell = (float)shell;
  li.in_nu = nu_in;
  li.r = r_new;
  energy = energy * dop_old_pos * inv_dop_new;
  r = r_new;
  mu = mu_emit;
  if constexpr (kTrack) {
    if (writer && ev < p.tracker_length) {
      float2* row = reinterpret_cast<float2*>(
          p.tracker + (pid * p.tracker_length + ev) * 6);
      row[0] = make_float2(r, nu);
      row[1] = make_float2(energy, (float)shell);
      row[2] = make_float2(event == kEvLine ? 2.0f : (contproc ? 4.0f : 1.0f), mu);
    }
  }
  if constexpr (kRecords) {
    if (writer) {
      const bool absorbs = !(event == kEvEscat && !contproc);
      spawn_record(p, r, mu, nu, energy, shell, next_line,
                   event == kEvLine ? 2.0f : (contproc ? 3.0f : 1.0f),
                   absorbs ? (float)(next_line - 1) : -1.0f);
    }
  }
  if constexpr (kAdiabatic) {
    if (adiabatic) {
      if (writer) {
        p.out[2 * pid] = -nu_in;
        p.out[2 * pid + 1] = 0.0f;
      }
      return false;
    }
  }
  return true;
}

// The drain tail: a persistent grid of warps, queued behind continuum_kernel
// on its stream.  Each warp takes one parked packet at a time and runs its
// events (tail_event) until it ends or reaches max_events;
// its key and first event key are hashed again from the packet's id and
// event index, so its draws are the ones its lane would have made.  Counts
// the packets handed off and the events run here in cont.tail.
template <bool kRel, bool kLast, bool kTrack, bool kReflect, bool kWeights,
          bool kTwoPhoton, bool kAdiabatic, bool kRecords, bool kSmemTables>
__global__ void __launch_bounds__(kSmemTables ? kSmemThreads : kContThreads, 1)
    continuum_tail_kernel(Params p, DrainCounters* ctr) {
  const unsigned long long parked = ctr->parked;
  if (parked == 0) return;
  extern __shared__ double shm[];
  double* sh_j = shm;
  double* sh_nubar = shm + p.S;
  double* sh_sum = shm + 2 * p.S;
  double* sh_ff = shm + 2 * p.S + 4;
  const int n_shared = 3 * p.S + 4;
  for (int i = threadIdx.x; i < n_shared; i += blockDim.x) shm[i] = 0.0;
  if constexpr (kSmemTables) stage_tables(p, reinterpret_cast<char*>(shm + n_shared));
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const ContPacket* park = static_cast<const ContPacket*>(p.cont.park);
  TailRun run;
  int64_t events = 0;
  for (;;) {
    unsigned long long slot = 0;
    if (lane == 0) slot = atomicAdd(&ctr->tail_taken, 1ull);
    slot = __shfl_sync(kFull, slot, 0);
    if (slot >= parked) break;
    ContPacket q = park[slot];
    const tardis::Key kp = tardis::fold_in(p.key, (uint32_t)(p.pid_offset + q.pid));
    tardis::Key ke = tardis::fold_in(kp, (uint32_t)q.ev);
    const int64_t ev0 = q.ev;
    for (;;) {
      if (q.ev >= p.max_events) {
        if (lane == 0) {
          atomicAdd(&sh_sum[3], 1.0);
          cont_finish<kLast>(p, q, p.max_events, sh_sum);
        }
        break;
      }
      const bool alive = tail_event<kRel, kTrack, kReflect, kTwoPhoton, kAdiabatic, kRecords>(
          p, q, kp, ke, lane, run, sh_j, sh_nubar, sh_sum, sh_ff);
      q.ev += 1;
      if (!alive) {
        if (lane == 0) cont_finish<kLast>(p, q, q.ev, sh_sum);
        break;
      }
    }
    events += q.ev - ev0;
    tail_flush(p, run, lane, sh_j, sh_nubar, sh_ff);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < p.S; i += blockDim.x) {
    atomicAdd(&p.est_j[i], sh_j[i]);
    atomicAdd(&p.est_nubar[i], sh_nubar[i]);
    atomicAdd(&p.cont.ff_heat[i], sh_ff[i]);
  }
  if (threadIdx.x < 4) atomicAdd(&p.summary[threadIdx.x], sh_sum[threadIdx.x]);
  if (lane == 0 && events) atomicAdd(&p.cont.tail[1], (double)events);
  if (blockIdx.x == 0 && threadIdx.x == 0) p.cont.tail[0] = (double)parked;
}

#if TL_CONTINUUM
// The tests' view of the tail's searches: warp w runs tail_line_search on
// state w or, with line_nu null, warp_bisect of [lo, hi) with right(i) =
// values[i] < u[w].
__global__ void tail_search_kernel(bool rel, const float* line_nu, const double* prefix,
                                   int64_t L, const float* values, int64_t n,
                                   const int64_t* shell, const int64_t* lo, const int64_t* hi,
                                   const float* u, const float* chi, const float* z,
                                   const float* nu, const float* tau_event,
                                   const float* nu_thresh, const float* p2, int64_t* out) {
  const int64_t w = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n) return;
  int64_t k;
  if (line_nu == nullptr) {
    const float uw = u[w];
    k = warp_bisect((int)lo[w], (int)hi[w], lane, [&](int i) { return values[i] < uw; });
  } else {
    const double* prow = prefix + shell[w] * (L + 1);
    const double c0 = prow[lo[w]];
    k = rel ? tail_line_search<true>(line_nu, prow, c0, lo[w], L, nu[w], z[w], p2[w], chi[w],
                                     tau_event[w], nu_thresh[w], lane)
            : tail_line_search<false>(line_nu, prow, c0, lo[w], L, nu[w], z[w], p2[w], chi[w],
                                      tau_event[w], nu_thresh[w], lane);
  }
  if (lane == 0) out[w] = k;
}

// moments[e] += the private copies' entries e (n each), copy 0 first
__global__ void moments_reduce_kernel(const double* priv, int copies, int64_t n,
                                      double* moments) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  double sum = 0.0;
  for (int c = 0; c < copies; ++c) sum += priv[c * n + e];
  moments[e] += sum;
}

// the continuum instantiation's tail kernel
template <bool kSmemTables>
auto tail_kernel() {
  return continuum_tail_kernel<TL_FULL_RELATIVITY != 0, TL_LAST_INTERACTION != 0,
                               TL_TRACKER != 0, TL_REFLECTIVE != 0, TL_WEIGHTS != 0,
                               TL_TWO_PHOTON != 0, TL_ADIABATIC != 0, TL_RECORDS != 0,
                               kSmemTables>;
}

// blocks of the tail kernel resident on the current device (at most
// enough for n_warps warps)
template <bool kSmemTables>
cudaError_t tail_blocks(const ContinuumArgs& c, int64_t L, int S, int64_t n_warps,
                        unsigned* blocks) {
  const int threads = kSmemTables ? kSmemThreads : kContThreads;
  return tardis::persistent_blocks(tail_kernel<kSmemTables>(), threads,
                                   tail_shared_bytes(c, L, S, kSmemTables), n_warps * 32,
                                   blocks);
}

// the default tail threshold: the warps of the tail kernel resident at once
template <bool kSmemTables>
cudaError_t tail_warps(const ContinuumArgs& c, int64_t L, int S, int64_t* warps) {
  unsigned blocks = 0;
  const cudaError_t err = tail_blocks<kSmemTables>(c, L, S, (int64_t)1 << 40, &blocks);
  *warps = (int64_t)blocks * ((kSmemTables ? kSmemThreads : kContThreads) / 32);
  return err;
}

// the continuum instantiation: as many blocks as are resident, with the
// accumulators' and (kSmemTables) the tables' shared memory; then, where
// packets may be handed off, the tail kernel; then the moments' private
// copies summed; all on one stream
template <bool kSmemTables>
cudaError_t launch_continuum(const Params& p, unsigned long long* taken,
                             cudaStream_t stream) {
  auto kernel = continuum_kernel<TL_FULL_RELATIVITY != 0, TL_LAST_INTERACTION != 0,
                                 TL_TRACKER != 0, TL_REFLECTIVE != 0, TL_WEIGHTS != 0,
                                 TL_TWO_PHOTON != 0, TL_ADIABATIC != 0, TL_RECORDS != 0,
                                 kSmemTables>;
  const int threads = kSmemTables ? kSmemThreads : kContThreads;
  const size_t shm = continuum_shared_bytes(p.cont, p.L, p.S, kSmemTables);
  DrainCounters* ctr = reinterpret_cast<DrainCounters*>(taken + 2);
  unsigned blocks = 0;
  cudaError_t err = tardis::persistent_blocks(kernel, threads, shm, p.n_packets, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, shm, stream>>>(p, taken, ctr);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t capacity =
      p.cont.tail_threshold < p.n_packets ? p.cont.tail_threshold : p.n_packets;
  if (capacity > 0) {
    err = tail_blocks<kSmemTables>(p.cont, p.L, p.S, capacity, &blocks);
    if (err != cudaSuccess) return err;
    auto tail = tail_kernel<kSmemTables>();
    tail<<<blocks, threads, tail_shared_bytes(p.cont, p.L, p.S, kSmemTables), stream>>>(p,
                                                                                      ctr);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int64_t n = (int64_t)(p.cont.n_grid - 1) * p.S * 8;
  moments_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      p.cont.moments_private, p.cont.moment_copies, n, p.cont.moments);
  return cudaGetLastError();
}
#endif

}  // namespace

// Whether the continuum tables of ``cont`` (L lines, S shells), staged in
// shared memory with the lanes' accumulators, fit one block's opt-in
// shared memory on the current device: *fits = 1 or 0 (the wrapper's
// choice of the continuum instantiation, by the launch's own size).
extern "C" int continuum_smem_fits(const ContinuumArgs* cont, int64_t L, int S, int* fits) {
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *fits = err == cudaSuccess && continuum_shared_bytes(*cont, L, S, true) <= (size_t)limit;
  return (int)err;
}

// The drain tail of the continuum loop on the current device: *warps, the
// warps of the tail kernel resident at once (the default hand-off
// threshold), *packet_bytes, one entry of the parking list, and
// *moment_copies, the moments' private copies (one an SM).
extern "C" int continuum_tail_plan(const ContinuumArgs* cont, int64_t L, int S,
                                   int smem_tables, int64_t* warps, int* packet_bytes,
                                   int* moment_copies) {
#if TL_CONTINUUM
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(moment_copies, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = smem_tables ? tail_warps<true>(*cont, L, S, warps)
                      : tail_warps<false>(*cont, L, S, warps);
  *packet_bytes = (int)sizeof(ContPacket);
  return (int)err;
#else
  return (int)cudaErrorInvalidValue;
#endif
}

#if TL_CONTINUUM
extern "C" int tail_search(int rel, const void* line_nu, const void* prefix, int64_t L,
                           const void* values, int64_t n, const void* shell, const void* lo,
                           const void* hi, const void* u, const void* chi, const void* z,
                           const void* nu, const void* tau_event, const void* nu_thresh,
                           const void* p2, void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((n * 32 + 127) / 128);
  tail_search_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(
      rel != 0, (const float*)line_nu, (const double*)prefix, L, (const float*)values, n,
      (const int64_t*)shell, (const int64_t*)lo, (const int64_t*)hi, (const float*)u,
      (const float*)chi, (const float*)z, (const float*)nu, (const float*)tau_event,
      (const float*)nu_thresh, (const float*)p2, (int64_t*)out);
  return (int)cudaGetLastError();
}
#endif

// One launch of K1: a persistent grid whose lanes take packet ids from the
// zeroed device counter taken[0] (classic: cont null, smem_tables 0; the
// walk tables null unless TL_WALK); the full-relativity classic loop counts
// its guard's fallbacks to the bisection in taken[1], also zeroed.
extern "C" int transport_loop(
    const void* pool_mu, const void* pool_nu, const void* pool_w,
    int64_t n_packets, const void* r_inner, const void* r_outer,
    const void* chi_e, const void* line_nu, const void* prefix,
    const void* line2macro, const void* chain_cdf, const void* emit_cdf,
    int64_t L, int S, int M, int W, int We, int mode,
    int disable_line_scattering, uint32_t k0, uint32_t k1, float nu_lo,
    float nu_hi, float albedo, int64_t max_events, int64_t pid_offset,
    void* out, void* est_j, void* est_nubar, void* line_diff, void* summary,
    void* vp_records, void* vp_count, int64_t vp_capacity,
    void* last_interaction, void* tracker, int tracker_length,
    const void* cum_prob, const void* block_start, const void* dest,
    const void* emit, const void* mline, int max_jumps,
    const ContinuumArgs* cont, void* taken, int smem_tables, void* stream) {
  constexpr bool kCont = TL_CONTINUUM != 0;
  constexpr bool kLineEst = TL_LINE_ESTIMATORS != 0;
  constexpr bool kWalk = TL_WALK != 0;
  constexpr bool kRecords = TL_RECORDS != 0;
  if (kCont != (cont != nullptr) || taken == nullptr || (!kCont && smem_tables)
      || (!kCont && kRecords) || (kCont && kRecords != (vp_capacity > 0))
      || (kCont && !kLineEst) || (kLineEst != (line_diff != nullptr))
      || (kWalk && (kCont || cum_prob == nullptr || block_start == nullptr
                    || dest == nullptr || emit == nullptr || mline == nullptr
                    || max_jumps < 1)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.pool_mu = (const float*)pool_mu;
  p.pool_nu = (const float*)pool_nu;
  p.pool_w = (const float*)pool_w;
  p.r_inner = (const float*)r_inner;
  p.r_outer = (const float*)r_outer;
  p.chi_e = (const float*)chi_e;
  p.line_nu = (const float*)line_nu;
  p.prefix = (const double*)prefix;
  p.line2macro = (const int32_t*)line2macro;
  p.chain_cdf = (const float*)chain_cdf;
  p.emit_cdf = (const float*)emit_cdf;
  p.cum_prob = (const float*)cum_prob;
  p.block_start = (const int32_t*)block_start;
  p.dest = (const int32_t*)dest;
  p.emit = (const bool*)emit;
  p.mline = (const int32_t*)mline;
  p.max_jumps = max_jumps;
  p.out = (float*)out;
  p.est_j = (double*)est_j;
  p.est_nubar = (double*)est_nubar;
  p.line_diff = (double*)line_diff;
  p.summary = (double*)summary;
  p.vp_records = (float*)vp_records;
  p.vp_count = (unsigned long long*)vp_count;
  p.last_interaction = (float*)last_interaction;
  p.tracker = (float*)tracker;
  p.vp_capacity = vp_capacity;
  p.n_packets = n_packets;
  p.L = L;
  p.max_events = max_events;
  p.pid_offset = pid_offset;
  p.S = S;
  p.M = M;
  p.W = W;
  p.We = We;
  p.mode = mode;
  p.disable_line_scattering = disable_line_scattering;
  p.tracker_length = tracker_length;
  p.nu_lo = nu_lo;
  p.nu_hi = nu_hi;
  p.albedo = albedo;
  p.key = tardis::Key{k0, k1};
  p.cont = kCont ? *cont : ContinuumArgs{};
  if (n_packets <= 0) return (int)cudaGetLastError();
#if TL_CONTINUUM
  {
    unsigned long long* counter = (unsigned long long*)taken;
    const cudaError_t err =
        smem_tables ? launch_continuum<true>(p, counter, (cudaStream_t)stream)
                    : launch_continuum<false>(p, counter, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
#else
  {
    auto kernel = transport_loop_kernel<TL_FULL_RELATIVITY != 0, TL_LAST_INTERACTION != 0,
                                        TL_TRACKER != 0, TL_REFLECTIVE != 0,
                                        TL_WEIGHTS != 0, kWalk, kLineEst>;
    const size_t shm = (size_t)(2 * S + 4) * sizeof(double);
    unsigned blocks = 0;
    const cudaError_t err =
        tardis::persistent_blocks(kernel, kClassicThreads, shm, n_packets, &blocks);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, kClassicThreads, shm, (cudaStream_t)stream>>>(
        p, (unsigned long long*)taken);
  }
#endif
  return (int)cudaGetLastError();
}
