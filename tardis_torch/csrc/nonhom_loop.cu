// K7 nonhom_loop: the Monte Carlo packet event loop of one iteration under
// a piecewise-linear velocity law (nonhomologous expansion), scatter /
// downbranch / macroatom line interaction, with the iteration's luminosity
// summary.
//
// Replaces: tardis_tpu/transport/nonhomologous.py:198 `make_nonhom_step`
// with `_nonhom_pred_search` (:133) and `_beta_los` (:128), driven by
// `nonhom_transport_loop` (:540); the RNG-walk macro atom
// tardis_tpu/transport/kernel.py:281 `_macro_walk` with `_uniform_from_key`
// (:229) and `_bsearch_first_true` (:240) is the device function
// `tardis::macro_walk` (macro_walk.cuh, shared with K1's walk
// instantiations); `_step_uniforms` (:209) and `_distance_boundary`
// (:256) as in K1.
//
// Bound on the H100: what an event waits on, as K1.  An event hashes two or
// three uniforms, finds its walked window's bounds (one or two counts of
// the lines above a frequency), searches the window of the f64 tau prefix
// of its shell (forward, or the reversed-order prefix for a blueshifting
// walk; 2 x 29 MB at bench scale against the 50 MB L2), runs a fixed
// 30-step f32 bisection for the event line's distance (arithmetic, ~20
// operations a step) and, where its caller reads them, scatters four f64
// atomics into the line difference array; a line interaction in the macro
// modes walks up to 40 jumps, each a hash and a search of one transition
// block.  Timing variants on an H100 80GB HBM3 at 700 W (2,097,152
// packets) showed idle lanes first: one thread a packet left a warp 46%
// busy in macroatom mode and 35% in scatter mode, whose tail of events a
// packet is longer; then the registers (71-85 a lane, 24 warps an SM) and
// the counts' full-list searches.  Design:
//   - one launch of a persistent grid whose lanes take packets from a
//     queue (tardis::lane_loop, event_loop.cuh), so a lane whose packet
//     ends takes the next at once;
//   - __launch_bounds__(128, 8): at most 64 registers a lane (some spilled
//     to the L1), 32 resident warps an SM; with the count search below,
//     (128, 10) and its 48 registers measured 1-10% slower;
//   - the window's counts gallop outward from the packet's next line
//     (count_above_near); a count is a function of the frequency alone on
//     the sorted list, so any search order finds it;
//   - the line difference array only in the instantiations whose caller
//     reads it (NH_LINE_ESTIMATORS; the final iteration);
//   - the per-row predicate is the JAX package's inverted one (the line lies
//     beyond the line-of-sight velocity at the distance the remaining
//     optical depth allows), evaluated on f64 prefix differences rounded to
//     f32 instead of two-float pairs.  Where it is proven monotone over the
//     window (monotone_window: beta_los monotone in the walk's direction
//     over every x_req the window gives) a bisection finds its first true
//     line; elsewhere (a shell whose velocity falls steeply outward,
//     extrapolated past its boundary) the predicate can turn back, and
//     count_search counts false samples at the JAX package's three levels
//     of 128, so both packages take the same line.  The plain version
//     takes the same branch.  On the nonhomologous path's perturbed law
//     4-8% of the events take the count search, nearly every warp step has
//     one, so a lane's count is made by the converged lanes together
//     (counted_lines), 32 samples a round.  The walked window's bounds are
//     searches of
//     the descending line list with the JAX package's sides (strictly
//     above, at or above) and its 3e-7 margin;
//   - beta_los's rsqrt is written x * (1 / sqrt(.)), both correctly
//     rounded, so the plain PyTorch version reproduces it; tau_event =
//     -log(u) in f64 rounded to f32; built with --fmad=false;
//   - the walk's jump draws are uniform(fold_in(event key, 8 + jump), ()),
//     hashed only when a line interaction walks, so a scatter-mode event
//     hashes no more than K1's;
//   - the bulk estimators go to each lane's run (tardis::ShellRun),
//     flushed to the block's shared sums at a shell change, the luminosity
//     sums to shared memory, each block's flushed once; the line difference
//     array takes global f64 atomics;
//   - a packet still alive after max_events events is stopped without
//     output and counted (summary[3]).
//
// Options, each a compile-time template parameter chosen by -D flags
// (NH_MACRO, NH_LAST_INTERACTION, NH_TRACKER, NH_REFLECTIVE,
// NH_LINE_ESTIMATORS; the wrapper builds one library per combination): the
// macro-atom walk (downbranch and macroatom; max_jumps 1 and 40),
// last-interaction rows [type, in_line, out_line, shell, in_nu, r] kept in
// registers, the r-packet tracker rows [r, nu, energy, shell, code, 0]
// after each of the first K events, the reflective inner boundary (column
// 5 hashed only at the core), and the line difference array (on by
// default).
#include <cuda_runtime.h>
#include <cstdint>

#include "event_loop.cuh"
#include "macro_walk.cuh"
#include "threefry.cuh"

#ifndef NH_MACRO
#define NH_MACRO 0
#endif
#ifndef NH_LAST_INTERACTION
#define NH_LAST_INTERACTION 0
#endif
#ifndef NH_TRACKER
#define NH_TRACKER 0
#endif
#ifndef NH_REFLECTIVE
#define NH_REFLECTIVE 0
#endif
#ifndef NH_LINE_ESTIMATORS
#define NH_LINE_ESTIMATORS 1
#endif

namespace {

constexpr int kEvBoundary = 0;
constexpr int kEvLine = 1;
constexpr int kEvEscat = 2;
constexpr float kUMin = 1e-9f;
constexpr float kCloseLine = 1.0000003f;  // 1 + CLOSE_LINE_MARGIN in f32
constexpr float kXReqCap = 1e15f;
constexpr int kBisectionSteps = 30;
constexpr uint32_t kColAlbedo = 5;

struct Params {
  const float* pool_mu;
  const float* pool_nu;
  const float* r_inner;
  const float* r_outer;
  const float* beta_in;
  const float* m_grad;
  const float* chi_e;
  const float* line_nu;
  const double* prefix;      // (S, L+1) forward
  const double* rev_prefix;  // (S, L+1) reversed line order
  const int32_t* line2macro;
  const float* cum_prob;     // (T, S)
  const int32_t* block_start;
  const int32_t* dest;
  const bool* emit;
  const int32_t* mline;
  float* out;          // (N, 2): signed nu, energy
  double* est_j;       // (S,)
  double* est_nubar;   // (S,)
  double* line_diff;   // ((L+1)*S*2,)
  double* summary;     // [emitted in window, reabsorbed, events, immortal]
  float* last_interaction;  // (N, 6)
  float* tracker;           // (N, K, 6)
  int64_t n_packets;
  int64_t L;
  int64_t max_events;
  int S, max_jumps, disable_line_scattering, tracker_length;
  float nu_lo, nu_hi, albedo;
  tardis::Key key;
};

__device__ __forceinline__ float draw(tardis::Key k, uint32_t column) {
  return tardis::uniform_f32(tardis::random_bits(k, column), kUMin, 1.0f);
}

__device__ __forceinline__ float beta_los(float m, float q, float p2, float x) {
  return m * x + q * x * (1.0f / sqrtf(p2 + x * x));
}

// One event's walked window and what its predicate reads: the shell's
// prefix row in walk order (forward, or the reversed line order), the
// prefix at the window's start, the remaining optical depth and the chord.
struct EventWindow {
  const double* prow;
  double c0;
  const float* line_nu;
  int64_t L;
  float tau_event, inv_chi, x0, p2, m, q, nu;
  bool fwd;
};

// the distance the optical depth left after walk-order line i allows
// (d_req) and the chord coordinate it reaches (x_req), from the f64 prefix
// difference rounded to f32
__device__ __forceinline__ float2 reach(const EventWindow& w, int64_t i) {
  const double c = w.prow[i + 1];
  const float dC = (float)(c - w.c0);
  const float d_req = (w.tau_event - dC) * w.inv_chi;
  return make_float2(d_req, fminf(w.x0 + fmaxf(d_req, 0.0f), kXReqCap));
}

// the inverted event predicate of walk-order line i: the line lies beyond
// the line-of-sight velocity at x_req, or the optical depth is spent
__device__ __forceinline__ bool window_pred(const EventWindow& w, int64_t i) {
  const float2 r = reach(w, i);
  const float b_req = beta_los(w.m, w.q, w.p2, r.y);
  const float nl = w.fwd ? w.line_nu[i] : w.line_nu[w.L - 1 - i];
  const float n_row = 1.0f - nl / w.nu;
  const bool ahead = w.fwd ? (n_row > b_req) : (n_row < b_req);
  return (r.x < 0.0f) || ahead;
}

// beta_los'(x) = m + q p^2 / (p^2 + x^2)^(3/2), in f64
__device__ __forceinline__ double los_slope(double m, double q, double p2, double x) {
  const double s = p2 + x * x;
  return m + q * (p2 / (s * sqrt(s)));
}

// true where the predicate is proven monotone over the window [lo, hi), so
// that the bisection finds the count search's line (proof at
// tardis_torch/transport/nonhomologous.py `monotone_window`): every row's
// x_req lies between those of the window's last and first lines; there beta_los' is affine in g(|x|) = p^2 / (p^2 + x^2)^(3/2), which
// falls with |x|, so its sign over the interval is its sign at the nearest
// and farthest |x|.  Non-decreasing serves a forward walk, non-increasing a
// backward one; NaN (p^2 = 0 at x = 0) proves nothing.
__device__ __forceinline__ bool monotone_window(const EventWindow& w, int64_t lo, int64_t hi) {
  const double a = (double)reach(w, hi - 1).y, b = (double)reach(w, lo).y;
  const double near = (a <= 0.0 && b >= 0.0) ? 0.0 : fmin(fabs(a), fabs(b));
  const double far = fmax(fabs(a), fabs(b));
  const double m = (double)w.m, q = (double)w.q, p2 = (double)w.p2;
  const double s_near = los_slope(m, q, p2, near), s_far = los_slope(m, q, p2, far);
  return w.fwd ? (s_near >= 0.0 && s_far >= 0.0) : (s_near <= 0.0 && s_far <= 0.0);
}

// the JAX package's sample stride factor (tiled_search.py's 128-ary tiles)
constexpr int64_t kTile = 128;

// of the kTile samples base + k stride, those whose predicate is false: a
// sample below lo counts as false, one at hi or beyond as true, and only the
// samples inside [lo, hi) are evaluated, spread over the ``mask`` lanes
// (each evaluates every participants-th sample from its rank on; a ballot
// counts the false ones)
__device__ __forceinline__ int64_t false_samples(const EventWindow& w, int64_t lo, int64_t hi,
                                                 int64_t base, int64_t stride,
                                                 unsigned mask, int rank, int participants) {
  auto below = [&](int64_t x) -> int64_t {
    if (x <= base) return 0;
    const int64_t n = (x - base + stride - 1) / stride;
    return n < kTile ? n : kTile;
  };
  const int64_t k_lo = below(lo), k_hi = below(hi);
  int64_t n = k_lo;
  for (int64_t k0 = k_lo; k0 < k_hi; k0 += participants) {
    const int64_t k = k0 + rank;
    const bool is_false = k < k_hi && !window_pred(w, base + k * stride);
    n += __popc(__ballot_sync(mask, is_false));
  }
  return n;
}

// the line tardis_tpu/transport/nonhomologous.py:133 `_nonhom_pred_search`
// returns for one lane's window: the count of false samples at every
// kTile^2-th line, then every kTile-th line from the last coarse sample
// before that count, then every line of one tile (every level on the exact
// prefix difference, where the JAX package's coarse levels read f32-rounded
// prefixes), counted by the ``mask`` lanes together
__device__ __forceinline__ int64_t count_search(const EventWindow& w, int64_t lo, int64_t hi,
                                                unsigned mask, int rank, int participants) {
  const int64_t t0 = (w.L + kTile - 1) / kTile;
  const int64_t t1 = (t0 + kTile - 1) / kTile;
  const int64_t c2 =
      false_samples(w, lo, hi, 0, kTile * kTile, mask, rank, participants);
  const int64_t tile1 = c2 - 1 < 0 ? 0 : (c2 - 1 > t1 - 1 ? t1 - 1 : c2 - 1);
  const int64_t c1 =
      false_samples(w, lo, hi, tile1 * kTile * kTile, kTile, mask, rank, participants);
  const int64_t u = tile1 * kTile + c1 - 1;
  const int64_t tile0 = u < 0 ? 0 : (u > t0 - 1 ? t0 - 1 : u);
  const int64_t c0 = false_samples(w, lo, hi, tile0 * kTile, 1, mask, rank, participants);
  const int64_t i = tile0 * kTile + c0;
  return i < lo ? lo : (i > hi ? hi : i);
}

// The count search of every lane of the converged set that needs one
// (``counted``), one lane's window after another, each counted by all the
// lanes together: a count search samples up to ~260 lines, a bisection
// ~17, so one lane's search would hold its warp.  Returns the calling
// lane's line (``a`` where it needs none).  Taken only where
// monotone_window fails, so kept out of line, its window passed by value
// (a window whose address is taken would live in local memory on every
// event).
__device__ __noinline__ int64_t counted_lines(const double* prow, double c0,
                                              const float* line_nu, int64_t L, float tau_event,
                                              float inv_chi, float x0, float p2, float m,
                                              float q, float nu, bool fwd, int64_t lo,
                                              int64_t hi, bool counted, int64_t a) {
  const unsigned mask = __activemask();
  unsigned todo = __ballot_sync(mask, counted);
  const int lane = threadIdx.x & 31;
  const int rank = __popc(mask & ((1u << lane) - 1u));
  const int participants = __popc(mask);
  while (todo != 0) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1u;
    EventWindow v;
    v.prow = reinterpret_cast<const double*>(
        __shfl_sync(mask, reinterpret_cast<unsigned long long>(prow), src));
    v.c0 = __shfl_sync(mask, c0, src);
    v.line_nu = line_nu;
    v.L = L;
    v.tau_event = __shfl_sync(mask, tau_event, src);
    v.inv_chi = __shfl_sync(mask, inv_chi, src);
    v.x0 = __shfl_sync(mask, x0, src);
    v.p2 = __shfl_sync(mask, p2, src);
    v.m = __shfl_sync(mask, m, src);
    v.q = __shfl_sync(mask, q, src);
    v.nu = __shfl_sync(mask, nu, src);
    v.fwd = __shfl_sync(mask, (int)fwd, src) != 0;
    const int64_t v_lo = __shfl_sync(mask, (long long)lo, src);
    const int64_t v_hi = __shfl_sync(mask, (long long)hi, src);
    const int64_t found = count_search(v, v_lo, v_hi, mask, rank, participants);
    if (lane == src) a = found;
  }
  return a;
}

// lines with nu_i > nu (kIncl false) or nu_i >= nu (true), on the
// descending line list
template <bool kIncl>
__device__ __forceinline__ int64_t count_above(const float* line_nu, int64_t L,
                                               float nu) {
  int64_t lo = 0, hi = L;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const bool above = kIncl ? (line_nu[mid] >= nu) : (line_nu[mid] > nu);
    if (above) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// count_above searched outward from ``hint``: a gallop (offsets 1, 2, 4,
// ...) towards the answer, then a bisection of the bracket.  The count is
// a function of nu alone (the list is sorted), so any search order gives
// it; the walked window's bounds lie near the packet's next line.
template <bool kIncl>
__device__ __forceinline__ int64_t count_above_near(const float* line_nu, int64_t L,
                                                    float nu, int64_t hint) {
  hint = hint < 0 ? 0 : (hint > L ? L : hint);
  int64_t lo, hi;
  if (hint < L && (kIncl ? (line_nu[hint] >= nu) : (line_nu[hint] > nu))) {
    lo = hint + 1;
    hi = L;
    for (int64_t span = 1;; span <<= 1) {
      const int64_t probe = hint + span;
      if (probe >= L) break;
      if (kIncl ? (line_nu[probe] >= nu) : (line_nu[probe] > nu)) {
        lo = probe + 1;
      } else {
        hi = probe;
        break;
      }
    }
  } else {
    lo = 0;
    hi = hint;
    for (int64_t span = 1;; span <<= 1) {
      const int64_t probe = hint - span;
      if (probe < 0) break;
      if (kIncl ? (line_nu[probe] >= nu) : (line_nu[probe] > nu)) {
        lo = probe + 1;
        break;
      }
      hi = probe;
    }
  }
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const bool above = kIncl ? (line_nu[mid] >= nu) : (line_nu[mid] > nu);
    if (above) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void track(const Params& p, int64_t pid, int64_t ev,
                                      float r, float nu, float energy, int shell,
                                      float code) {
  if (ev < p.tracker_length) {
    float2* row = reinterpret_cast<float2*>(
        p.tracker + (pid * p.tracker_length + ev) * 6);
    row[0] = make_float2(r, nu);
    row[1] = make_float2(energy, (float)shell);
    row[2] = make_float2(code, 0.0f);
  }
}

struct LastInteraction {
  float type = 0.0f, in_line = 0.0f, out_line = 0.0f, shell = 0.0f, in_nu = 0.0f,
        r = 0.0f;
};

// lanes of a K7 block, and the blocks an SM must hold (at most 64
// registers a lane)
constexpr int kNonhomThreads = 128;
constexpr int kNonhomMinBlocks = 8;

// One K7 packet on its lane (tardis::lane_loop's Walker): the state between
// two events, the lane's estimator run, and one event of the loop
// (nonhomologous.py:198).
template <bool kMacro, bool kLast, bool kTrack, bool kReflect, bool kLineEst>
struct NonhomWalker {
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

  __device__ NonhomWalker(const Params& params, double* j, double* nubar, double* sum)
      : p(params), sh_j(j), sh_nubar(nubar), sh_sum(sum) {}

  // birth: next_line = number of lines with nu_line >= nu_cmf
  __device__ __forceinline__ void birth(int64_t id) {
    pid = id;
    const float beta_birth = p.beta_in[0];
    mu = p.pool_mu[pid];
    const float nu_cmf0 = p.pool_nu[pid];
    next_line = count_above<true>(p.line_nu, p.L, nu_cmf0);
    const float inv_dop0 = 1.0f / (1.0f - mu * beta_birth);
    nu = nu_cmf0 * inv_dop0;
    energy = inv_dop0;
    r = p.r_inner[0];
    shell = 0;
    ev = 0;
    kp = tardis::fold_in(p.key, (uint32_t)pid);
    if constexpr (kLast) li = LastInteraction{};
  }

  __device__ __forceinline__ bool event() {
    const int S = p.S;
    const int64_t L = p.L;
    const tardis::Key ke = tardis::fold_in(kp, (uint32_t)ev);
    const float r_in = p.r_inner[shell];
    const float r_out = p.r_outer[shell];
    const float m = p.m_grad[shell];
    const float b_in = p.beta_in[shell];
    const float q = b_in - m * r_in;
    const float dop = 1.0f - mu * (b_in + m * (r - r_in));
    const float nu_cmf = nu * dop;
    const float inv_chi = 1.0f / p.chi_e[shell];

    // distance to the shell boundary (an inward hit needs mu < 0 strictly)
    const float out_d =
        sqrtf(fmaxf(r_out * r_out + (mu * mu - 1.0f) * r * r, 0.0f)) - r * mu;
    const float check = r_in * r_in + r * r * (mu * mu - 1.0f);
    const bool hits_inner = (mu < 0.0f) && (check >= 0.0f);
    const float in_d = -r * mu - sqrtf(fmaxf(check, 0.0f));
    const float d_b = fmaxf(hits_inner ? in_d : out_d, 0.0f);
    const int delta = hits_inner ? -1 : 1;
    const float x0 = mu * r;
    const float xb = x0 + d_b;
    const float p2 = fmaxf(r * r * (1.0f - mu * mu), 0.0f);
    const float nu_cmf_b = nu * (1.0f - beta_los(m, q, p2, xb));
    const bool fwd = nu_cmf_b <= nu_cmf;

    const float tau_event = (float)(-log((double)draw(ke, 0)));

    // the walked window [lo, hi) in walk-order indices: forward from
    // next_line to the lines above nu_cmf at the boundary; backward over
    // the reversed order, from the reddest line above nu_cmf (with the
    // margin) to the last line at or above the boundary frequency
    int64_t lo, hi, lo_f = 0, cnt_m = 0;
    const double* prow;
    if (fwd) {
      lo_f = next_line < 0 ? 0 : (next_line > L ? L : next_line);
      const int64_t c = count_above_near<false>(p.line_nu, L, nu_cmf_b, lo_f);
      lo = lo_f;
      hi = c < lo_f ? lo_f : (c > L ? L : c);
      prow = p.prefix + (int64_t)shell * (L + 1);
    } else {
      cnt_m = count_above_near<false>(p.line_nu, L, nu_cmf * kCloseLine, next_line);
      const int64_t c = count_above_near<true>(p.line_nu, L, nu_cmf_b, cnt_m);
      lo = L - cnt_m;
      hi = L - (c < cnt_m ? c : cnt_m);
      prow = p.rev_prefix + (int64_t)shell * (L + 1);
    }
    const EventWindow win{prow, prow[lo], p.line_nu, L, tau_event, inv_chi, x0, p2, m, q, nu, fwd};
    const bool counted = lo < hi && !monotone_window(win, lo, hi);
    int64_t a = lo;
    if (!counted) {
      int64_t b = hi;
      while (a < b) {
        const int64_t mid = (a + b) >> 1;
        if (window_pred(win, mid)) b = mid;
        else a = mid + 1;
      }
    }
    if (__any_sync(__activemask(), counted))
      a = counted_lines(prow, win.c0, p.line_nu, L, tau_event, inv_chi, x0, p2, m, q, nu, fwd,
                        lo, hi, counted, a);
    const bool found = a < hi;
    const int64_t k_before = a - lo;
    int64_t i_ev = fwd ? a : L - 1 - a;
    i_ev = i_ev < 0 ? 0 : (i_ev > L - 1 ? L - 1 : i_ev);
    const float tau_before = (float)(prow[a] - win.c0);
    const float tau_total = (float)(prow[hi] - win.c0);

    // the event line's distance: fixed-trip bisection of beta_los = n_ev
    // on [x0, xb]
    float s_ev = 0.0f;
    if (found) {
      const float n_ev = 1.0f - p.line_nu[i_ev] / nu;
      float lox = x0, hix = xb;
      for (int k = 0; k < kBisectionSteps; ++k) {
        const float xm = 0.5f * (lox + hix);
        const float f = beta_los(m, q, p2, xm) - n_ev;
        const bool go_lo = fwd ? (f < 0.0f) : (f > 0.0f);
        if (go_lo) lox = xm;
        else hix = xm;
      }
      s_ev = fmaxf(0.5f * (lox + hix) - x0, 0.0f);
    }
    const float d_cont_f = fmaxf((tau_event - tau_before) * inv_chi, 0.0f);
    const bool escat_f = p.disable_line_scattering || (d_cont_f < s_ev);
    const float d_cont_nf = fmaxf((tau_event - tau_total) * inv_chi, 0.0f);
    const bool escat_nf = d_cont_nf < d_b;
    int kind;
    float distance;
    int64_t k_crossed;
    if (found) {
      kind = escat_f ? kEvEscat : kEvLine;
      distance = escat_f ? d_cont_f : s_ev;
      k_crossed = escat_f ? k_before : k_before + 1;
    } else {
      kind = escat_nf ? kEvEscat : kEvBoundary;
      distance = escat_nf ? d_cont_nf : d_b;
      k_crossed = hi - lo;
    }

    // estimators: the bulk terms into the lane's run; the line difference
    // array only in the instantiation whose caller reads it
    const float w_j = (energy * dop) * distance;
    tardis::shell_run_add(run, shell, w_j, w_j * nu_cmf, sh_j, sh_nubar);
    const int64_t rng_lo = fwd ? lo_f : cnt_m - k_crossed;
    const int64_t rng_hi = fwd ? lo_f + k_crossed : cnt_m;
    if constexpr (kLineEst) {
      if (rng_lo != rng_hi) {
        const float w1 = energy / (nu * nu);
        const float w2 = energy / nu;
        double* da = p.line_diff + (rng_lo * S + shell) * 2;
        double* db = p.line_diff + (rng_hi * S + shell) * 2;
        atomicAdd(da, (double)w1);
        atomicAdd(da + 1, (double)w2);
        atomicAdd(db, -(double)w1);
        atomicAdd(db + 1, -(double)w2);
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
        if constexpr (kTrack) track(p, pid, ev, r_new, nu, energy, shell, 3.0f);
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
      next_line = fwd ? rng_hi : rng_lo;
      if constexpr (kTrack) track(p, pid, ev, r, nu, energy, shell, 3.0f);
      return true;
    }

    // Thomson scatter or line interaction: new direction drawn in the CMF
    // at the interaction point (interactions stay in the shell)
    const float mu_draw = 2.0f * draw(ke, 1) - 1.0f;
    const float beta_new = b_in + m * (r_new - r_in);
    const float dop_old_pos = 1.0f - mu_new * beta_new;
    const float inv_dop_new = 1.0f / (1.0f - mu_draw * beta_new);
    const float nu_in = nu;
    if (kind == kEvEscat) {
      nu = nu * dop_old_pos * inv_dop_new;
      next_line = fwd ? rng_hi : rng_lo;
      if constexpr (kLast) {
        li.type = 1.0f;
        li.in_line = -1.0f;
        li.out_line = -1.0f;
      }
    } else {
      int64_t em_line = i_ev;
      if constexpr (kMacro) em_line = tardis::macro_walk(p, ke, shell, i_ev);
      nu = p.line_nu[em_line] * inv_dop_new;
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
    mu = mu_draw;
    if constexpr (kTrack)
      track(p, pid, ev, r, nu, energy, shell, kind == kEvLine ? 2.0f : 1.0f);
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

// K7's loop: a persistent grid whose lanes walk the packet queue
// (tardis::lane_loop); the block's shared sums flush once, at exit.
template <bool kMacro, bool kLast, bool kTrack, bool kReflect, bool kLineEst>
__global__ void __launch_bounds__(kNonhomThreads, kNonhomMinBlocks)
    nonhom_loop_kernel(Params p, unsigned long long* taken) {
  extern __shared__ double shm[];
  double* sh_j = shm;
  double* sh_nubar = shm + p.S;
  double* sh_sum = shm + 2 * p.S;
  for (int i = threadIdx.x; i < 2 * p.S + 4; i += blockDim.x) shm[i] = 0.0;
  __syncthreads();
  NonhomWalker<kMacro, kLast, kTrack, kReflect, kLineEst> w(p, sh_j, sh_nubar, sh_sum);
  tardis::lane_loop(w, taken, p.n_packets, p.max_events);
  __syncthreads();
  for (int i = threadIdx.x; i < p.S; i += blockDim.x) {
    atomicAdd(&p.est_j[i], sh_j[i]);
    atomicAdd(&p.est_nubar[i], sh_nubar[i]);
  }
  if (threadIdx.x < 4) atomicAdd(&p.summary[threadIdx.x], sh_sum[threadIdx.x]);
}

}  // namespace

extern "C" int nonhom_loop(
    const void* pool_mu, const void* pool_nu, int64_t n_packets,
    const void* r_inner, const void* r_outer, const void* beta_in,
    const void* m_grad, const void* chi_e, const void* line_nu,
    const void* prefix, const void* rev_prefix, const void* line2macro,
    const void* cum_prob, const void* block_start, const void* dest,
    const void* emit, const void* mline, int64_t L, int S, int max_jumps,
    int disable_line_scattering, uint32_t k0, uint32_t k1, float nu_lo,
    float nu_hi, float albedo, int64_t max_events, void* out, void* est_j,
    void* est_nubar, void* line_diff, void* summary, void* last_interaction,
    void* tracker, int tracker_length, void* taken, void* stream) {
  constexpr bool kMacro = NH_MACRO != 0;
  constexpr bool kLineEst = NH_LINE_ESTIMATORS != 0;
  if ((kMacro && (cum_prob == nullptr || line2macro == nullptr)) || taken == nullptr
      || (kLineEst != (line_diff != nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.pool_mu = (const float*)pool_mu;
  p.pool_nu = (const float*)pool_nu;
  p.r_inner = (const float*)r_inner;
  p.r_outer = (const float*)r_outer;
  p.beta_in = (const float*)beta_in;
  p.m_grad = (const float*)m_grad;
  p.chi_e = (const float*)chi_e;
  p.line_nu = (const float*)line_nu;
  p.prefix = (const double*)prefix;
  p.rev_prefix = (const double*)rev_prefix;
  p.line2macro = (const int32_t*)line2macro;
  p.cum_prob = (const float*)cum_prob;
  p.block_start = (const int32_t*)block_start;
  p.dest = (const int32_t*)dest;
  p.emit = (const bool*)emit;
  p.mline = (const int32_t*)mline;
  p.out = (float*)out;
  p.est_j = (double*)est_j;
  p.est_nubar = (double*)est_nubar;
  p.line_diff = (double*)line_diff;
  p.summary = (double*)summary;
  p.last_interaction = (float*)last_interaction;
  p.tracker = (float*)tracker;
  p.n_packets = n_packets;
  p.L = L;
  p.max_events = max_events;
  p.S = S;
  p.max_jumps = max_jumps;
  p.disable_line_scattering = disable_line_scattering;
  p.tracker_length = tracker_length;
  p.nu_lo = nu_lo;
  p.nu_hi = nu_hi;
  p.albedo = albedo;
  p.key = tardis::Key{k0, k1};
  if (n_packets > 0) {
    auto kernel = nonhom_loop_kernel<kMacro, NH_LAST_INTERACTION != 0, NH_TRACKER != 0,
                                     NH_REFLECTIVE != 0, kLineEst>;
    const size_t shm = (size_t)(2 * S + 4) * sizeof(double);
    unsigned blocks = 0;
    const cudaError_t err =
        tardis::persistent_blocks(kernel, kNonhomThreads, shm, n_packets, &blocks);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, kNonhomThreads, shm, (cudaStream_t)stream>>>(
        p, (unsigned long long*)taken);
  }
  return (int)cudaGetLastError();
}
