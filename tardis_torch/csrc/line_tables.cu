// K3 line_tables: per-(line, shell) Sobolev tables and the per-shell tau
// prefix, in f64.
//
// Replaces: tardis_tpu/plasma/device_line.py:163 `impl` with
// `_two_float_cumsum` (:86), the JAX program that builds the (L, S) line
// tables of the classic convergence loop (its host twin is
// native.line_plasma_tables_full, plasma/solver.py:422).  The TPU program
// worked in f32 with log-space populations and a two-float prefix because
// the TPU has no f64; Hopper has f64, so this kernel follows the host
// formulas of plasma/lte.py in f64 directly.
//
// Bound on the H100: bytes.  It reads the level populations and five
// per-line arrays and writes four (L, S) f64 tables plus the (S, L+1)
// prefix, ~150 MB at bench scale (L = 183,060, S = 20), with a few dozen
// flops per element.  Design: reduce, then scan, over tiles of kTile lines
// that fill the card (2,861 tiles at bench scale), in three passes:
//   A. one block per tile of kTile lines x a chunk of shells (all S shells
//      while they fit the block's shared memory; the tile is then one
//      contiguous span of the (L, S) layout).  Each thread computes stim,
//      tau, beta and j_blues of its elements in f64 in registers and stores
//      them coalesced; tau is staged in shared memory transposed to
//      (shells, kTile), where each shell's tile is scanned (below) and its
//      sum written to a small (S, n_tiles) array;
//   B. one block per shell scans that shell's tile sums (an (S, n_tiles)
//      array) into the tiles' carries (exclusive), in a fixed order;
//   C. one block per tile re-reads its tau tile (coalesced), stages and
//      scans it as pass A did, and writes carry + scan into the (S, L+1)
//      prefix rows (leading 0 included), each shell's span contiguous.
// The scan of a shell's tile is the same in A and C: a Kogge-Stone warp
// scan of each 32-line segment, then the segment sums added left to right.
// Every association is fixed, so the prefix is bitwise the same from run to
// run (no decoupled look-back, whose association depends on timing).  The
// per-shell inputs h / (k T_rad) and W arrive by value in the kernel's
// parameters while 2 S doubles fit (S <= kShellsByValue), else from a
// device buffer.  Built with --fmad=false (see tardis_torch/cuda.py).
//
// The estimators instantiation (``detailed`` radiative rates,
// tardis_tpu/plasma/solver.py:458-465): pass A also reads an (L, S) f64
// table of estimator j_blues and keeps each positive one in place of the
// dilute-Planck value, which it scales by w_epsilon elsewhere: one more f64
// read a line-shell, no extra pass.  Without estimators pass A is the
// same code as before the option existed (a template parameter).
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTile = 64;             // lines per tile
constexpr int kSegments = kTile / 32;  // warp segments per shell's tile
constexpr int kThreads = 256;
constexpr int kShellsByValue = 128;    // 2 KB of per-shell inputs by value
constexpr int kMaxChunk = 87;          // shells per block: 87 x (kTile + 6) x 8 B < 48 KB
constexpr int kCarryThreads = 1024;    // pass B: one block a shell,
constexpr int kCarryItems = 4;         // 4 tiles a thread

struct ShellInputs {
  double h_over_kt[kShellsByValue];
  double jb_w[kShellsByValue];
};

struct LineArgs {
  const double* level_pop;  // (n_levels, S)
  const int32_t* lower_idx;
  const int32_t* upper_idx;
  const double* g_lower;
  const double* g_upper;
  const double* wl_flu;     // wavelength * f_lu, (L,)
  const double* line_nu;    // Hz, (L,)
  const double* nu3_coef;   // 2 h nu^3 / c^2, (L,)
  const double* shell_dev;  // (2 S,) [h / (k T_rad), W] when S > kShellsByValue
  const double* j_est;      // (L, S) estimator j_blues, or null
  double w_epsilon;
  double sobolev_coefficient, time_explosion;
  int64_t L;
  int S, chunk;             // shells per block (blockIdx.y picks the chunk)
  double* stim;
  double* tau;
  double* beta;
  double* jb;
  double* tile_sums;        // (S, n_tiles)
  double* carries;          // (S, n_tiles) exclusive
  int64_t n_tiles;
  double* prefix;           // (S, L+1)
};

__device__ __forceinline__ double warp_inclusive_scan(double v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    double o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += o;
  }
  return v;
}

// the tile's lines, and the chunk's first shell and width
struct Tile {
  int64_t b, l0;
  int n_lines, s0, sc;
};

__device__ __forceinline__ Tile make_tile(const LineArgs& a, int64_t b, int chunk) {
  Tile t;
  t.b = b;
  t.l0 = b * kTile;
  t.n_lines = (int)min((int64_t)kTile, a.L - t.l0);
  t.s0 = chunk * a.chunk;
  t.sc = min(a.chunk, a.S - t.s0);
  return t;
}

// scan each staged shell row of ``sh`` ((sc, kTile + 1), zero past the
// tile's lines) in place within its 32-line segments, and write each
// segment's exclusive offset to ``seg`` ((sc, kSegments)); returns after a
// barrier, with ``seg_total[s]`` the tile's sum for each shell s < sc
__device__ __forceinline__ void scan_tile(double* sh, double* seg, double* seg_total,
                                          int sc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int task = warp; task < sc * kSegments; task += kThreads / 32) {
    const int s = task / kSegments, k = task - s * kSegments;
    double* x = sh + s * (kTile + 1) + k * 32;
    const double v = warp_inclusive_scan(x[lane]);
    x[lane] = v;
    if (lane == 31) seg[s * kSegments + k] = v;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < sc; s += kThreads) {
    double run = 0.0;
#pragma unroll
    for (int k = 0; k < kSegments; ++k) {
      const double v = seg[s * kSegments + k];
      seg[s * kSegments + k] = run;
      run += v;
    }
    seg_total[s] = run;
  }
  __syncthreads();
}

// shared memory of one tile: sh (sc, kTile + 1), seg (sc, kSegments),
// seg_total, h / (k T_rad) and W (sc each)
struct TileSmem {
  double *sh, *seg, *seg_total, *hkt, *jbw;
};

__device__ __forceinline__ TileSmem tile_smem(double* smem, int sc) {
  TileSmem m;
  m.sh = smem;
  m.seg = m.sh + sc * (kTile + 1);
  m.seg_total = m.seg + sc * kSegments;
  m.hkt = m.seg_total + sc;
  m.jbw = m.hkt + sc;
  return m;
}

// stim, tau, beta and j_blues of line l in shell s (plasma/lte.py's
// formulas in their order); kEst: j_blues from the estimators where they
// are positive
struct LineValues {
  double stim, tau, beta, jb;
};

template <bool kEst>
__device__ __forceinline__ LineValues line_values(const LineArgs& a, int64_t l, int s,
                                                  double h_over_kt, double jb_w) {
  const int S = a.S;
  const double n_lower = a.level_pop[(int64_t)a.lower_idx[l] * S + s];
  const double n_upper = a.level_pop[(int64_t)a.upper_idx[l] * S + s];
  LineValues v;
  // lte.stimulated_emission_factor: non-finite ratios count as 1
  double ratio = (a.g_lower[l] * n_upper) / (a.g_upper[l] * n_lower);
  if (!isfinite(ratio)) ratio = 1.0;
  v.stim = fmax(1.0 - ratio, 0.0);
  // lte.tau_sobolev, evaluated in the same order
  v.tau = a.sobolev_coefficient * a.wl_flu[l] * a.time_explosion * v.stim * n_lower;
  // lte.beta_sobolev
  if (v.tau > 1e3) v.beta = 1.0 / v.tau;
  else if (v.tau < 1e-4) v.beta = 1.0 - 0.5 * v.tau;
  else v.beta = -expm1(-v.tau) / v.tau;
  // jb_w * lte.intensity_black_body
  const double x = fmin(a.line_nu[l] * h_over_kt, 700.0);
  v.jb = jb_w * (a.nu3_coef[l] / expm1(x));
  if constexpr (kEst) {
    const double e = a.j_est[l * S + s];
    v.jb = e > 0.0 ? e : a.w_epsilon * v.jb;
  }
  return v;
}

__device__ __forceinline__ void store_values(const LineArgs& a, int64_t i,
                                             const LineValues& v) {
  a.stim[i] = v.stim;
  a.tau[i] = v.tau;
  a.beta[i] = v.beta;
  a.jb[i] = v.jb;
}

// pass A on one tile: its four tables and its per-shell tau sums
template <bool kEst>
__device__ __forceinline__ void tile_elements(const LineArgs& a, const ShellInputs& shin,
                                              const Tile& t, double* smem) {
  const int S = a.S;
  const TileSmem m = tile_smem(smem, t.sc);
  // the chunk's per-shell inputs, once per tile (a warp's lanes span ~S
  // shells, so reading the parameters per element would serialize)
  for (int s = threadIdx.x; s < t.sc; s += kThreads) {
    const bool by_value = S <= kShellsByValue;
    m.hkt[s] = by_value ? shin.h_over_kt[t.s0 + s] : a.shell_dev[t.s0 + s];
    m.jbw[s] = by_value ? shin.jb_w[t.s0 + s] : a.shell_dev[S + t.s0 + s];
  }
  __syncthreads();
  const int n = t.n_lines * t.sc;
  for (int e = threadIdx.x; e < kTile * t.sc; e += kThreads) {
    const int ll = e / t.sc;
    const int sl = e - ll * t.sc;
    double tv = 0.0;
    if (e < n) {
      const LineValues v =
          line_values<kEst>(a, t.l0 + ll, t.s0 + sl, m.hkt[sl], m.jbw[sl]);
      store_values(a, (t.l0 + ll) * S + t.s0 + sl, v);
      tv = v.tau;
    }
    m.sh[sl * (kTile + 1) + ll] = tv;
  }
  __syncthreads();
  scan_tile(m.sh, m.seg, m.seg_total, t.sc);
  for (int s = threadIdx.x; s < t.sc; s += kThreads)
    a.tile_sums[(t.s0 + s) * a.n_tiles + t.b] = m.seg_total[s];
}

// pass C on one tile: its prefix, carry + the tile's scan
__device__ __forceinline__ void tile_prefix(const LineArgs& a, const Tile& t,
                                            double* smem) {
  const int S = a.S;
  const TileSmem m = tile_smem(smem, t.sc);
  const int n = t.n_lines * t.sc;
  for (int e = threadIdx.x; e < kTile * t.sc; e += kThreads) {
    const int ll = e / t.sc;
    const int sl = e - ll * t.sc;
    m.sh[sl * (kTile + 1) + ll] = e < n ? a.tau[(t.l0 + ll) * S + t.s0 + sl] : 0.0;
  }
  __syncthreads();
  scan_tile(m.sh, m.seg, m.seg_total, t.sc);
  const int64_t L = a.L;
  for (int e = threadIdx.x; e < t.sc * kTile; e += kThreads) {
    const int sl = e / kTile;
    const int ll = e - sl * kTile;
    if (ll >= t.n_lines) continue;
    const int s = t.s0 + sl;
    const double carry = a.carries[s * a.n_tiles + t.b];
    double* row = a.prefix + (int64_t)s * (L + 1);
    row[t.l0 + ll + 1] = carry + (m.seg[sl * kSegments + (ll >> 5)] + m.sh[sl * (kTile + 1) + ll]);
    if (t.b == 0 && ll == 0) row[0] = 0.0;
  }
}

// at most 40 registers, so that 6 blocks share an SM: its f64 arithmetic
// (two expm1 and two divisions an element) then overlaps its stores
// (0.080 -> 0.069 ms at the bench shape on an H100 80GB HBM3 at 700 W)
template <bool kEst>
__global__ void __launch_bounds__(kThreads, 6) line_elements_kernel(LineArgs a,
                                                                 ShellInputs shin) {
  extern __shared__ double smem[];
  tile_elements<kEst>(a, shin, make_tile(a, blockIdx.x, blockIdx.y), smem);
}

// pass B: shell blockIdx.x's carries, the exclusive scan of its tile sums,
// kCarryItems consecutive tiles a thread: the chunk's sums are loaded
// coalesced into shared memory, each thread adds its run, the runs' sums
// are scanned across the block (warp scans, then the warps' sums), and
// each thread writes its run's carries
__global__ void __launch_bounds__(kCarryThreads) carry_kernel(LineArgs a) {
  __shared__ double vals[kCarryThreads * kCarryItems];
  __shared__ double warp_sums[kCarryThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t n_tiles = a.n_tiles;
  const double* sums = a.tile_sums + blockIdx.x * n_tiles;
  double* carries = a.carries + blockIdx.x * n_tiles;
  constexpr int kChunk = kCarryThreads * kCarryItems;
  double carry = 0.0;
  for (int64_t base = 0; base < n_tiles; base += kChunk) {
#pragma unroll
    for (int k = 0; k < kCarryItems; ++k) {
      const int64_t b = base + k * kCarryThreads + threadIdx.x;
      vals[k * kCarryThreads + threadIdx.x] = b < n_tiles ? sums[b] : 0.0;
    }
    __syncthreads();
    double v[kCarryItems];
    double run = 0.0;
#pragma unroll
    for (int k = 0; k < kCarryItems; ++k) {
      v[k] = vals[threadIdx.x * kCarryItems + k];
      run += v[k];
    }
    const double incl = warp_inclusive_scan(run);
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) warp_sums[lane] = warp_inclusive_scan(warp_sums[lane]);
    __syncthreads();
    // this thread's exclusive offset: its warp's offset plus the inclusive
    // value of the lane before it
    const double left = __shfl_up_sync(0xffffffffu, incl, 1);
    double c = carry + ((warp > 0 ? warp_sums[warp - 1] : 0.0) + (lane > 0 ? left : 0.0));
#pragma unroll
    for (int k = 0; k < kCarryItems; ++k) {
      vals[threadIdx.x * kCarryItems + k] = c;
      c += v[k];
    }
    carry += warp_sums[kCarryThreads / 32 - 1];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kCarryItems; ++k) {
      const int64_t b = base + k * kCarryThreads + threadIdx.x;
      if (b < n_tiles) carries[b] = vals[k * kCarryThreads + threadIdx.x];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads) prefix_kernel(LineArgs a) {
  extern __shared__ double smem[];
  tile_prefix(a, make_tile(a, blockIdx.x, blockIdx.y), smem);
}

}  // namespace

// The per-shell inputs come as a host array shell_host = [h / (k T_rad)
// (S), W (S)], read during this call, when S <= kShellsByValue; otherwise
// as the device array shell_dev of the same layout.  scratch holds 2
// n_tiles S doubles (tile sums and carries), n_tiles = ceil(L / kTile).
// j_est, where not null, is the (L, S) estimator table of the estimators
// instantiation.
extern "C" int line_tables(
    const void* level_pop, const void* lower_idx, const void* upper_idx,
    const void* g_lower, const void* g_upper, const void* wl_flu,
    const void* line_nu, const void* nu3_coef, const double* shell_host,
    const void* shell_dev, double sobolev_coefficient, double time_explosion,
    int64_t L, int S, void* stim, void* tau, void* beta, void* jb,
    void* prefix, void* scratch, const void* j_est, double w_epsilon,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S <= 0) return 0;
  if (S > kShellsByValue && shell_dev == nullptr) return (int)cudaErrorInvalidValue;
  ShellInputs shin{};
  if (S <= kShellsByValue) {
    for (int s = 0; s < S; ++s) {
      shin.h_over_kt[s] = shell_host[s];
      shin.jb_w[s] = shell_host[S + s];
    }
  }
  const int64_t n_tiles = L > 0 ? (L + kTile - 1) / kTile : 0;
  const int n_chunks = (S + kMaxChunk - 1) / kMaxChunk;
  LineArgs a;
  a.level_pop = (const double*)level_pop;
  a.lower_idx = (const int32_t*)lower_idx;
  a.upper_idx = (const int32_t*)upper_idx;
  a.g_lower = (const double*)g_lower;
  a.g_upper = (const double*)g_upper;
  a.wl_flu = (const double*)wl_flu;
  a.line_nu = (const double*)line_nu;
  a.nu3_coef = (const double*)nu3_coef;
  a.shell_dev = (const double*)shell_dev;
  a.j_est = (const double*)j_est;
  a.w_epsilon = w_epsilon;
  a.sobolev_coefficient = sobolev_coefficient;
  a.time_explosion = time_explosion;
  a.L = L;
  a.S = S;
  a.chunk = (S + n_chunks - 1) / n_chunks;
  a.stim = (double*)stim;
  a.tau = (double*)tau;
  a.beta = (double*)beta;
  a.jb = (double*)jb;
  a.n_tiles = n_tiles;
  a.tile_sums = (double*)scratch;
  a.carries = (double*)scratch + n_tiles * S;
  a.prefix = (double*)prefix;
  if (n_tiles == 0) {
    // no lines: each prefix row is its leading 0
    return (int)cudaMemsetAsync(prefix, 0, (size_t)S * sizeof(double), st);
  }
  const size_t shm = (size_t)a.chunk * (kTile + 1 + kSegments + 3) * sizeof(double);
  const dim3 grid((unsigned)n_tiles, (unsigned)n_chunks);
  if (a.j_est != nullptr)
    line_elements_kernel<true><<<grid, kThreads, shm, st>>>(a, shin);
  else
    line_elements_kernel<false><<<grid, kThreads, shm, st>>>(a, shin);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  carry_kernel<<<S, kCarryThreads, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  prefix_kernel<<<grid, kThreads, shm, st>>>(a);
  return (int)cudaGetLastError();
}
