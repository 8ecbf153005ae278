// K8 macro_chain: the macro atom's absorbing-chain sampling tables of one
// iteration, in f64, rounded to f32 at the end.
//
// Replaces: tardis_tpu/opacities/macro_atom_solver.py:389 `_device_p_norm`
// and :404 `_device_chain_tables`, jitted into one XLA program a build
// (:380): block-normalised transition probabilities by segment sums, the
// emission rows, and one batched f32 LU solve B = (I - Q)^-1 diag(d) per
// power-of-two size bucket of (shell, component) systems, then the
// clamped, row-normalised running sums.  The port's plain version
// (opacities/macro_atom_solver.py `p_norm`, `chain_tables`) is the same in
// f64 with torch.linalg.solve_ex.
//
// What it writes, for shell s and level l (M levels, We emission slots, W
// chain slots):
//   emit_cdf[s M + l]  = [running sum of l's emission p_norm / its total
//                         (1.0 where the total is 0) | line ids | line nu];
//   chain_cdf[s M + l] = [running sum of max(B[l, :], 0) / its total over
//                         l's component | base level of the component];
// a row whose B is not finite (a singular system) or whose total is not
// > 0 takes the self-deactivation step (slot >= l's local slot).
//
// Bound on the H100: operations.  At the bench shape (20 shells, 18
// components of 200 levels: 360 systems) the elimination is 2 n^3 f64
// operations a system, 5.8e9 in all, while the inputs (three (L, S) f64
// tables, the transition table) and the two f32 row tables are ~0.2 GB;
// at 600 levels (the large-ion problem, 360 systems) 1.56e11 against
// ~1 GB.
//
// The systems of a build go to two instantiations by component size, one
// launch each on the same stream, writing disjoint rows (the wrapper,
// opacities/macro_atom_solver.py k8_plan; components largest first, so
// each launch takes a range of them); downbranch mode has a third:
//   - cluster (chain_cluster_kernel): one (component, shell) system a
//     thread-block cluster of 2, 4 or 8 blocks of CBLOCK threads, the
//     matrix's rows split across the blocks' shared memory (a multiple of
//     16 rows a block), so it never crosses device memory; a persistent
//     grid of as many clusters as the card holds at once; components of up
//     to 384 levels;
//   - large (chain_large_kernel): the components past a cluster's reach
//     (600 levels: 2.88 MB of matrix a system), each system spread over
//     `per` blocks of a persistent cooperative grid of one block a
//     multiprocessor, a few systems in flight (12 at 600 levels), so a few
//     large systems still fill the card; see below;
//   - downbranch (workspace_kernel): work groups of BLOCK levels, one a
//     block, the emission rows only.
// Common to all:
//   - the systems are taken in turn by the persistent grid, components
//     largest first, the shells of one component next to each other so
//     their lines' sectors are shared in L2;
//   - p of every transition is gathered into a workspace slot by many
//     threads, GATHER transitions each in flight; one thread a level then
//     sums its block in transition order, and one warp a level normalises
//     it, adds its row of Q and writes its emission row (consecutive lanes
//     on consecutive slots), every sum in transition order (level_warp): no
//     atomics, so the tables are bitwise the same from run to run, and the
//     emission rows and d are the plain version's bit for bit;
//   - A = I - Q is inverted in place by Gauss-Jordan without pivoting: Q
//     >= 0 and each row of Q sums to 1 - d <= 1 inside its closed
//     component, so A is an M-matrix, diagonally dominant by rows, where
//     elimination without pivoting is stable (growth <= 2; Higham,
//     Accuracy and Stability of Numerical Algorithms, Thm 9.9).  A pivot
//     that is 0 or not finite marks the system singular and all its rows
//     take the fallback (the JAX package's f32 solve gives NaN there,
//     which its rtot > 0 test sends to the same fallback);
//   - the elimination is blocked: KB pivots at a time on a panel of KB
//     columns, then one rank-KB update of the rest of the matrix, so the
//     matrix is read and written once a panel rather than once a pivot.
// The cluster instantiation's panel (KB = 16):
//   - after a cluster barrier every block copies the panel's KB rows (all
//     columns) from the blocks that hold them, through distributed shared
//     memory, and arrives on a second barrier; its first warp then runs
//     the KB pivot steps on the panel rows' KB x KB diagonal block
//     (panel_pivots), keeping each step's normalised pivot row; every
//     block does this on the same numbers, so all agree on the pivots and
//     on the singular flag without a word between them;
//   - after the second barrier (no block still reads rows this block
//     rewrites) one thread a row runs the same KB steps on its row's panel
//     columns in registers, with explicit fma, from the kept pivot rows;
//   - the trailing update A[i][j] = (i in panel ? 0 : A[i][j]) +
//     sum_p A[i][k0 + p] R[p][j] is an (own rows x KB) by (KB x n) product
//     on the f64 tensor cores (mma.sync m16n8k8, each warp a strip of 16
//     rows by 40 columns, A's fragments in registers for the strip), read
//     from and written to shared memory; A's and R's row strides put a
//     fragment's rows in distinct banks.  Meanwhile GATHER_WARPS warps
//     gather a slice of the next system's p into the slot's other buffer,
//     so a system's gather leaves the path of all but the grid's first.
// The large-system instantiation runs the cluster one's arithmetic, step
// for step and product for product, on another layout:
//   - a block holds ceil(n / per) consecutive rows of its system, the first
//     hs of them in its shared memory and the rest in the system's slot of
//     a device workspace, which the L2 cache keeps (the plan keeps at
//     least half of each block's rows in shared memory and the rest of
//     the systems in flight within ~40 MB);
//   - the panel's KB rows travel through the slot: whichever block holds a
//     row of the next panel writes it to the next of two panel buffers as
//     it finishes its update, and after a barrier of the system's blocks
//     (a counter in device memory, release / acquire: no grid-wide barrier,
//     no launch a panel) every block reads the panel's rows from there;
//     two buffers in turn, so one barrier a panel;
//   - warp 0 runs the pivot steps from the buffer while the other warps
//     copy the panel rows into shared memory, in chunks of at most CHUNK
//     columns (the only limit on n is the workspace);
//   - one thread a row takes the panel's steps on its panel columns, then
//     the trailing update runs on DMMA m16n8k8 as the cluster one's, its
//     fragments read from wherever the rows are.
// B = A^-1 diag(d) is formed in the last pass, with the clamp, the running
// sum, the division and the fallback fused: one warp a row, its lanes on
// consecutive columns, the running sum a fixed-order warp scan made
// non-decreasing by a running maximum (a sum of non-negative terms whose
// partial sums were grouped differently could fall by an ulp).  No
// division sees a zero numerator (div0): the compiled division's slow
// path would hold the whole warp.
// Built with --fmad=false (see tardis_torch/cuda.py): products are fused
// only where fma() or mma.sync says so.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int BLOCK = 256;        // threads a block (K8_BLOCK in the wrapper)
constexpr int WARPS = BLOCK / 32;
// f64 of the downbranch block's shared memory before its warps' staging
// (the tile the elimination it once shared a kernel with took; kept, so its
// launch is the one it always was)
constexpr int DOWN_TILE = 64;
// threads a block of the cluster instantiation (K8_CLUSTER_BLOCK in the
// wrapper), and its warps that gather the next system's p during the
// trailing updates (256 threads, and 1, 2 or 6 gathering warps, measured
// slower, 3 no faster: PERF.md, K8's redesign)
constexpr int CBLOCK = 512;
constexpr int CWARPS = CBLOCK / 32;
constexpr int GATHER_WARPS = 4;
constexpr int NJ = 5;             // 8-column tiles of a warp's strip (cluster)
constexpr int GATHER = 8;         // transitions a thread gathers at once
constexpr int SUM = 8;            // terms of a block sum loaded at once
constexpr int COPY = 4;           // 16-byte loads a thread has in flight
constexpr int SCAN = 4;           // 32-column chunks of a chain row at once
constexpr int STAGE = 64;         // f64 of a warp's staging for level_warp

// K8_PHASES builds (a benchmark's instantiation, never the wrapper's):
// thread 0 of each block adds the clock64() cycles of each phase of each
// system to k8_phase, read by macro_chain_phases
#ifdef K8_PHASES
__device__ unsigned long long k8_phase[16];
struct Phases {
  long long t, start;
  unsigned long long c[16];
  __device__ Phases() : t(0), start(0), c{} {
#ifdef __CUDA_ARCH__
    t = start = clock64();
#endif
  }
  __device__ void stamp(int i) {
    if (threadIdx.x == 0) {
      const long long now = clock64();
      c[i] += (unsigned long long)(now - t);
      t = now;
    }
  }
  __device__ void system() {
    if (threadIdx.x == 0) c[6] += 1;
  }
  __device__ void flush() {
    if (threadIdx.x == 0) {
      c[5] = (unsigned long long)(clock64() - start);
      for (int i = 0; i < 16; ++i) atomicAdd(&k8_phase[i], c[i]);
    }
  }
};
#else
struct Phases {
  __device__ void stamp(int) {}
  __device__ void system() {}
  __device__ void flush() {}
};
#endif

// The cluster instantiation's shared memory, in f64 (k8_cluster_smem in the
// wrapper repeats it): each block holds rows_of(n, cs) rows of A (a
// multiple of 16, an mma tile's rows), lda_of(n)
// apart (a multiple of 8 plus 4: an A or accumulator fragment's eight rows
// fall in distinct bank pairs), the panel rows R, ldr_of(n) apart (a
// multiple of 16 plus 8: a B fragment's four rows likewise), the kept
// pivot rows and the panel rows' final diagonal block (KB x KB each), d of
// every level of the system, and each warp's staging for level_warp.
__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
__host__ __device__ constexpr int rows_of(int n, int cs) {
  return round_up((n + cs - 1) / cs, 16);
}
__host__ __device__ constexpr int lda_of(int n) { return round_up(n, 8) + 4; }
__host__ __device__ constexpr int ldr_of(int n) {
  return round_up(n, 8) % 16 == 8 ? round_up(n, 8) : round_up(n, 8) + 8;
}
__host__ __device__ constexpr int64_t cluster_smem(int n, int cs, int kb) {
  return 8 * ((int64_t)rows_of(n, cs) * lda_of(n) + (int64_t)kb * ldr_of(n)
              + 2 * kb * kb + round_up(n, 2) + CWARPS * STAGE);
}

struct ChainArgs {
  const double* beta;   // (L, S)
  const double* jb;     // (L, S)
  const double* stim;   // (L, S)
  int S;
  const int32_t* refs;  // (M + 1,) transitions of level l: [refs[l], refs[l+1])
  const double* coef;   // (T,)
  const int32_t* line;  // (T,)
  const int8_t* type;   // (T,) -1 emission, 0 internal down, 1 internal up
  const int32_t* dest;  // (T,) destination level (internal)
  const float* line_dense;  // (M, We)
  const float* nu_dense;    // (M, We)
  int M, We, W;
  const int32_t* g_base;  // (n_groups,) first level of a work group
  const int32_t* g_size;  // levels in it
  const int32_t* g_t0;    // its transitions [g_t0, g_t1)
  const int32_t* g_t1;
  int n_groups;
  int n_max;              // largest group with a chain (0: downbranch)
  double* work;           // slots x slot_stride f64
  int64_t slot_stride;
  float* emit_cdf;        // (S M, 3 We)
  float* chain_cdf;       // (S M, W + 1), or null (downbranch)
  // the large-system instantiation: blocks a system, rows of each block
  // held in its shared memory, one barrier counter a system in flight
  int per, hs;
  unsigned* bar;
};

// x / y, correctly rounded as the division operator gives it, for y normal
// and non-zero, without the division's slow path for a zero numerator (the
// compiled division's fast path wants |x| above ~1e-36, and one lane on
// the slow path holds its whole warp): a zero x divides y instead and
// takes the quotient's sign.
__device__ __forceinline__ double div0(double x, double y) {
  const bool zero = x == 0.0;
  const double q = (zero ? y : x) / y;
  return zero ? copysign(0.0, x) * copysign(1.0, y) : q;
}

// p of the transitions [t0, t1) for shell s into p[t - t0], by the threads
// first, first + step, ..., GATHER transitions a thread in flight (their
// line ids, then their rates).
__device__ void gather_p(const ChainArgs& a, int s, int t0, int t1,
                         double* p, int first, int step) {
  for (int tb = t0 + first; tb < t1; tb += GATHER * step) {
    int64_t k[GATHER];
    double c[GATHER], v[GATHER];
    bool up[GATHER];
#pragma unroll
    for (int u = 0; u < GATHER; ++u) {
      const int t = min(tb + u * step, t1 - 1);
      k[u] = (int64_t)__ldg(a.line + t) * a.S + s;
      c[u] = __ldg(a.coef + t);
      up[u] = __ldg(a.type + t) == 1;
    }
#pragma unroll
    for (int u = 0; u < GATHER; ++u) {
      v[u] = c[u] * __ldg(a.beta + k[u]);
      if (up[u]) v[u] = v[u] * (__ldg(a.stim + k[u]) * __ldg(a.jb + k[u]));
    }
#pragma unroll
    for (int u = 0; u < GATHER; ++u) {
      if (tb + u * step < t1) p[tb + u * step - t0] = v[u];
    }
  }
}

// Level l's block sum in transition order, from p[t - tp], by one thread:
// SUM terms loaded at a time, then added in order.
__device__ double block_sum(const ChainArgs& a, int l, const double* p,
                            int tp) {
  const int r0 = a.refs[l], r1 = a.refs[l + 1];
  double bsum = 0.0;
  for (int t = r0; t < r1; t += SUM) {
    double v[SUM];
#pragma unroll
    for (int u = 0; u < SUM; ++u) v[u] = t + u < r1 ? p[t + u - tp] : 0.0;
#pragma unroll
    for (int u = 0; u < SUM; ++u) {
      if (t + u < r1) bsum += v[u];
    }
  }
  return bsum;
}

// Level l of shell s by one warp, from p[t - tp] of its transitions and
// its block sum, all sums in transition order: each chunk of 32
// transitions normalised a lane each, its internal terms added into
// row[dest - base] (row null: downbranch; lanes of one destination by the
// lowest, in lane order: the duplicates' order), its emission terms
// compacted into st[0, 32) and run on from the previous chunk's sum, lane
// j adding the first j + 1 (so every partial sum is the sequential one)
// and kept in p over the level's first transitions; then the emission
// row, consecutive lanes on consecutive slots.  st: 64 f64 of shared
// memory the warp's own.  Returns the level's deactivation mass d, to
// every lane.
__device__ double level_warp(const ChainArgs& a, int s, int l, int base,
                             double* p, int tp, double bsum, double* row,
                             double* st) {
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int r0 = a.refs[l], r1 = a.refs[l + 1];
  double* em_st = st;
  double* in_st = st + 32;
  double tot = 0.0;
  int ne = 0;
  for (int c0 = r0; c0 < r1; c0 += 32) {
    const int t = c0 + lane;
    const bool in = t < r1;
    const int type = in ? a.type[t] : 0;
    const double pn = in && bsum > 0.0 ? div0(p[t - tp], bsum) : 0.0;
    const bool em = in && type < 0, it = in && type >= 0;
    const unsigned emask = __ballot_sync(all, em);
    const unsigned imask = __ballot_sync(all, it && row != nullptr);
    const int j = __popc(emask & below);
    __syncwarp();  // the last chunk's staging and p are read
    if (em) em_st[j] = pn;
    if (imask >> lane & 1u) in_st[lane] = pn;
    __syncwarp();
    if (emask != 0u) {
      double x = tot;
      const int n_em = __popc(emask);
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        if (k < n_em && k <= j) x += em_st[k];
      }
      if (em) p[r0 + ne + j - tp] = x;
      tot = __shfl_sync(all, x, 31 - __clz(emask));
      ne += n_em;
    }
    if (imask >> lane & 1u) {
      const int d = a.dest[t] - base;
      const unsigned same = __match_any_sync(imask, d);
      if ((same & below) == 0u) {
        double acc = row[d];
        for (unsigned m = same; m != 0u; m &= m - 1u) {
          acc += in_st[__ffs(m) - 1];
        }
        row[d] = acc;
      }
    }
  }
  __syncwarp();  // the running sums in p are written
  float* out = a.emit_cdf + ((int64_t)s * a.M + l) * (3 * a.We);
  const float* ld = a.line_dense + (int64_t)l * a.We;
  const float* nd = a.nu_dense + (int64_t)l * a.We;
  for (int e = lane; e < a.We; e += 32) {
    out[e] = e < ne && tot > 0.0 ? (float)div0(p[r0 + e - tp], tot) : 1.0f;
    out[a.We + e] = ld[e];
    out[2 * a.We + e] = nd[e];
  }
  return tot;
}

// --------------------------------------------------------------- downbranch

// The downbranch build (no chain): work groups of BLOCK levels, a group a
// block at a time, p of its transitions in the block's slot of the
// workspace (after BLOCK f64 of block sums), one thread a level for its
// block sum, then one warp a level for its emission row.
__global__ void __launch_bounds__(BLOCK)
workspace_kernel(ChainArgs a) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  double* slot = a.work + blockIdx.x * a.slot_stride;
  double* dvec = slot;            // BLOCK
  double* pbuf = dvec + BLOCK;    // the group's transitions
  double* stage = smem + DOWN_TILE;  // WARPS x STAGE
  const int S = a.S;
  const int64_t n_sys = (int64_t)a.n_groups * S;
  Phases ph;
  for (int64_t sys = blockIdx.x; sys < n_sys; sys += gridDim.x) {
    const int g = (int)(sys / S), s = (int)(sys % S);
    const int base = a.g_base[g], n = a.g_size[g];
    const int t0 = a.g_t0[g];
    gather_p(a, s, t0, a.g_t1[g], pbuf, tid, BLOCK);
    __syncthreads();
    ph.stamp(0);
    for (int i = tid; i < n; i += BLOCK) {
      dvec[i] = block_sum(a, base + i, pbuf, t0);
    }
    __syncthreads();
    for (int i = warp; i < n; i += WARPS) {
      level_warp(a, s, base + i, base, pbuf, t0, dvec[i], nullptr,
                 stage + warp * STAGE);
    }
    __syncthreads();  // the slot is rewritten by the next group
    ph.stamp(1);
    ph.system();
  }
  ph.flush();
}

// ------------------------------------------------------------------ cluster

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One f64 tensor-core product of the warp, c (16 x 8) += a (16 x 8) b (8 x
// 8), with g = lane / 4, t = lane % 4 (PTX ISA, the fragments of
// mma.m16n8k8 with .f64; CUTLASS's SM90_16x8x8_F64F64F64F64_TN): c[0],
// c[1] row g, columns 2t, 2t + 1, c[2], c[3] row g + 8; a[0] row g, column
// t, a[1] row g + 8, a[2] row g column t + 4, a[3] row g + 8 column t + 4;
// b[0] row t, column g, b[1] row t + 4.  Hopper's shape: with m8n8k4 the
// build took 7% longer (PERF.md, K8's redesign).
__device__ __forceinline__ void mma16(double* c, const double* a,
                                      const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// The panel rows' kb pivot steps on their KB x KB diagonal block D (rows
// ld apart), by one warp, lane q holding column q: at step kk
// lane kk publishes its column in dc (two buffers of KB f64 in turn, so
// one warp barrier a step), every lane reads it back, multiplies its entry
// of row kk by the pivot's reciprocal (the reciprocal itself in the
// pivot's own column: one division a step, with no zero numerator), keeps
// it in Pm[kk] (the normalised pivot row the block's other rows take), and
// every other row m loses D[m][kk] times it.  Shared memory rather than
// shuffles: a shuffle in a branch taken by one warp compiles to a test of
// the warp's convergence, which orders every step's shuffles one by one.
// A panel narrower than KB (the last) is padded with the identity, whose
// steps change nothing, so every step runs without a branch.  The final D
// goes to Df; a pivot that is 0 or not finite sets *singular.
template <int KB>
__device__ void panel_pivots(const double* D, int ld, int kb, double* Pm,
                             double* Df, double* dc, int* singular) {
  const int q = threadIdx.x & 31;
  double col[KB];
#pragma unroll
  for (int m = 0; m < KB; ++m) {
    col[m] = (q < kb && m < kb) ? D[m * ld + q] : (q == m ? 1.0 : 0.0);
  }
  bool bad = false;
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) {
    double* d = dc + (kk & 1) * KB;
    if (q == kk) {
#pragma unroll
      for (int m = 0; m < KB; m += 2) {
        *reinterpret_cast<double2*>(d + m) = make_double2(col[m], col[m + 1]);
      }
    }
    __syncwarp();
    double f[KB];
#pragma unroll
    for (int m = 0; m < KB; m += 2) {
      const double2 v = *reinterpret_cast<const double2*>(d + m);
      f[m] = v.x;
      f[m + 1] = v.y;
    }
    const double piv = f[kk];
    bad = bad || !(piv != 0.0 && isfinite(piv));
    const double inv = 1.0 / piv;
    const double pk = q == kk ? inv : col[kk] * inv;
#pragma unroll
    for (int m = 0; m < KB; ++m) {
      if (m != kk) col[m] = fma(-f[m], pk, col[m]);
    }
    if (q == kk) {  // the pivot's column: 0 - D[m][kk] / piv
#pragma unroll
      for (int m = 0; m < KB; ++m) {
        if (m != kk) col[m] = -f[m] * inv;
      }
    }
    col[kk] = pk;
    if (q < KB) Pm[kk * KB + q] = pk;
  }
  if (q < KB) {
#pragma unroll
    for (int m = 0; m < KB; ++m) Df[m * KB + q] = col[m];
  }
  if (q == 0 && bad) *singular = 1;
}

// A row's KB panel columns c (in registers) take the panel's steps from
// the kept pivot rows Pm; past kb the kept rows are the identity's and c
// is 0, so every step runs without a branch.
template <int KB>
__device__ __forceinline__ void row_steps(double* c, const double* Pm) {
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) {
    const double f = c[kk];
    const double* pk = Pm + kk * KB;
#pragma unroll
    for (int q = 0; q < KB; ++q) {
      c[q] = fma(-f, pk[q], q == kk ? 0.0 : c[q]);
    }
  }
}

// The trailing update of this block's rows [0, own) (global rows r0 + i):
// A[i][j] = (r0 + i in the panel ? 0 : A[i][j]) + sum_p A[i][k0 + p] R[p][j]
// for the 8-column tiles outside the panel's, by the first nw warps, each
// a strip of 16 rows by NJ tiles at a time, its A fragments in registers.
// Rows past own (to a multiple of 16) are zero rows of the block's shared
// memory and
// stay zero; R's rows past kb are zero, so every k step runs, and a tile
// of the panel's columns is computed but not stored: no branch between the
// loads and the products.
template <int KB>
__device__ void trailing_update(double* Am, int lda, const double* Rb,
                                int ldr, int r0, int own, int n8, int k0,
                                int kb, int nw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row_tiles = (own + 15) / 16, col_tiles = n8 / 8;
  const int pc0 = k0 / 8, pc1 = (k0 + round_up(kb, 8)) / 8;
  const int groups = (col_tiles + NJ - 1) / NJ;
  for (int it = warp; it < row_tiles * groups; it += nw) {
    const int i0 = (it / groups) * 16;
    const int ct0 = (it % groups) * NJ;
    // this lane's rows i0 + g + 8 h, h = 0, 1
    bool zero[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = r0 + i0 + g + 8 * h;
      zero[h] = gr >= k0 && gr < k0 + kb;
    }
    double af[KB / 8][4];
#pragma unroll
    for (int ks = 0; ks < KB / 8; ++ks) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int col = 8 * ks + t + 4 * (v / 2);
        af[ks][v] = col < kb
            ? Am[(i0 + g + 8 * (v % 2)) * lda + k0 + col] : 0.0;
      }
    }
    double c[NJ][4];
    bool on[NJ];
#pragma unroll
    for (int cj = 0; cj < NJ; ++cj) {
      const int ct = min(ct0 + cj, col_tiles - 1);
      on[cj] = ct0 + cj < col_tiles && (ct < pc0 || ct >= pc1);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const double* cp = Am + (i0 + g + 8 * (v / 2)) * lda + ct * 8
                           + 2 * t + v % 2;
        c[cj][v] = on[cj] && !zero[v / 2] ? *cp : 0.0;
      }
    }
#pragma unroll
    for (int ks = 0; ks < KB / 8; ++ks) {
#pragma unroll
      for (int cj = 0; cj < NJ; ++cj) {
        const int ct = min(ct0 + cj, col_tiles - 1);
        const double b[2] = {Rb[(8 * ks + t) * ldr + ct * 8 + g],
                             Rb[(8 * ks + t + 4) * ldr + ct * 8 + g]};
        mma16(c[cj], af[ks], b);
      }
    }
#pragma unroll
    for (int cj = 0; cj < NJ; ++cj) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        if (on[cj]) {
          Am[(i0 + g + 8 * (v / 2)) * lda + (ct0 + cj) * 8 + 2 * t + v % 2] =
              c[cj][v];
        }
      }
    }
  }
}

// This block's share of system sys in a cluster of cs: the system's
// component g (levels [base, base + n)) and shell s, the block's rows
// [r0, r0 + own) of the h a block holds, and their transitions [t0, t1).
struct Share {
  int g, s, base, n, h, r0, own, t0, t1;
};

__device__ Share share_of(const ChainArgs& a, int64_t sys, int cs,
                          int rank) {
  Share x;
  x.g = (int)(sys / a.S);
  x.s = (int)(sys % a.S);
  x.base = a.g_base[x.g];
  x.n = a.g_size[x.g];
  x.h = rows_of(x.n, cs);
  x.r0 = min(x.n, rank * x.h);
  x.own = min(x.n, x.r0 + x.h) - x.r0;
  x.t0 = a.refs[x.base + x.r0];
  x.t1 = a.refs[x.base + x.r0 + x.own];
  return x;
}

// One (component, shell) system a cluster; see the head of the file.  The
// work slot of each block holds two buffers of p of its own levels'
// transitions: the system's, and the next one's, which GATHER_WARPS warps
// gather a slice a panel while the others take the trailing update.
template <int KB>
__global__ void __launch_bounds__(CBLOCK, 1)
chain_cluster_kernel(ChainArgs a) {
  extern __shared__ __align__(16) double shm[];
  __shared__ int singular;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_max = a.n_max;
  double* Am = shm;
  double* Rb = Am + (int64_t)rows_of(n_max, cs) * lda_of(n_max);
  double* Pm = Rb + KB * ldr_of(n_max);
  double* Df = Pm + KB * KB;
  double* dv = Df + KB * KB;
  double* stage = dv + round_up(n_max, 2);
  double* slot = a.work + blockIdx.x * a.slot_stride;
  const int64_t half = a.slot_stride / 2;
  const int64_t n_sys = (int64_t)a.n_groups * a.S;
  const int clusters = gridDim.x / cs;
  Phases ph;
  int64_t sys = blockIdx.x / cs;
  if (sys < n_sys) {
    const Share x = share_of(a, sys, cs, rank);
    gather_p(a, x.s, x.t0, x.t1, slot, tid, CBLOCK);
  }
  for (int buf = 0; sys < n_sys; sys += clusters, buf ^= 1) {
    const Share x = share_of(a, sys, cs, rank);
    const int s = x.s, base = x.base, n = x.n, h = x.h, r0 = x.r0;
    const int own = x.own, t0 = x.t0;
    const int lda = lda_of(n), ldr = ldr_of(n), n8 = round_up(n, 8);
    double* pbuf = slot + buf * half;
    // the next system's share, gathered a slice a panel
    const int64_t next = sys + clusters;
    const Share y = share_of(a, next < n_sys ? next : sys, cs, rank);
    const int panels = (n + KB - 1) / KB;
    const int slice = next < n_sys ? (y.t1 - y.t0 + panels - 1) / panels : 0;
    double* pnext = slot + (buf ^ 1) * half;
    if (tid == 0) singular = 0;
    for (int idx = tid; idx < h * n8; idx += CBLOCK) {
      Am[(idx / n8) * lda + idx % n8] = 0.0;
    }
    __syncthreads();  // p is gathered
    ph.stamp(0);
    for (int i = tid; i < own; i += CBLOCK) {
      dv[r0 + i] = block_sum(a, base + r0 + i, pbuf, t0);
    }
    __syncthreads();
    ph.stamp(12);
    for (int i = warp; i < own; i += CWARPS) {
      const double d = level_warp(a, s, base + r0 + i, base, pbuf, t0,
                                  dv[r0 + i], Am + i * lda,
                                  stage + warp * STAGE);
      if (lane == 0) dv[r0 + i] = d;
    }
    __syncthreads();
    ph.stamp(13);
    for (int idx = tid; idx < own * n; idx += CBLOCK) {
      const int i = idx / n, j = idx % n;
      Am[i * lda + j] = (j == r0 + i ? 1.0 : 0.0) - Am[i * lda + j];
    }
    ph.stamp(1);
    for (int k0 = 0; k0 < n; k0 += KB) {
      const int kb = min(KB, n - k0);
      cluster_arrive();  // this block's rows are up to date
      cluster_wait();
      ph.stamp(7);
      // the panel rows, from the blocks that hold them (rows kb .. KB 0),
      // 16 bytes a load, COPY loads a thread in flight
      const int n2 = n8 / 2;
      for (int i0 = tid; i0 < KB * n2; i0 += COPY * CBLOCK) {
        double2 v[COPY];
#pragma unroll
        for (int u = 0; u < COPY; ++u) {
          const int idx = i0 + u * CBLOCK, p = idx / n2;
          v[u] = make_double2(0.0, 0.0);
          if (idx < KB * n2 && p < kb) {
            const int ow = (k0 + p) / h;
            const double* src = cluster.map_shared_rank(Am, ow);
            v[u] = *reinterpret_cast<const double2*>(
                src + (k0 + p - ow * h) * lda + 2 * (idx % n2));
          }
        }
#pragma unroll
        for (int u = 0; u < COPY; ++u) {
          const int idx = i0 + u * CBLOCK;
          if (idx < KB * n2) {
            *reinterpret_cast<double2*>(Rb + (idx / n2) * ldr
                                        + 2 * (idx % n2)) = v[u];
          }
        }
      }
      if (k0 == 0) {  // every level's d, for the chain rows
        for (int j = tid; j < n; j += CBLOCK) {
          const int ow = j / h;
          if (ow != rank) dv[j] = cluster.map_shared_rank(dv, ow)[j];
        }
      }
      __syncthreads();
      ph.stamp(8);
      cluster_arrive();  // this block has read the others' rows
      // the panel's pivot steps, the other warps waiting: a pivot step is a
      // chain of latencies, which other warps' work at the same time
      // lengthens more than it hides
      if (warp == 0) {
        panel_pivots<KB>(Rb + k0, ldr, kb, Pm, Df, stage, &singular);
      }
      ph.stamp(11);
      __syncthreads();
      cluster_wait();
      ph.stamp(9);
      // this block's rows' panel columns: the panel rows take D's final
      // rows, the others the kb steps from the kept pivot rows
      for (int i = tid; i < own; i += CBLOCK) {
        double* row = Am + i * lda + k0;
        const int m = r0 + i - k0;
        if (m >= 0 && m < kb) {
#pragma unroll
          for (int q = 0; q < KB; ++q) {
            if (q < kb) row[q] = Df[m * KB + q];
          }
          continue;
        }
        double c[KB];
#pragma unroll
        for (int q = 0; q < KB; ++q) c[q] = q < kb ? row[q] : 0.0;
        row_steps<KB>(c, Pm);
#pragma unroll
        for (int q = 0; q < KB; ++q) {
          if (q < kb) row[q] = c[q];
        }
      }
      __syncthreads();
      ph.stamp(10);
      // the update on all warps but the last GATHER_WARPS, which gather a
      // slice of the next system's p meanwhile
      if (warp < CWARPS - GATHER_WARPS) {
        trailing_update<KB>(Am, lda, Rb, ldr, r0, own, n8, k0, kb,
                            CWARPS - GATHER_WARPS);
      } else if (slice > 0) {
        const int lo = y.t0 + (k0 / KB) * slice;
        const int hi = min(y.t1, lo + slice);
        const int first = CBLOCK - 32 * GATHER_WARPS;
        if (lo < hi) {
          gather_p(a, y.s, lo, hi, pnext + (lo - y.t0), tid - first,
                   32 * GATHER_WARPS);
        }
      }
      __syncthreads();
      ph.stamp(3);
    }
    // the chain rows, one warp a row, 32 columns a chunk and SCAN chunks at
    // a time: each chunk scanned on its own (a Kogge-Stone sum, then a
    // running maximum), then offset by the running sum before it; fl(c +
    // m) is monotone in m, so the maximum taken before the offset is the
    // one after it.  The running sums replace the row of A^-1.
    const bool sing = singular != 0;
    for (int i = warp; i < own; i += CWARPS) {
      double* ai = Am + i * lda;
      bool finite = !sing;
      double carry = 0.0;
      for (int j0 = 0; j0 < n; j0 += 32 * SCAN) {
        double v[SCAN];
#pragma unroll
        for (int c = 0; c < SCAN; ++c) {
          const int j = j0 + 32 * c + lane;
          v[c] = 0.0;
          if (j < n) {
            const double b = ai[j] * dv[j];
            finite = finite && isfinite(b);
            v[c] = fmax(b, 0.0);
          }
        }
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
          for (int c = 0; c < SCAN; ++c) {
            const double u = __shfl_up_sync(0xffffffffu, v[c], o);
            if (lane >= o) v[c] = v[c] + u;
          }
        }
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
          for (int c = 0; c < SCAN; ++c) {
            const double u = __shfl_up_sync(0xffffffffu, v[c], o);
            if (lane >= o) v[c] = fmax(v[c], u);
          }
        }
#pragma unroll
        for (int c = 0; c < SCAN; ++c) {
          const int jc = j0 + 32 * c;
          if (jc < n) {
            v[c] = carry + v[c];
            if (jc + lane < n) ai[jc + lane] = v[c];
            carry = __shfl_sync(0xffffffffu, v[c], min(31, n - 1 - jc));
          }
        }
      }
      const bool ok = __all_sync(0xffffffffu, finite) && carry > 0.0;
      const int li = r0 + i;
      float* out = a.chain_cdf + ((int64_t)s * a.M + base + li) * (a.W + 1);
      __syncwarp();
#pragma unroll 4
      for (int j = lane; j < a.W; j += 32) {
        out[j] = ok ? (j < n ? (float)div0(ai[j], carry) : 1.0f)
                    : (j >= li ? 1.0f : 0.0f);
      }
      if (lane == 0) out[a.W] = (float)base;
    }
    __syncthreads();  // A is rewritten by the next system
    ph.stamp(4);
    ph.system();
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
  ph.flush();
}

// -------------------------------------------------------------------- large

// The large-system instantiation's shared memory, in f64 (k8_large_smem in
// the wrapper repeats it): the panel rows R of a chunk of at most CHUNK
// columns, ldr_of apart; the kept pivot rows and the panel rows' final
// diagonal block (KB x KB each); each warp's staging; then the block's
// first hs rows of A, lda_of apart.  Its workspace slot, one a system in
// flight (k8_large_slot in the wrapper), in f64 for components of up to
// n_max levels: A's rows (those past each block's first hs), ldg_of(n)
// apart; the panel rows of two panels in turn (KB rows each); d of every
// level; and each block's p of its levels' transitions, (slot_stride -
// (n_max + 2 KB + 1) ldg_of(n_max)) / per a block.
constexpr int CHUNK = 1024;
__host__ __device__ constexpr int ldg_of(int n) { return round_up(n, 8); }
__host__ __device__ constexpr int chunk_of(int n) {
  return ldg_of(n) < CHUNK ? ldg_of(n) : CHUNK;
}
__host__ __device__ constexpr int64_t large_smem(int n, int kb, int hs) {
  return 8 * ((int64_t)kb * ldr_of(chunk_of(n)) + 2 * kb * kb
              + CWARPS * STAGE + (int64_t)hs * lda_of(n));
}
// 16-byte loads a thread has in flight copying the panel rows
constexpr int LCOPY = 8;

// The blocks of one system in flight meet here: each arrives on the
// system's counter in device memory (release) and waits for it to reach
// target, per arrivals a barrier (acquire).  The blocks of the grid are
// resident together (a cooperative launch), so no wait is for a block
// that has not started; a wait past WAIT_CYCLES (seconds) traps, so a
// fault shows as a failed launch rather than a card that never returns.
// The block barriers on either side order the block's other threads with
// thread 0, which the release and the acquire carry between blocks.
constexpr long long WAIT_CYCLES = 1LL << 36;
__device__ __forceinline__ void group_sync(unsigned* bar, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.add.u32 [%0], 1;\n"
                 :: "l"(bar) : "memory");
    const long long t0 = clock64();
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];\n"
                   : "=r"(v) : "l"(bar) : "memory");
      if (clock64() - t0 > WAIT_CYCLES) __trap();
    } while (v < target);
  }
  __syncthreads();
}

// A block's rows of a system: row i of its share (global row r0 + i) in
// its shared memory for i < hs (lds apart), else in the slot (row 0 of the
// system at gm, ldg apart).
struct Rows {
  double* sm;
  double* gm;
  int lds, ldg, hs, r0;
  __device__ double* row(int i) const {
    return i < hs ? sm + i * lds : gm + (int64_t)(r0 + i) * ldg;
  }
};

// The panel rows' columns [c0, c0 + cw) (cw a multiple of 8), rows kb ..
// KB zero, from src (KB rows ldg apart) into Rb (ldr apart), 16 bytes a
// load, COPY loads a thread in flight, by the threads first, first +
// step, ...
template <int KB>
__device__ void copy_panel(const double* src, int ldg, int kb, int c0,
                           int cw, double* Rb, int ldr, int first, int step) {
  const int n2 = cw / 2;
  for (int i0 = first; i0 < KB * n2; i0 += LCOPY * step) {
    double2 v[LCOPY];
#pragma unroll
    for (int u = 0; u < LCOPY; ++u) {
      const int idx = i0 + u * step, p = idx / n2;
      v[u] = make_double2(0.0, 0.0);
      if (idx < KB * n2 && p < kb) {
        v[u] = *reinterpret_cast<const double2*>(
            src + (int64_t)p * ldg + c0 + 2 * (idx % n2));
      }
    }
#pragma unroll
    for (int u = 0; u < LCOPY; ++u) {
      const int idx = i0 + u * step;
      if (idx < KB * n2) {
        *reinterpret_cast<double2*>(Rb + (idx / n2) * ldr
                                    + 2 * (idx % n2)) = v[u];
      }
    }
  }
}

// The trailing update of a block's rows [0, own) on the 8-column tiles
// [c0, c1), whose panel rows R are in Rb (ldr apart, from column 8 c0):
// the cluster instantiation's trailing_update, each warp a strip of 16 rows
// by NJ tiles on mma.sync m16n8k8, the same products in the same order,
// with the rows where w puts them and the rows past own neither read nor
// written; a row of the next panel (global rows [nk0, nk0 + KB)) is also
// written to nxt, the next panel's rows (ldg apart), unless nxt is null.
template <int KB>
__device__ void large_update(const Rows& w, int own, const double* Rb,
                             int ldr, int c0, int c1, int k0, int kb,
                             double* nxt, int nk0, int nw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row_tiles = (own + 15) / 16, col_tiles = c1 - c0;
  const int pc0 = k0 / 8, pc1 = (k0 + round_up(kb, 8)) / 8;
  const int groups = (col_tiles + NJ - 1) / NJ;
  for (int it = warp; it < row_tiles * groups; it += nw) {
    const int i0 = (it / groups) * 16;
    const int ct0 = c0 + (it % groups) * NJ;
    // this lane's rows i0 + g + 8 h, h = 0, 1
    double* rp[2];
    double* sp[2];
    bool zero[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + g + 8 * h, gr = w.r0 + i;
      rp[h] = i < own ? w.row(i) : nullptr;
      zero[h] = gr >= k0 && gr < k0 + kb;
      sp[h] = rp[h] != nullptr && nxt != nullptr && gr >= nk0
              && gr < nk0 + KB ? nxt + (int64_t)(gr - nk0) * w.ldg : nullptr;
    }
    double af[KB / 8][4];
#pragma unroll
    for (int ks = 0; ks < KB / 8; ++ks) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int col = 8 * ks + t + 4 * (v / 2);
        const double* r = rp[v % 2];
        af[ks][v] = r != nullptr && col < kb ? r[k0 + col] : 0.0;
      }
    }
    double c[NJ][4];
    bool on[NJ];
#pragma unroll
    for (int cj = 0; cj < NJ; ++cj) {
      const int ct = min(ct0 + cj, c1 - 1);
      on[cj] = ct0 + cj < c1 && (ct < pc0 || ct >= pc1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        double2 x = make_double2(0.0, 0.0);
        if (on[cj] && rp[h] != nullptr && !zero[h]) {
          x = *reinterpret_cast<const double2*>(rp[h] + ct * 8 + 2 * t);
        }
        c[cj][2 * h] = x.x;
        c[cj][2 * h + 1] = x.y;
      }
    }
#pragma unroll
    for (int ks = 0; ks < KB / 8; ++ks) {
#pragma unroll
      for (int cj = 0; cj < NJ; ++cj) {
        const int cc = (min(ct0 + cj, c1 - 1) - c0) * 8;
        const double b[2] = {Rb[(8 * ks + t) * ldr + cc + g],
                             Rb[(8 * ks + t + 4) * ldr + cc + g]};
        mma16(c[cj], af[ks], b);
      }
    }
#pragma unroll
    for (int cj = 0; cj < NJ; ++cj) {
      if (!on[cj]) continue;
      const int col = (ct0 + cj) * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const double2 x = make_double2(c[cj][2 * h], c[cj][2 * h + 1]);
        if (rp[h] != nullptr) *reinterpret_cast<double2*>(rp[h] + col) = x;
        if (sp[h] != nullptr) *reinterpret_cast<double2*>(sp[h] + col) = x;
      }
    }
  }
}

// One (component, shell) system spread over `per` blocks of a persistent
// cooperative grid, gridDim.x / per systems in flight, each in its slot of
// the workspace; see the head of the file.
template <int KB>
__global__ void __launch_bounds__(CBLOCK, 1)
chain_large_kernel(ChainArgs a) {
  extern __shared__ __align__(16) double shm[];
  __shared__ int singular;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = a.per, grp = blockIdx.x / per, rank = blockIdx.x % per;
  const int in_flight = gridDim.x / per;
  const int n_max = a.n_max, ldm = ldg_of(n_max);
  const int ldr = ldr_of(chunk_of(n_max));
  double* Rb = shm;
  double* Pm = Rb + KB * ldr;
  double* Df = Pm + KB * KB;
  double* stage = Df + KB * KB;
  double* srows = stage + CWARPS * STAGE;
  double* mat = a.work + grp * a.slot_stride;
  double* stg = mat + (int64_t)n_max * ldm;
  double* dvec = stg + 2 * KB * ldm;
  const int64_t tstride =
      (a.slot_stride - (int64_t)(n_max + 2 * KB + 1) * ldm) / per;
  double* pbuf = dvec + ldm + rank * tstride;
  unsigned* bar = a.bar + grp;
  unsigned epoch = 0;
  const int S = a.S;
  const int64_t n_sys = (int64_t)a.n_groups * S;
  Phases ph;
  for (int64_t sys = grp; sys < n_sys; sys += in_flight) {
    const int g = (int)(sys / S), s = (int)(sys % S);
    const int base = a.g_base[g], n = a.g_size[g];
    const int h = (n + per - 1) / per;
    const int r0 = min(n, rank * h), own = min(n, r0 + h) - r0;
    const int t0 = a.refs[base + r0];
    const int ld = ldg_of(n);
    const Rows w{srows, mat, lda_of(n), ld, a.hs, r0};
    if (tid == 0) singular = 0;
    gather_p(a, s, t0, a.refs[base + r0 + own], pbuf, tid, CBLOCK);
    __syncthreads();
    ph.stamp(0);
    for (int i = tid; i < own; i += CBLOCK) {
      dvec[r0 + i] = block_sum(a, base + r0 + i, pbuf, t0);
    }
    __syncthreads();
    ph.stamp(12);
    // one warp a level: its emission row and its row of A = I - Q, the
    // first panel's rows also into the first panel buffer
    for (int i = warp; i < own; i += CWARPS) {
      double* row = w.row(i);
      const int li = r0 + i;
      for (int j = lane; j < ld; j += 32) row[j] = 0.0;
      __syncwarp();
      const double d = level_warp(a, s, base + li, base, pbuf, t0, dvec[li],
                                  row, stage + warp * STAGE);
      __syncwarp();
      for (int j = lane; j < n; j += 32) {
        const double v = (j == li ? 1.0 : 0.0) - row[j];
        row[j] = v;
        if (li < KB) stg[li * ld + j] = v;
      }
      if (lane == 0) dvec[li] = d;
    }
    ph.stamp(13);
    group_sync(bar, ++epoch * per);
    ph.stamp(7);
    const int panels = (n + KB - 1) / KB;
    const int cw = chunk_of(n);
    for (int k = 0; k < panels; ++k) {
      const int k0 = k * KB, kb = min(KB, n - k0);
      const double* cur = stg + (k & 1) * KB * ld;
      double* nxt = k + 1 < panels ? stg + ((k + 1) & 1) * KB * ld : nullptr;
      // the pivot steps on warp 0 (from the panel rows in the slot) while
      // the warps of the other three schedulers (warp % 4 != 0) copy the
      // panel rows' first chunk: with warps 4, 8 and 12 copying too, warp
      // 0's chain of latencies waited on them (2% of the build at the
      // large-ion shape, PERF.md)
      if (warp == 0) {
        panel_pivots<KB>(cur + k0, ld, kb, Pm, Df, stage, &singular);
        ph.stamp(8);
      } else if (warp % 4 != 0) {
        copy_panel<KB>(cur, ld, kb, 0, min(cw, ld), Rb, ldr,
                       32 * (warp - 1 - warp / 4) + lane, 32 * 12);
      }
      __syncthreads();
      ph.stamp(11);
      // this block's rows' panel columns: the panel rows take D's final
      // rows, the others the kb steps from the kept pivot rows
      for (int i = tid; i < own; i += CBLOCK) {
        double* row = w.row(i) + k0;
        const int gr = r0 + i, m = gr - k0;
        double c[KB];
        if (m >= 0 && m < kb) {
#pragma unroll
          for (int q = 0; q < KB; ++q) c[q] = q < kb ? Df[m * KB + q] : 0.0;
        } else {
#pragma unroll
          for (int q = 0; q < KB; ++q) c[q] = q < kb ? row[q] : 0.0;
          row_steps<KB>(c, Pm);
        }
        double* sr = nxt != nullptr && gr >= k0 + KB && gr < k0 + 2 * KB
                     ? nxt + (int64_t)(gr - k0 - KB) * ld + k0 : nullptr;
#pragma unroll
        for (int q = 0; q < KB; ++q) {
          if (q < kb) {
            row[q] = c[q];
            if (sr != nullptr) sr[q] = c[q];
          }
        }
      }
      __syncthreads();
      ph.stamp(10);
      for (int j0 = 0; j0 < ld; j0 += cw) {
        const int cols = min(cw, ld - j0);
        if (j0 > 0) {
          __syncthreads();  // the last chunk's rows are read
          copy_panel<KB>(cur, ld, kb, j0, cols, Rb, ldr, tid, CBLOCK);
          __syncthreads();
        }
        large_update<KB>(w, own, Rb, ldr, j0 / 8, (j0 + cols) / 8, k0, kb,
                         nxt, k0 + KB, CWARPS);
      }
      ph.stamp(3);
      if (nxt != nullptr) {
        group_sync(bar, ++epoch * per);
        ph.stamp(7);
      }
    }
    // the chain rows, as the cluster instantiation forms them
    __syncthreads();
    const bool sing = singular != 0;
    for (int i = warp; i < own; i += CWARPS) {
      double* ai = w.row(i);
      bool finite = !sing;
      double carry = 0.0;
      for (int j0 = 0; j0 < n; j0 += 32 * SCAN) {
        double v[SCAN];
#pragma unroll
        for (int c = 0; c < SCAN; ++c) {
          const int j = j0 + 32 * c + lane;
          v[c] = 0.0;
          if (j < n) {
            const double b = ai[j] * dvec[j];
            finite = finite && isfinite(b);
            v[c] = fmax(b, 0.0);
          }
        }
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
          for (int c = 0; c < SCAN; ++c) {
            const double u = __shfl_up_sync(0xffffffffu, v[c], o);
            if (lane >= o) v[c] = v[c] + u;
          }
        }
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
          for (int c = 0; c < SCAN; ++c) {
            const double u = __shfl_up_sync(0xffffffffu, v[c], o);
            if (lane >= o) v[c] = fmax(v[c], u);
          }
        }
#pragma unroll
        for (int c = 0; c < SCAN; ++c) {
          const int jc = j0 + 32 * c;
          if (jc < n) {
            v[c] = carry + v[c];
            if (jc + lane < n) ai[jc + lane] = v[c];
            carry = __shfl_sync(0xffffffffu, v[c], min(31, n - 1 - jc));
          }
        }
      }
      const bool ok = __all_sync(0xffffffffu, finite) && carry > 0.0;
      const int li = r0 + i;
      float* out = a.chain_cdf + ((int64_t)s * a.M + base + li) * (a.W + 1);
      __syncwarp();
#pragma unroll 4
      for (int j = lane; j < a.W; j += 32) {
        out[j] = ok ? (j < n ? (float)div0(ai[j], carry) : 1.0f)
                    : (j >= li ? 1.0f : 0.0f);
      }
      if (lane == 0) out[a.W] = (float)base;
    }
    ph.stamp(4);
    // the slot (d, the panel buffers) is rewritten by the next system
    group_sync(bar, ++epoch * per);
    ph.stamp(7);
    ph.system();
  }
  ph.flush();
}

// ------------------------------------------------------------------ launch

int launch_workspace(const ChainArgs& a, int slots, cudaStream_t st) {
  workspace_kernel<<<slots, BLOCK,
                     (DOWN_TILE + WARPS * STAGE) * sizeof(double), st>>>(a);
  return (int)cudaGetLastError();
}

template <int KB>
int launch_large(const ChainArgs& a, int blocks, cudaStream_t st) {
  const int64_t smem = large_smem(a.n_max, KB, a.hs);
  cudaError_t err = cudaFuncSetAttribute(
      chain_large_kernel<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(CBLOCK);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, chain_large_kernel<KB>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int KB>
cudaError_t cluster_config(int n_max, int cs, int blocks, cudaStream_t st,
                           cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  const int64_t smem = cluster_smem(n_max, cs, KB);
  cudaError_t err = cudaFuncSetAttribute(
      chain_cluster_kernel<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(CBLOCK);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int KB>
int launch_cluster(const ChainArgs& a, int cs, int blocks, cudaStream_t st) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<KB>(a.n_max, cs, blocks, st, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, chain_cluster_kernel<KB>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int KB>
int active_clusters(int n_max, int cs, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<KB>(n_max, cs, cs, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(out, chain_cluster_kernel<KB>,
                                             &cfg);
}

}  // namespace

// One build of the work groups [0, n_groups) of the arrays passed (the
// wrapper passes a range of them, components largest first).  variant 0:
// the downbranch build (chain_cdf null, kb 1), `slots` blocks; variant 1:
// the cluster instantiation (kb 16), clusters of `cluster` blocks, `slots`
// blocks in all; variant 2: the large-system instantiation (kb 16),
// `cluster` blocks a system, `slots` blocks in all (slots / cluster
// systems in flight, each with its zeroed barrier counter in counters),
// `smem_rows` rows of each block in its shared memory.  work: slots x
// slot_stride f64 (variant 2: one slot a system in flight).
extern "C" int macro_chain(
    const void* beta, const void* jb, const void* stim, int S,
    const void* refs, const void* coef, const void* line, const void* type,
    const void* dest, const void* line_dense, const void* nu_dense, int M,
    int We, int W, const void* g_base, const void* g_size, const void* g_t0,
    const void* g_t1, int n_groups, int n_max, int variant, int cluster,
    int kb, void* work, int64_t slot_stride, int slots, void* emit_cdf,
    void* chain_cdf, int smem_rows, void* counters, void* stream) {
  if (S <= 0 || n_groups <= 0) return 0;
  if (slots <= 0) return (int)cudaErrorInvalidValue;
  ChainArgs a;
  a.beta = (const double*)beta;
  a.jb = (const double*)jb;
  a.stim = (const double*)stim;
  a.S = S;
  a.refs = (const int32_t*)refs;
  a.coef = (const double*)coef;
  a.line = (const int32_t*)line;
  a.type = (const int8_t*)type;
  a.dest = (const int32_t*)dest;
  a.line_dense = (const float*)line_dense;
  a.nu_dense = (const float*)nu_dense;
  a.M = M;
  a.We = We;
  a.W = W;
  a.g_base = (const int32_t*)g_base;
  a.g_size = (const int32_t*)g_size;
  a.g_t0 = (const int32_t*)g_t0;
  a.g_t1 = (const int32_t*)g_t1;
  a.n_groups = n_groups;
  a.n_max = chain_cdf == nullptr ? 0 : n_max;
  a.work = (double*)work;
  a.slot_stride = slot_stride;
  a.emit_cdf = (float*)emit_cdf;
  a.chain_cdf = (float*)chain_cdf;
  a.per = cluster;
  a.hs = smem_rows;
  a.bar = (unsigned*)counters;
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 1) {
    if (chain_cdf == nullptr || cluster < 1 || cluster > 8
        || slots % cluster != 0) {
      return (int)cudaErrorInvalidValue;
    }
    return kb == 16 ? launch_cluster<16>(a, cluster, slots, st)
                    : (int)cudaErrorInvalidValue;
  }
  if (variant == 2) {
    if (chain_cdf == nullptr || counters == nullptr || cluster < 1
        || slots % cluster != 0 || smem_rows < 0 || kb != 16) {
      return (int)cudaErrorInvalidValue;
    }
    return launch_large<16>(a, slots, st);
  }
  if (variant != 0 || chain_cdf != nullptr || kb != 1) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_workspace(a, slots, st);
}

// How many clusters of `cluster` blocks of the cluster instantiation with
// panel kb for components of up to n_max levels the card holds at once,
// into *out (0: none fits).
extern "C" int macro_chain_clusters(int n_max, int cluster, int kb,
                                    int* out) {
  *out = 0;
  return kb == 16 ? active_clusters<16>(n_max, cluster, out)
                  : (int)cudaErrorInvalidValue;
}

#ifdef K8_PHASES
// The phase cycles summed over the blocks since the last call, as 16
// unsigned 64-bit counts into host memory at out (p gather, levels, panel
// steps, trailing update, chain rows, the blocks' whole time, systems;
// the cluster instantiation's panel steps split into the first barrier,
// the panel rows' copy, the second barrier, the rows' steps and the pivot
// steps, and its levels into the block sums and the warps' pass; -, -);
// then zeroed.
extern "C" int macro_chain_phases(void* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) {
    err = cudaMemcpyFromSymbol(out, k8_phase, sizeof(k8_phase));
  }
  const unsigned long long zero[16] = {};
  if (err == cudaSuccess) {
    err = cudaMemcpyToSymbol(k8_phase, zero, sizeof(zero));
  }
  return (int)err;
}
#endif
