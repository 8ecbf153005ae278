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
// tables, the transition table) and the two f32 row tables are ~0.2 GB.
// Design:
//   - one launch a build: a persistent grid whose blocks take the
//     (component, shell) systems in turn (components largest first, the
//     shells of one component next to each other so their lines' sectors
//     are shared in L2); in downbranch mode the work groups are runs of
//     BLOCK levels and only the emission rows are built;
//   - a block first writes p of every transition of its component into
//     its workspace slot (all threads, independent gathers), then one
//     thread a level sums its block, normalises, writes the emission row,
//     keeps the deactivation mass d and builds its row of A = I - Q, all
//     in transition order: no atomics, so the tables are bitwise the same
//     from run to run, and no (T, S) intermediate in device memory;
//   - A is inverted in place by Gauss-Jordan without pivoting: Q >= 0 and
//     each row of Q sums to 1 - d <= 1 inside its closed component, so A
//     is an M-matrix, diagonally dominant by rows, where elimination
//     without pivoting is stable (growth <= 2; Higham, Accuracy and
//     Stability of Numerical Algorithms, Thm 9.9).  A pivot that is 0 or
//     not finite marks the system singular and all its rows take the
//     fallback (the JAX package's f32 solve gives NaN there, which its
//     rtot > 0 test sends to the same fallback);
//   - the elimination is blocked: KB pivots at a time on a panel of KB
//     columns held in shared memory, then one rank-KB update of the rest
//     of the matrix in tiles of TC columns (each thread a column, the
//     panel rows of its column in registers), so the matrix, which lives
//     in the block's slot of a device workspace (n = 200: 320 KB, more
//     than a block's 227 KB of shared memory), is read and written once a
//     panel rather than once a pivot; KB is 32, 8 or 1, the widest whose
//     panel fits (chosen by the wrapper, k8_panel);
//   - B = A^-1 diag(d) is formed in the last pass, one thread a row, with
//     the clamp, the running sum, the division and the fallback fused.
// Built with --fmad=false (see tardis_torch/cuda.py).
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BLOCK = 256;        // threads a block (K8_BLOCK in the wrapper)
constexpr int TC = 64;            // columns of a trailing-update tile (K8_TILE)
constexpr int ROWS = BLOCK / TC;  // row groups of a tile

// the panel's row stride in f64: odd, so the rows of a warp's threads fall
// in distinct banks (k8_panel in the wrapper sizes it the same way)
__host__ __device__ constexpr int ldc(int kb) { return kb == 1 ? 1 : kb + 1; }

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
};

// In-place Gauss-Jordan inversion of the n x n row-major matrix a without
// pivoting, KB pivots a panel.  C: n x KB panel in shared memory, its rows
// ldc(KB) apart (one thread a row reads it without bank conflicts); R: KB x
// TC tile of the panel's rows.  Sets *singular where a pivot is 0 or not
// finite.
template <int KB>
__device__ void invert(double* a, int n, double* C, double* R,
                       int* singular) {
  constexpr int LDC = ldc(KB);
  const int tid = threadIdx.x;
  const int jc = tid % TC, rg = tid / TC;
  for (int k0 = 0; k0 < n; k0 += KB) {
    const int kb = min(KB, n - k0);
    for (int idx = tid; idx < n * KB; idx += BLOCK) {
      const int i = idx / KB, q = idx % KB;
      C[i * LDC + q] = q < kb ? a[(int64_t)i * n + k0 + q] : 0.0;
    }
    __syncthreads();
    // the panel's own kb steps, on its columns only
    for (int kk = 0; kk < kb; ++kk) {
      const int k = k0 + kk;
      const double piv = C[k * LDC + kk];
      if (tid == 0 && !(piv != 0.0 && isfinite(piv))) *singular = 1;
      __syncthreads();  // every thread has read piv before row k changes
      if (tid < kb) {
        C[k * LDC + tid] = (tid == kk ? 1.0 : C[k * LDC + tid]) / piv;
      }
      __syncthreads();
      const double* ck = C + k * LDC;
      for (int i = tid; i < n; i += BLOCK) {
        if (i == k) continue;
        double* ci = C + i * LDC;
        const double f = ci[kk];
#pragma unroll
        for (int q = 0; q < KB; ++q) {
          if (q < kb) ci[q] = (q == kk ? 0.0 : ci[q]) - f * ck[q];
        }
      }
      __syncthreads();
    }
    // the rest: a[i][j] = (i in panel ? 0 : a[i][j]) + sum_p C[i][p] A12[p][j]
    // with A12 the panel rows before this panel; the panel's columns take C
    for (int j0 = 0; j0 < n; j0 += TC) {
      for (int idx = tid; idx < KB * TC; idx += BLOCK) {
        const int p = idx / TC, j = j0 + idx % TC;
        R[idx] = (p < kb && j < n) ? a[(int64_t)(k0 + p) * n + j] : 0.0;
      }
      __syncthreads();
      const int j = j0 + jc;
      if (j < n && j >= k0 && j < k0 + kb) {
        for (int i = rg; i < n; i += ROWS) {
          a[(int64_t)i * n + j] = C[i * LDC + (j - k0)];
        }
      } else if (j < n) {
        double r[KB];
#pragma unroll
        for (int p = 0; p < KB; ++p) r[p] = R[p * TC + jc];
        for (int i = rg; i < n; i += ROWS) {
          double* aij = a + (int64_t)i * n + j;
          double acc = (i >= k0 && i < k0 + kb) ? 0.0 : *aij;
          const double* ci = C + i * LDC;
#pragma unroll
          for (int p = 0; p < KB; ++p) acc = acc + ci[p] * r[p];
          *aij = acc;
        }
      }
      __syncthreads();
    }
  }
}

template <int KB>
__global__ void __launch_bounds__(BLOCK)
macro_chain_kernel(ChainArgs a) {
  extern __shared__ double smem[];
  __shared__ int singular;
  const int tid = threadIdx.x;
  const bool chain = a.chain_cdf != nullptr;
  double* slot = a.work + blockIdx.x * a.slot_stride;
  double* mat = slot;                                    // n_max^2
  double* dvec = mat + (int64_t)a.n_max * a.n_max;       // n_max
  double* pbuf = dvec + a.n_max;                         // the group's transitions
  double* C = smem;                                      // n_max x ldc(KB)
  double* R = smem + (int64_t)a.n_max * ldc(KB);         // KB x TC
  const int S = a.S;
  const int64_t n_sys = (int64_t)a.n_groups * S;
  for (int64_t sys = blockIdx.x; sys < n_sys; sys += gridDim.x) {
    const int g = (int)(sys / S), s = (int)(sys % S);
    const int base = a.g_base[g], n = a.g_size[g];
    const int t0 = a.g_t0[g], t1 = a.g_t1[g];
    if (tid == 0) singular = 0;
    // p of every transition of the group
    for (int t = t0 + tid; t < t1; t += BLOCK) {
      const int64_t k = (int64_t)a.line[t] * S + s;
      double p = a.coef[t] * a.beta[k];
      if (a.type[t] == 1) p = p * (a.stim[k] * a.jb[k]);
      pbuf[t - t0] = p;
    }
    __syncthreads();
    // one thread a level: block sum, emission row, d, row of A
    for (int i = tid; i < n; i += BLOCK) {
      const int l = base + i;
      const int r0 = a.refs[l], r1 = a.refs[l + 1];
      double bsum = 0.0;
      for (int t = r0; t < r1; ++t) bsum += pbuf[t - t0];
      double* row = mat + (int64_t)i * n;
      if (chain) {
        for (int j = 0; j < n; ++j) row[j] = 0.0;
      }
      double tot = 0.0;
      for (int t = r0; t < r1; ++t) {
        const double pn = bsum > 0.0 ? pbuf[t - t0] / bsum : 0.0;
        if (a.type[t] < 0) {
          tot += pn;
        } else if (chain) {
          row[a.dest[t] - base] += pn;
        }
      }
      if (chain) {
        for (int j = 0; j < n; ++j) row[j] = (j == i ? 1.0 : 0.0) - row[j];
        dvec[i] = tot;
      }
      float* out = a.emit_cdf + ((int64_t)s * a.M + l) * (3 * a.We);
      int e = 0;
      double cum = 0.0;
      for (int t = r0; t < r1; ++t) {
        if (a.type[t] >= 0) continue;
        cum += bsum > 0.0 ? pbuf[t - t0] / bsum : 0.0;
        out[e++] = tot > 0.0 ? (float)(cum / tot) : 1.0f;
      }
      for (; e < a.We; ++e) out[e] = 1.0f;  // cum == tot past the last slot
      const float* ld = a.line_dense + (int64_t)l * a.We;
      const float* nd = a.nu_dense + (int64_t)l * a.We;
      for (int q = 0; q < a.We; ++q) {
        out[a.We + q] = ld[q];
        out[2 * a.We + q] = nd[q];
      }
    }
    __syncthreads();
    if (chain) {
      invert<KB>(mat, n, C, R, &singular);
      // the syncthreads ending invert make the inverse and the flag seen
      const bool sing = singular != 0;
      for (int i = tid; i < n; i += BLOCK) {
        const double* ai = mat + (int64_t)i * n;
        bool finite = !sing;
        double tot = 0.0;
        for (int j = 0; j < n; ++j) {
          const double b = ai[j] * dvec[j];
          finite = finite && isfinite(b);
          tot += fmax(b, 0.0);
        }
        const bool ok = finite && tot > 0.0;
        float* out = a.chain_cdf + ((int64_t)s * a.M + base + i) * (a.W + 1);
        double run = 0.0;
        for (int j = 0; j < n; ++j) {
          run += fmax(ai[j] * dvec[j], 0.0);
          out[j] = ok ? (float)(run / tot) : (j >= i ? 1.0f : 0.0f);
        }
        for (int j = n; j < a.W; ++j) out[j] = ok || j >= i ? 1.0f : 0.0f;
        out[a.W] = (float)base;
      }
      __syncthreads();  // the slot is rewritten by the next system
    }
  }
}

template <int KB>
int launch(const ChainArgs& a, int slots, cudaStream_t st) {
  const size_t smem = a.chain_cdf == nullptr
      ? 0 : ((size_t)a.n_max * ldc(KB) + (size_t)KB * TC) * sizeof(double);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        macro_chain_kernel<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  macro_chain_kernel<KB><<<slots, BLOCK, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One build.  kb: the panel width (32, 8 or 1; k8_panel in the wrapper);
// chain_cdf null selects the downbranch build (emission rows only).
extern "C" int macro_chain(
    const void* beta, const void* jb, const void* stim, int S,
    const void* refs, const void* coef, const void* line, const void* type,
    const void* dest, const void* line_dense, const void* nu_dense, int M,
    int We, int W, const void* g_base, const void* g_size, const void* g_t0,
    const void* g_t1, int n_groups, int n_max, int kb, void* work,
    int64_t slot_stride, int slots, void* emit_cdf, void* chain_cdf,
    void* stream) {
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
  cudaStream_t st = (cudaStream_t)stream;
  switch (kb) {
    case 32: return launch<32>(a, slots, st);
    case 8: return launch<8>(a, slots, st);
    case 1: return launch<1>(a, slots, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
