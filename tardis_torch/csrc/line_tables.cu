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
// prefix, ~150 MB at bench scale, with a few dozen flops per element.
// Design: kernel 1 is elementwise, one thread per (line, shell), in the
// (L, S) layout its consumers read (adjacent threads are adjacent shells,
// so stores coalesce).  Kernel 2 scans: one block per shell walks L in
// tiles of blockDim lines, each tile a warp-shuffle inclusive scan plus a
// running carry; the prefix rows are written contiguously.  The scan
// reads tau with stride S, which costs sector efficiency; it is off the
// transport hot loop.  Built with --fmad=false (see tardis_torch/cuda.py).
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void line_elements_kernel(
    const double* __restrict__ level_pop,  // (n_levels, S)
    const int32_t* __restrict__ lower_idx, const int32_t* __restrict__ upper_idx,
    const double* __restrict__ g_lower, const double* __restrict__ g_upper,
    const double* __restrict__ wl_flu,     // wavelength * f_lu, (L,)
    const double* __restrict__ line_nu,    // Hz, (L,)
    const double* __restrict__ nu3_coef,   // 2 h nu^3 / c^2, (L,)
    const double* __restrict__ h_over_kt,  // (S,)
    const double* __restrict__ jb_w,       // (S,)
    double sobolev_coefficient, double time_explosion, int64_t L, int S,
    double* __restrict__ stim, double* __restrict__ tau,
    double* __restrict__ beta, double* __restrict__ jb) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= L * S) return;
  int64_t l = e / S;
  int s = (int)(e - l * S);
  double n_lower = level_pop[(int64_t)lower_idx[l] * S + s];
  double n_upper = level_pop[(int64_t)upper_idx[l] * S + s];
  // lte.stimulated_emission_factor: non-finite ratios count as 1
  double ratio = (g_lower[l] * n_upper) / (g_upper[l] * n_lower);
  if (!isfinite(ratio)) ratio = 1.0;
  double st = fmax(1.0 - ratio, 0.0);
  // lte.tau_sobolev, evaluated in the same order
  double t = sobolev_coefficient * wl_flu[l] * time_explosion * st * n_lower;
  // lte.beta_sobolev
  double b;
  if (t > 1e3) b = 1.0 / t;
  else if (t < 1e-4) b = 1.0 - 0.5 * t;
  else b = -expm1(-t) / t;
  // jb_w * lte.intensity_black_body
  double x = fmin(line_nu[l] * h_over_kt[s], 700.0);
  stim[e] = st;
  tau[e] = t;
  beta[e] = b;
  jb[e] = jb_w[s] * (nu3_coef[l] / expm1(x));
}

__device__ __forceinline__ double warp_inclusive_scan(double v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    double o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += o;
  }
  return v;
}

constexpr int kScanThreads = 1024;

__global__ void __launch_bounds__(kScanThreads) prefix_scan_kernel(
    const double* __restrict__ tau, int64_t L, int S,
    double* __restrict__ prefix) {  // (S, L+1)
  __shared__ double warp_sums[kScanThreads / 32];
  const int s = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  double* row = prefix + (int64_t)s * (L + 1);
  if (threadIdx.x == 0) row[0] = 0.0;
  double carry = 0.0;
  for (int64_t base = 0; base < L; base += kScanThreads) {
    int64_t i = base + threadIdx.x;
    double v = i < L ? tau[i * S + s] : 0.0;
    v = warp_inclusive_scan(v);
    if (lane == 31) warp_sums[warp] = v;
    __syncthreads();
    if (warp == 0) {
      double w = warp_sums[lane];
      warp_sums[lane] = warp_inclusive_scan(w);
    }
    __syncthreads();
    double before = warp > 0 ? warp_sums[warp - 1] : 0.0;
    if (i < L) row[i + 1] = carry + (before + v);
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();
  }
}

}  // namespace

extern "C" int line_tables(
    const void* level_pop, const void* lower_idx, const void* upper_idx,
    const void* g_lower, const void* g_upper, const void* wl_flu,
    const void* line_nu, const void* nu3_coef, const void* h_over_kt,
    const void* jb_w, double sobolev_coefficient, double time_explosion,
    int64_t L, int S, void* stim, void* tau, void* beta, void* jb,
    void* prefix, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  int64_t n = L * S;
  if (n > 0) {
    line_elements_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, st>>>(
        (const double*)level_pop, (const int32_t*)lower_idx,
        (const int32_t*)upper_idx, (const double*)g_lower,
        (const double*)g_upper, (const double*)wl_flu, (const double*)line_nu,
        (const double*)nu3_coef, (const double*)h_over_kt, (const double*)jb_w,
        sobolev_coefficient, time_explosion, L, S, (double*)stim,
        (double*)tau, (double*)beta, (double*)jb);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  prefix_scan_kernel<<<S, kScanThreads, 0, st>>>((const double*)tau, L, S,
                                                (double*)prefix);
  return (int)cudaGetLastError();
}
