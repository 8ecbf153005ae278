// K2 blackbody_source: the packet pool (mu, nu_cmf[, w]) of one iteration.
//
// Replaces: tardis_tpu/transport/source.py:31 `sample_blackbody_packets`
// (Bjorkman & Wood blackbody frequencies, mu = sqrt(xi)), :58
// `sample_blackbody_packets_weighted` and :89
// `sample_blackbody_packets_relativistic`, vmapped JAX programs over packet
// ids; `mode` selects the pool (0 simple, 1 relativistic, 2 weighted).
//
// Bound on the H100: operations.  Each packet derives its key with one
// threefry2x32 hash and draws its uniforms with one hash each (~72 integer
// operations a hash): the simple pool 7 hashes (columns 0-5), the
// relativistic pool 8 (columns 0-4, then fold_in(., 7) and its draw; column
// 5 is never drawn there), the weighted pool 3; the first two add a
// ten-step binary search over the 999-entry l-table and one log; each
// packet writes 8 or 12 bytes.  Logs and exponentials are taken in f64 and
// rounded to f32, so this kernel and its plain version
// (tardis_torch/transport/source.py) agree bit for bit, and both sit within
// an ulp of JAX's f32 functions.  Built with --fmad=false (see
// tardis_torch/cuda.py).
//
// Simple and relativistic pools: one thread a packet, no shared state; the
// l-table (4 KB, made on the device once by the wrapper) stays in L1/L2.
//
// Weighted pool: w divided by its mean, in one cooperative launch of a
// persistent grid (the card's SMs x the blocks that fit on one).  Blocks
// walk fixed chunks of kChunk packets; a chunk's f64 weights are summed
// by halves (s_j += s_{j+h}, h = kChunk/2 .. 1) into its own slot; after
// the grid's barrier every block sums the slots by halves over the next
// power of two >= max(kThreads, chunks), the missing entries 0, rounds the
// mean to f32 and divides its own packets' weights, re-read from L2 where
// the first pass left them.  The chunking depends on n alone and no sum
// races, so w is the same bits from run to run and equals the plain
// version's reshape-and-fold.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "threefry.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSimple = 0;
constexpr int kRelativistic = 1;
constexpr int kWeighted = 2;
constexpr int kThreads = 256;
constexpr int kChunk = 2048;  // packets a slot of the weighted pool's sum
constexpr int kPerThread = kChunk / kThreads;
constexpr uint32_t kRelMuFold = 7;
constexpr int kMaxDevices = 64;

struct Params {
  tardis::Key key;
  int64_t n;
  const float* l_array;
  int n_l;
  float l_coef, nu_coef, nu_unit;
  float beta, bb, two_beta, w_rel;     // relativistic pool
  float log_lo, log_span, h, kt, x_lo, x_hi;  // weighted pool
  float* mu;
  float* nu;
  float* w;
  double* slots;  // weighted pool: one f64 sum a chunk
  int64_t n_chunks;
};

__device__ __forceinline__ float uniform01(tardis::Key k, uint32_t column) {
  return tardis::uniform_f32(tardis::random_bits(k, column), 0.0f, 1.0f);
}

template <int kMode>
__global__ void blackbody_source_kernel(Params p) {
  const int64_t pid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (pid >= p.n) return;
  const tardis::Key k = tardis::fold_in(p.key, (uint32_t)pid);
  constexpr int kColumns = kMode == kSimple ? 6 : 5;
  float xi[kColumns];
#pragma unroll
  for (int j = 0; j < kColumns; ++j) xi[j] = uniform01(k, (uint32_t)j);
  // searchsorted(l_array, xi0 * l_coef, side="left") + 1
  const float v = xi[0] * p.l_coef;
  int lo = 0, hi = p.n_l;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (p.l_array[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  const float l_min = (float)(lo + 1);
  const float prod = fmaxf(((xi[1] * xi[2]) * xi[3]) * xi[4], 1e-37f);
  const float x = (float)(-log((double)prod)) / l_min;
  p.nu[pid] = (x * p.nu_coef) / p.nu_unit;
  if constexpr (kMode == kSimple) {
    p.mu[pid] = sqrtf(xi[kColumns - 1]);
  } else {
    const float z = uniform01(tardis::fold_in(k, kRelMuFold), 0);
    p.mu[pid] = -p.beta + sqrtf((p.bb + p.two_beta * z) + z);
    p.w[pid] = p.w_rel;
  }
}

// One weighted packet: stores mu and nu, returns its weight before the
// division by the mean.
__device__ __forceinline__ float weighted_packet(const Params& p, int64_t pid) {
  const tardis::Key k = tardis::fold_in(p.key, (uint32_t)pid);
  const float nu = (float)exp((double)(p.log_lo + uniform01(k, 0) * p.log_span));
  const float x = fminf(fmaxf(((p.h * nu) * p.nu_unit) / p.kt, p.x_lo), p.x_hi);
  p.nu[pid] = nu;
  p.mu[pid] = sqrtf(uniform01(k, 1));
  return ((nu * nu) * (nu * nu)) / (float)expm1((double)x);
}

// The block's kThreads values summed by halves (s_t += s_{t+h}, h = 128 ..
// 1); the sum is valid in thread 0.  Every thread of the block calls it.
__device__ double fold_block(double v, double* scratch) {
  const int t = threadIdx.x;
  scratch[t] = v;
  __syncthreads();
#pragma unroll
  for (int h = kThreads / 2; h >= 32; h >>= 1) {
    if (t < h) scratch[t] += scratch[t + h];
    __syncthreads();
  }
  double s = 0.0;
  if (t < 32) {
    s = scratch[t];
#pragma unroll
    for (int h = 16; h > 0; h >>= 1) s += __shfl_down_sync(0xffffffffu, s, h);
  }
  __syncthreads();  // scratch is free again
  return s;
}

// 8 blocks a SM (at most 32 registers): the grid covers 1,056 chunks at
// once, so the 1,024 chunks of 2,097,152 packets run in one round
__global__ void __launch_bounds__(kThreads, 8) weighted_pool_kernel(Params p) {
  static_assert(kPerThread == 8, "pass 1 reverses 3 bits");
  __shared__ double scratch[kThreads];
  __shared__ float mean_shared;
  const int t = threadIdx.x;
  // pass 1: each chunk's weights, summed by halves into its slot; packet
  // c * kChunk + t + i * kThreads is this thread's i-th, so the halves
  // with h >= kThreads pair a thread's own values.  The thread takes them
  // in bit-reversed order of i, merging neighbours as a binary counter
  // does (the same pairs), so at most 3 partial sums are live.
  for (int64_t c = blockIdx.x; c < p.n_chunks; c += gridDim.x) {
    double part[3];
    int depth = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = ((k & 1) << 2) | (k & 2) | (k >> 2);
      const int64_t pid = c * kChunk + t + (int64_t)i * kThreads;
      double x = 0.0;
      if (pid < p.n) {
        const float w = weighted_packet(p, pid);
        p.w[pid] = w;
        x = (double)w;
      }
#pragma unroll
      for (int b = k; b & 1; b >>= 1) x = part[--depth] + x;
      part[depth++] = x;
    }
    const double s = fold_block(part[0], scratch);
    if (t == 0) p.slots[c] = s;
  }
  cg::this_grid().sync();
  // pass 2: the slots by halves over width = the next power of two >=
  // max(kThreads, n_chunks).  Thread t folds its residue class
  // {t + kThreads * i} by halves in i (in bit-reversed order, merging
  // neighbours as a binary counter does), then the block folds t.
  int q = 0;
  while (((int64_t)kThreads << q) < p.n_chunks) ++q;
  double stack[40];
  int depth = 0;
  for (int64_t k = 0; k < ((int64_t)1 << q); ++k) {
    const int64_t i = q == 0 ? 0 : (int64_t)(__brevll((unsigned long long)k) >> (64 - q));
    const int64_t j = t + (int64_t)kThreads * i;
    double x = j < p.n_chunks ? p.slots[j] : 0.0;
    for (int64_t c = k; c & 1; c >>= 1) x = stack[--depth] + x;
    stack[depth++] = x;
  }
  const double total = fold_block(stack[0], scratch);
  if (t == 0) mean_shared = (float)(total / (double)p.n);
  __syncthreads();
  const float mean = mean_shared;
  for (int64_t c = blockIdx.x; c < p.n_chunks; c += gridDim.x) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int64_t pid = c * kChunk + t + (int64_t)i * kThreads;
      if (pid < p.n) p.w[pid] = p.w[pid] / mean;
    }
  }
}

// The weighted pool's grid on each device: its SMs x the blocks of
// weighted_pool_kernel that fit on one, asked once a device.
int coop_blocks_per_sm[kMaxDevices];
int coop_sms[kMaxDevices];

cudaError_t weighted_grid(int* blocks_per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (coop_sms[dev] == 0) {
    int supported = 0;
    err = cudaDeviceGetAttribute(&supported, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!supported) return cudaErrorNotSupported;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &coop_blocks_per_sm[dev], weighted_pool_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&coop_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *blocks_per_sm = coop_blocks_per_sm[dev];
  *sms = coop_sms[dev];
  return cudaSuccess;
}

}  // namespace

// `info` (3 ints, host memory) receives the weighted pool's grid, blocks a
// SM and SMs, so a refused cooperative launch can be reported with them.
extern "C" int blackbody_source(
    uint32_t k0, uint32_t k1, int64_t n, const void* l_array, int n_l,
    float l_coef, float nu_coef, float nu_unit, int mode, float beta,
    float bb, float two_beta, float w_rel, float log_lo, float log_span,
    float h, float kt, float x_lo, float x_hi, void* mu, void* nu, void* w,
    void* slots, int* info, void* stream) {
  Params p;
  p.key = tardis::Key{k0, k1};
  p.n = n;
  p.l_array = (const float*)l_array;
  p.n_l = n_l;
  p.l_coef = l_coef;
  p.nu_coef = nu_coef;
  p.nu_unit = nu_unit;
  p.beta = beta;
  p.bb = bb;
  p.two_beta = two_beta;
  p.w_rel = w_rel;
  p.log_lo = log_lo;
  p.log_span = log_span;
  p.h = h;
  p.kt = kt;
  p.x_lo = x_lo;
  p.x_hi = x_hi;
  p.mu = (float*)mu;
  p.nu = (float*)nu;
  p.w = (float*)w;
  p.slots = (double*)slots;
  p.n_chunks = (n + kChunk - 1) / kChunk;  // the wrapper's slots
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kWeighted) {
    int blocks_per_sm = 0, sms = 0;
    cudaError_t err = weighted_grid(&blocks_per_sm, &sms);
    if (err != cudaSuccess) return (int)err;
    const int64_t fit = (int64_t)blocks_per_sm * sms;
    const int grid = (int)(p.n_chunks < fit ? p.n_chunks : fit);
    info[0] = grid;
    info[1] = blocks_per_sm;
    info[2] = sms;
    if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {&p};
    return (int)cudaLaunchCooperativeKernel((const void*)weighted_pool_kernel,
                                            dim3(grid), dim3(kThreads), args,
                                            0, s);
  }
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (mode == kSimple) {
    blackbody_source_kernel<kSimple><<<blocks, kThreads, 0, s>>>(p);
  } else {
    blackbody_source_kernel<kRelativistic><<<blocks, kThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
