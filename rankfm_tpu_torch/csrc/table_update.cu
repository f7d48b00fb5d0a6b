// Per-touch decayed table update for Hopper (sm_90a).
//
// Replaces the TPU kernels `rankfm_tpu/ops/scatter.py:_kernel_dense` (B2)
// and `rankfm_tpu/ops/scatter.py:_kernel_sorted` (B3). Both compute, for a
// table `tab [N, F]`, an optional bias `bias [N]` and B2 update rows
// `upd [B2, F+2]` (factor gradient | bias gradient | validity) aimed at rows
// `idx [B2]` (entries outside [0, N) are skipped):
//
//   cnt = sum of upd[:, F+1] over the row's updates
//   ck  = c^cnt,  f = (1 - ck) / (cnt (1 - c))   (1 when cnt (1 - c) <= 1e-12)
//   tab  <- ck * tab  + eta * f * sum(upd[:, :F])
//   bias <- ck * bias + eta * f * sum(upd[:, F])
//
// in f32, for every row that some update touches; other rows are not
// written. The TPU contracts a bf16 one-hot matrix against the updates on
// its matrix unit, tile by tile, because its scatter is near-serial; that
// packing (and its bf16 rounding of `upd`) is not carried over.
//
// What bounds it on an H100: bytes, and at these sizes launch latency. The
// candidate tail of the Instacart fit updates 16,384 item rows of 52 floats
// (3.4 MB) and 8,192 user rows per batch; the tables are 7 MB and 2 MB and
// sit in L2. The design reads every update once and writes each touched
// table row once.
//
// - table_update_sorted (B3): the wrapper sorts `idx` (stable) and permutes
//   `upd`. One warp per sorted position; the warp at the first position of
//   a run of equal valid `idx` sums the run (lane k holds columns k, k+32,
//   ...), then writes the decayed row and bias once. No atomics: the result
//   is deterministic. A run has no length limit, so the TPU kernel's
//   span-overflow fallback has no counterpart here.
// - table_update_dense (B2): two launches. scatter_add adds every valid
//   update row into a zeroed f32 accumulator `acc [N, F+2]` with atomics
//   (the summation order changes from run to run); decay_rows gives one
//   warp to each table row and rewrites the rows whose accumulator is not
//   all zero.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerLane = 4;  // columns a lane sums in one pass over a run

__device__ __forceinline__ void decay_factors(float cnt, float eta, float c,
                                              float* ck, float* gf) {
  *ck = expf(cnt * logf(c));
  const float denom = cnt * (1.f - c);
  const float f = denom > 1e-12f ? (1.f - *ck) / fmaxf(denom, 1e-12f) : 1.f;
  *gf = eta * f;
}

__global__ void __launch_bounds__(kThreads)
sorted_runs(float* __restrict__ tab, float* __restrict__ bias, int N, int F,
            const int* __restrict__ idx_s, const float* __restrict__ upd_s,
            int B2, float eta, float c) {
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= B2) return;
  const int row = idx_s[p];
  if (row < 0 || row >= N || (p > 0 && idx_s[p - 1] == row)) return;
  const int D = F + 2;

  // touch count, and the run's end (lanes stride the run's updates)
  float cnt = 0.f;
  int last = p;
  for (int r = p + lane; r < B2 && idx_s[r] == row; r += 32) {
    cnt += upd_s[(size_t)r * D + F + 1];
    last = r;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
    last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  }
  float ck, gf;
  decay_factors(cnt, eta, c, &ck, &gf);

  // column sums, kColsPerLane * 32 columns per pass over the run
  for (int c0 = 0; c0 <= F; c0 += 32 * kColsPerLane) {
    float acc[kColsPerLane];
#pragma unroll
    for (int q = 0; q < kColsPerLane; ++q) acc[q] = 0.f;
    for (int r = p; r <= last; ++r) {
      const float* u = upd_s + (size_t)r * D;
#pragma unroll
      for (int q = 0; q < kColsPerLane; ++q) {
        const int col = c0 + q * 32 + lane;
        if (col <= F) acc[q] += u[col];
      }
    }
#pragma unroll
    for (int q = 0; q < kColsPerLane; ++q) {
      const int col = c0 + q * 32 + lane;
      if (col < F) {
        float* t = tab + (size_t)row * F + col;
        *t = ck * *t + gf * acc[q];
      } else if (col == F && bias) {
        bias[row] = ck * bias[row] + gf * acc[q];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_add(float* __restrict__ acc, int N, int D,
            const int* __restrict__ idx, const float* __restrict__ upd,
            int B2) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (int64_t)B2 * D) return;
  const int r = (int)(t / D), col = (int)(t - (int64_t)r * D);
  const int row = idx[r];
  if (row < 0 || row >= N) return;
  atomicAdd(&acc[(size_t)row * D + col], upd[t]);
}

__global__ void __launch_bounds__(kThreads)
decay_rows(float* __restrict__ tab, float* __restrict__ bias, int N, int F,
           const float* __restrict__ acc, float eta, float c) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;
  const int D = F + 2;
  const float* a = acc + (size_t)row * D;
  bool touched = false;
  for (int col = lane; col < D; col += 32) touched |= a[col] != 0.f;
  if (!__any_sync(0xffffffffu, touched)) return;
  float ck, gf;
  decay_factors(a[F + 1], eta, c, &ck, &gf);
  for (int col = lane; col < F; col += 32) {
    float* t = tab + (size_t)row * F + col;
    *t = ck * *t + gf * a[col];
  }
  if (lane == 0 && bias) bias[row] = ck * bias[row] + gf * a[F];
}

}  // namespace

// B3: `idx_s [B2]` sorted ascending, `upd_s [B2, F+2]` permuted alike.
// `bias` may be null. Launched on `stream`; returns the launch's CUDA error
// (0 when it was accepted).
extern "C" int rfm_table_update_sorted(float* tab, float* bias, int N, int F,
                                       const int* idx_s, const float* upd_s,
                                       int B2, float eta, float c,
                                       void* stream) {
  if (B2 <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (B2 + kWarps - 1) / kWarps;
  sorted_runs<<<blocks, kThreads, 0, st>>>(tab, bias, N, F, idx_s, upd_s, B2,
                                           eta, c);
  return (int)cudaGetLastError();
}

// B2: `acc` is a zeroed f32 scratch of N * (F+2) floats. `bias` may be null.
// Two launches on `stream`; returns the first CUDA error (0 when both were
// accepted).
extern "C" int rfm_table_update_dense(float* tab, float* bias, int N, int F,
                                      const int* idx, const float* upd,
                                      int B2, float* acc, float eta, float c,
                                      void* stream) {
  if (B2 <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = F + 2;
  const int64_t n = (int64_t)B2 * D;
  scatter_add<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      acc, N, D, idx, upd, B2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decay_rows<<<(N + kWarps - 1) / kWarps, kThreads, 0, st>>>(tab, bias, N, F,
                                                             acc, eta, c);
  return (int)cudaGetLastError();
}

extern "C" const char* rfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
