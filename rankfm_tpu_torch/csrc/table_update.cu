// Per-touch decayed table update for Hopper (sm_90a).
//
// Replaces the TPU kernels `rankfm_tpu/ops/scatter.py:_kernel_dense` (B2,
// entry point `rfm_table_update_dense`) and
// `rankfm_tpu/ops/scatter.py:_kernel_sorted` (B3, entry point
// `rfm_table_update_sorted`). Both compute, for a table `tab [N, F]`, an
// optional bias `bias [N]` and B2 update rows `upd [B2, F+2]` (factor
// gradient | bias gradient | validity) aimed at rows `idx [B2]` (entries
// outside [0, N) are skipped):
//
//   cnt = sum of upd[:, F+1] over the row's updates
//   ck  = c^cnt,  f = (1 - ck) / (cnt (1 - c))   (1 when cnt (1 - c) <= 1e-12)
//   tab  <- ck * tab  + eta * f * sum(upd[:, :F])
//   bias <- ck * bias + eta * f * sum(upd[:, F])
//
// in f32, for every row that some update touches; other rows are not
// written. The TPU contracts a bf16 one-hot matrix against the updates on
// its matrix unit, tile by tile, because its scatter is near-serial, and
// sorts the updates so that a tile of a large table reads only its own span;
// neither the packing, nor its bf16 rounding of `upd`, nor the sort is
// carried over: this card has atomic adds at the L2.
//
// What bounds it on an H100: bytes (the updates read once, each touched row
// read and written once: 3.4 MB + 6 MB for 16,384 updates of 52 floats, a
// few microseconds of memory time, all of it L2-resident between the steps
// of a fit), and below ~10 us the launch itself: an empty dependent launch
// costs 2.5-4.7 us on this card and a phase that ends in a grid barrier
// about 2 us, more than the memory time of the work. So each entry point is
// ONE cooperative launch whose phases are separated by grid barriers, it
// allocates and clears nothing per call (its scratch is persistent and
// every call restores it), and no phase is serial in the length of a row's
// run of updates.
//
// - table_update_sorted (B3; tables of many more rows than updates): work
//   and traffic O(B2 * F), independent of N; no sort, no second copy of
//   `upd`. The update is linear in the row, ck * tab + sum_p(gf * upd_p)
//   with ck and gf = eta * f functions of the row's touch count only, so it
//   is applied in place. Phases: `count` (each live update adds its validity
//   into cnt[row] and bids for the row with atomicMax(claim[row], p + 1):
//   the claim is apart from the count, so a row of validity 0 is claimed
//   too); `scale` (the update that holds the claim multiplies the row and
//   its bias by ck, stores gf for the row, and zeroes cnt[row] and
//   claim[row] for the next call); `add` (every live update adds
//   gf * upd[p, :] into the row with `red`, two floats at a time where F is
//   even and the rows are 8-byte aligned). One warp per update. A row that
//   takes every update costs contended atomics at one set of L2 addresses,
//   not a serial walk.
// - table_update_dense (B2; small tables, many updates per row): `scatter`
//   (one warp per update: the row is added into the persistent f32
//   accumulator `acc [N, F+2]` with `red`, four floats at a time where F+2
//   is a multiple of 4 and the rows are 16-byte aligned, else two, else
//   one), a grid barrier, `decay` (one warp per table row: a row whose
//   accumulator is not all zero is rewritten, and its accumulator zeroed
//   for the next call). One barrier instead of two, at the cost of a pass
//   over N rows; `scatter._regime` sends only small tables here.
//
// Both sum a row's updates with atomics, in an order that changes from run
// to run; the in-place form rounds differently from ck * tab + gf * sum by
// a few ulp.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void decay_factors(float cnt, float eta, float c,
                                              float* ck, float* gf) {
  *ck = expf(cnt * logf(c));
  const float denom = cnt * (1.f - c);
  const float f = denom > 1e-12f ? (1.f - *ck) / fmaxf(denom, 1e-12f) : 1.f;
  *gf = eta * f;
}

// VEC floats of `src`, scaled by `s`, added into `dst` by one reduction at
// the L2 (the result is not read, so no value travels back)
template <int VEC>
__device__ __forceinline__ void red_add(float* dst, const float* src, float s);

template <>
__device__ __forceinline__ void red_add<1>(float* dst, const float* src,
                                           float s) {
  atomicAdd(dst, s * __ldg(src));
}

template <>
__device__ __forceinline__ void red_add<2>(float* dst, const float* src,
                                           float s) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(src));
  atomicAdd(reinterpret_cast<float2*>(dst), make_float2(s * v.x, s * v.y));
}

template <>
__device__ __forceinline__ void red_add<4>(float* dst, const float* src,
                                           float s) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(src));
  atomicAdd(reinterpret_cast<float4*>(dst),
            make_float4(s * v.x, s * v.y, s * v.z, s * v.w));
}

// `n` floats of `src` times `s` into `dst` (n a multiple of VEC), by the
// lanes of one warp
template <int VEC>
__device__ __forceinline__ void red_row(float* dst, const float* src, int n,
                                        float s, int lane) {
  for (int k = lane * VEC; k < n; k += 32 * VEC)
    red_add<VEC>(dst + k, src + k, s);
}

// B3. `cnt [N]` and `claim [N]` are all-zero on entry and on exit; `gfs [N]`
// holds anything. Every thread passes both grid barriers: the loops are
// grid-stride and nothing returns early.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
inplace_update(float* tab, float* bias, int N, int F,
               const int* __restrict__ idx, const float* __restrict__ upd,
               int B2, float* cnt, int* claim, float* gfs, float eta,
               float c) {
  cg::grid_group grid = cg::this_grid();
  const int D = F + 2;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int threads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;

  // count: one thread per update
  for (int p = tid; p < B2; p += threads) {
    const int row = idx[p];
    if ((unsigned)row < (unsigned)N) {
      atomicAdd(&cnt[row], upd[(size_t)p * D + F + 1]);
      atomicMax(&claim[row], p + 1);
    }
  }
  grid.sync();

  // scale: one warp per update. The update that holds its row's claim
  // multiplies the row by ck, leaves gf for the row's updates, and clears
  // the row's count and claim (no other update reads the count in this
  // phase, and a cleared claim is no other update's either)
  for (int p = tid >> 5; p < B2; p += threads >> 5) {
    const int row = idx[p];
    if ((unsigned)row >= (unsigned)N || __ldcg(&claim[row]) != p + 1) continue;
    float ck, gf;
    decay_factors(__ldcg(&cnt[row]), eta, c, &ck, &gf);
    float* t = tab + (size_t)row * F;
    if (VEC == 2) {
      float2* t2 = reinterpret_cast<float2*>(t);
      for (int k = lane; k < F / 2; k += 32) {
        float2 v = t2[k];
        t2[k] = make_float2(ck * v.x, ck * v.y);
      }
    } else {
      for (int col = lane; col < F; col += 32) t[col] *= ck;
    }
    __syncwarp();
    if (lane == 0) {
      if (bias) bias[row] *= ck;
      gfs[row] = gf;
      cnt[row] = 0.f;
      claim[row] = 0;
    }
  }
  grid.sync();

  // add: every live update adds gf * upd[p, :F] into its row, gf * upd[p, F]
  // into its bias
  for (int p = tid >> 5; p < B2; p += threads >> 5) {
    const int row = idx[p];
    if ((unsigned)row >= (unsigned)N) continue;
    const float gf = __ldcg(&gfs[row]);
    const float* u = upd + (size_t)p * D;
    red_row<VEC>(tab + (size_t)row * F, u, F, gf, lane);
    if (lane == 31 && bias) red_add<1>(bias + row, u + F, gf);
  }
}

// B2. `acc [N, F+2]` is all-zero on entry and on exit.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
dense_update(float* tab, float* bias, int N, int F,
             const int* __restrict__ idx, const float* __restrict__ upd,
             int B2, float* acc, float eta, float c) {
  cg::grid_group grid = cg::this_grid();
  const int D = F + 2;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int threads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;

  // scatter: one warp per update row
  for (int p = tid >> 5; p < B2; p += threads >> 5) {
    const int row = idx[p];
    if ((unsigned)row >= (unsigned)N) continue;
    red_row<VEC>(acc + (size_t)row * D, upd + (size_t)p * D, D, 1.f, lane);
  }
  grid.sync();

  // decay: one warp per table row; consumes and clears the accumulator
  for (int row = tid >> 5; row < N; row += threads >> 5) {
    float* a = acc + (size_t)row * D;
    bool touched = false;
    for (int col = lane; col < D; col += 32) touched |= __ldcg(a + col) != 0.f;
    if (!__any_sync(kFull, touched)) continue;
    float ck, gf;
    decay_factors(__ldcg(a + F + 1), eta, c, &ck, &gf);
    float* t = tab + (size_t)row * F;
    for (int col = lane; col < F; col += 32)
      t[col] = ck * t[col] + gf * __ldcg(a + col);
    if (lane == 0 && bias) bias[row] = ck * bias[row] + gf * __ldcg(a + F);
    __syncwarp();
    for (int col = lane; col < D; col += 32) a[col] = 0.f;
  }
}

// Blocks of a cooperative launch of `kernel` that can be resident at once on
// the current device, looked up once per device and kernel.
cudaError_t resident_blocks(const void* kernel, int* cache, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    cache[dev] = sms * per_sm;
  }
  *blocks = cache[dev];
  return cudaSuccess;
}

// One cooperative launch of `kernel`: enough blocks for `want_threads`
// threads, at most the resident ones.
int launch(const void* kernel, int* cache, long long want_threads, void** args,
           cudaStream_t st) {
  int blocks = 0;
  cudaError_t err = resident_blocks(kernel, cache, &blocks);
  if (err != cudaSuccess) return (int)err;
  const long long want = (want_threads + kThreads - 1) / kThreads;
  if (want < blocks) blocks = want < 1 ? 1 : (int)want;
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args,
                                    0, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// B3 in place: `cnt` (f32), `claim` (int32) and `gfs` (f32) are scratch of N
// words each; `cnt` and `claim` are all-zero on entry and the kernel leaves
// them all-zero, `gfs` may hold anything. `bias` may be null. One cooperative
// launch on `stream`; returns its CUDA error (0 when it was accepted). Two
// launches that share the scratch must be on one stream.
extern "C" int rfm_table_update_sorted(float* tab, float* bias, int N, int F,
                                       const int* idx, const float* upd,
                                       int B2, float* cnt, int* claim,
                                       float* gfs, float eta, float c,
                                       void* stream) {
  if (B2 <= 0 || N <= 0) return 0;
  static int cache[2][kMaxDevices];
  const bool v2 = F % 2 == 0 && aligned(tab, 8) && aligned(upd, 8);
  const void* kernel =
      v2 ? reinterpret_cast<const void*>(inplace_update<2>)
         : reinterpret_cast<const void*>(inplace_update<1>);
  void* args[] = {&tab, &bias, &N,   &F,     &idx, &upd,
                  &B2,  &cnt,  &claim, &gfs, &eta, &c};
  return launch(kernel, cache[v2], (long long)B2 * 32, args,
                static_cast<cudaStream_t>(stream));
}

// B2: `acc` is an f32 scratch of N * (F+2) floats, all-zero on entry; the
// kernel leaves it all-zero. `bias` may be null. One cooperative launch on
// `stream`; returns its CUDA error (0 when it was accepted). Two launches
// that share `acc` must be on one stream.
extern "C" int rfm_table_update_dense(float* tab, float* bias, int N, int F,
                                      const int* idx, const float* upd,
                                      int B2, float* acc, float eta, float c,
                                      void* stream) {
  if (B2 <= 0 || N <= 0) return 0;
  static int cache[3][kMaxDevices];
  const int D = F + 2;
  const int vec = D % 4 == 0 && aligned(acc, 16) && aligned(upd, 16)   ? 4
                  : D % 2 == 0 && aligned(acc, 8) && aligned(upd, 8) ? 2
                                                                     : 1;
  const void* kernel =
      vec == 4   ? reinterpret_cast<const void*>(dense_update<4>)
      : vec == 2 ? reinterpret_cast<const void*>(dense_update<2>)
                 : reinterpret_cast<const void*>(dense_update<1>);
  void* args[] = {&tab, &bias, &N, &F, &idx, &upd, &B2, &acc, &eta, &c};
  const long long a = (long long)B2 * 32, b = (long long)N * 32;
  return launch(kernel, cache[vec >> 1], a > b ? a : b, args,
                static_cast<cudaStream_t>(stream));
}

extern "C" const char* rfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
