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
//   `upd`. Phases: `count` (each live update bids for its row with
//   atomicMax(claim[row], p + 1): the update of the highest index holds the
//   row's claim, a row of validity 0 too); `add` (every live update adds its
//   row, F + 2 columns, into the accumulator row of its row's claimant,
//   `acc [B2, F+3]`: the scratch grows with the updates, not the table);
//   `finalize` (the claimant computes ck and gf from the summed touch count,
//   writes ck * tab + gf * sum to the row and its bias, and clears its
//   accumulator row and the claim for the next call). One warp per update. A
//   row that takes every update costs contended atomics at one set of L2
//   addresses, not a serial walk.
// - table_update_dense (B2; small tables, many updates per row): `scatter`
//   (one warp per update: the row is added into the persistent accumulator
//   `acc [N, F+3]`), a grid barrier, `decay` (one warp per table row: a row
//   whose accumulator is not all zero is rewritten, and its accumulator
//   zeroed for the next call). One barrier instead of two, at the cost of a
//   pass over N rows; `scatter._regime` sends only small tables here.
//
// Both sum in 64-bit fixed point (scale 2^32, 2.3e-10 resolution) with
// integer atomics, whose sum does not depend on their order: the result is a
// function of the inputs alone, bit for bit, run after run, and rounds once,
// as ck * tab + gf * sum does in the plain version. An accumulator row holds
// F factor sums, the bias sum, the touch count and a flag: an addend beyond
// `lim` = 2^30 / B2 (so that B2 updates cannot overflow a sum) or not finite
// is not added but flags the row, which the kernel then writes as NaN, as
// the f32 sum would have become; the fit's divergence check reports it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kFix = 4294967296.0f;               // 2^32, the fixed point
constexpr float kUnfix = 2.3283064365386963e-10f;   // 2^-32

__device__ __forceinline__ void decay_factors(float cnt, float eta, float c,
                                              float* ck, float* gf) {
  *ck = expf(cnt * logf(c));
  const float denom = cnt * (1.f - c);
  const float f = denom > 1e-12f ? (1.f - *ck) / fmaxf(denom, 1e-12f) : 1.f;
  *gf = eta * f;
}

__device__ __forceinline__ float unfix(unsigned long long v) {
  return __ll2float_rn((long long)v) * kUnfix;
}

// Update row `p` (F + 2 floats: gradient, bias gradient, validity) added
// into the accumulator row `acc` (F + 3 words) by the lanes of one warp;
// the bias column only with a bias. An addend out of range or not finite
// sets the flag word instead.
__device__ __forceinline__ void add_row(unsigned long long* acc,
                                        const float* __restrict__ u, int F,
                                        bool with_bias, float lim, int lane) {
  bool bad = false;
  for (int col = lane; col < F + 2; col += 32) {
    if (col == F && !with_bias) continue;
    const float x = __ldg(u + col);
    if (!(fabsf(x) <= lim))
      bad = true;
    else if (x != 0.f)
      atomicAdd(acc + col, (unsigned long long)__float2ll_rn(x * kFix));
  }
  if (__any_sync(kFull, bad) && lane == 0) atomicOr(acc + F + 2, 1ull);
}

// Table row `t` (and its bias) from its accumulator row `acc`, which is then
// cleared, by the lanes of one warp.
__device__ __forceinline__ void finish_row(float* t, float* bias,
                                           unsigned long long* acc, int F,
                                           float eta, float c, int lane) {
  const bool bad = __ldcg(acc + F + 2) != 0ull;
  float ck, gf;
  decay_factors(unfix(__ldcg(acc + F + 1)), eta, c, &ck, &gf);
  for (int col = lane; col < F; col += 32)
    t[col] = bad ? NAN : ck * t[col] + gf * unfix(__ldcg(acc + col));
  if (lane == 0 && bias)
    *bias = bad ? NAN : ck * *bias + gf * unfix(__ldcg(acc + F));
  __syncwarp();
  for (int col = lane; col < F + 3; col += 32) acc[col] = 0ull;
}

// B3. `claim [N]` and `acc [B2, F+3]` are all-zero on entry and on exit.
// Every thread passes both grid barriers: the loops are grid-stride and
// nothing returns early.
__global__ void __launch_bounds__(kThreads)
inplace_update(float* tab, float* bias, int N, int F,
               const int* __restrict__ idx, const float* __restrict__ upd,
               int B2, int* claim, unsigned long long* acc, float eta, float c,
               float lim) {
  cg::grid_group grid = cg::this_grid();
  const int D = F + 2, A = F + 3;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int threads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;

  // count: one thread per update bids for its row
  for (int p = tid; p < B2; p += threads) {
    const int row = idx[p];
    if ((unsigned)row < (unsigned)N) atomicMax(&claim[row], p + 1);
  }
  grid.sync();

  // add: one warp per update, into its row's claimant's accumulator row
  for (int p = tid >> 5; p < B2; p += threads >> 5) {
    const int row = idx[p];
    if ((unsigned)row >= (unsigned)N) continue;
    const int q = __ldcg(&claim[row]) - 1;
    add_row(acc + (size_t)q * A, upd + (size_t)p * D, F, bias != nullptr, lim,
            lane);
  }
  grid.sync();

  // finalize: the claimant of each row writes it and clears its scratch (no
  // other update of the row reads the claim as its own once it is cleared)
  for (int p = tid >> 5; p < B2; p += threads >> 5) {
    const int row = idx[p];
    if ((unsigned)row >= (unsigned)N || __ldcg(&claim[row]) != p + 1) continue;
    finish_row(tab + (size_t)row * F, bias ? bias + row : nullptr,
               acc + (size_t)p * A, F, eta, c, lane);
    if (lane == 0) claim[row] = 0;
  }
}

// B2. `acc [N, F+3]` is all-zero on entry and on exit.
__global__ void __launch_bounds__(kThreads)
dense_update(float* tab, float* bias, int N, int F,
             const int* __restrict__ idx, const float* __restrict__ upd,
             int B2, unsigned long long* acc, float eta, float c, float lim) {
  cg::grid_group grid = cg::this_grid();
  const int D = F + 2, A = F + 3;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int threads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;

  // scatter: one warp per update row
  for (int p = tid >> 5; p < B2; p += threads >> 5) {
    const int row = idx[p];
    if ((unsigned)row >= (unsigned)N) continue;
    add_row(acc + (size_t)row * A, upd + (size_t)p * D, F, bias != nullptr,
            lim, lane);
  }
  grid.sync();

  // decay: one warp per table row; consumes and clears the accumulator
  for (int row = tid >> 5; row < N; row += threads >> 5) {
    unsigned long long* a = acc + (size_t)row * A;
    bool touched = false;
    for (int col = lane; col < A; col += 32) touched |= __ldcg(a + col) != 0ull;
    if (!__any_sync(kFull, touched)) continue;
    finish_row(tab + (size_t)row * F, bias ? bias + row : nullptr, a, F, eta,
               c, lane);
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

}  // namespace

// The per-addend limit of a call of B2 updates: B2 addends of at most this
// magnitude sum to within 2^30 in the fixed point.
static float fix_limit(int B2) { return 1073741824.0f / (float)B2; }

// B3 in place: `claim` is an int32 scratch of N words and `acc` a 64-bit
// scratch of B2 * (F + 3) words, both all-zero on entry; the kernel leaves
// them all-zero. `bias` may be null. One cooperative launch on `stream`;
// returns its CUDA error (0 when it was accepted). Two launches that share
// the scratch must be on one stream.
extern "C" int rfm_table_update_sorted(float* tab, float* bias, int N, int F,
                                       const int* idx, const float* upd,
                                       int B2, int* claim,
                                       unsigned long long* acc, float eta,
                                       float c, void* stream) {
  if (B2 <= 0 || N <= 0) return 0;
  static int cache[kMaxDevices];
  const void* kernel = reinterpret_cast<const void*>(inplace_update);
  float lim = fix_limit(B2);
  void* args[] = {&tab, &bias, &N, &F, &idx, &upd, &B2, &claim, &acc, &eta,
                  &c, &lim};
  return launch(kernel, cache, (long long)B2 * 32, args,
                static_cast<cudaStream_t>(stream));
}

// B2: `acc` is a 64-bit scratch of N * (F + 3) words, all-zero on entry;
// the kernel leaves it all-zero. `bias` may be null. One cooperative launch
// on `stream`; returns its CUDA error (0 when it was accepted). Two launches
// that share `acc` must be on one stream.
extern "C" int rfm_table_update_dense(float* tab, float* bias, int N, int F,
                                      const int* idx, const float* upd,
                                      int B2, unsigned long long* acc,
                                      float eta, float c, void* stream) {
  if (B2 <= 0 || N <= 0) return 0;
  static int cache[kMaxDevices];
  const void* kernel = reinterpret_cast<const void*>(dense_update);
  float lim = fix_limit(B2);
  void* args[] = {&tab, &bias, &N, &F, &idx, &upd, &B2, &acc, &eta, &c, &lim};
  const long long a = (long long)B2 * 32, b = (long long)N * 32;
  return launch(kernel, cache, a > b ? a : b, args,
                static_cast<cudaStream_t>(stream));
}

extern "C" const char* rfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
