// numpy's normal draws on the card (sm_90a), bit for bit: the stream
// positions of `np.random.default_rng(seed).normal(0, sigma, n)` whose
// ziggurat attempt is decided by one raw word (entry points `rfm_pcg_scan`,
// `rfm_pcg_compact`, `rfm_pcg_emit`).
//
// Replaces no TPU kernel: `RankFM._init_weights` draws the initial factor
// tables with numpy on the host in both packages, and the tests hold every
// fit of the port against the JAX package's from the same tables. At a
// catalog of ~10^6 items that draw is ~65 M float64 normals on one host
// thread, a cast and a copy to the card, seconds in which the card idles.
//
// The stream and one attempt are `ziggurat.h`'s. Position p is the stream's
// word p; an attempt that starts there is decided by that word alone when
// rabs < ki[idx] (~98.5% of the positions): it emits x and consumes one
// word. The other positions need the wedge or the tail, which read the next
// words, may reject, and so decide which later positions start an attempt:
// `native/normal_walk.cpp` walks them in stream order on the host, with the
// libm `exp` and `log1p` that numpy calls. The three launches around it:
//
// - `scan_kernel`: bit p & 31 of `mask[p >> 5]` = position p < N is decided
//   by one word; `cnt[s]` = the positions of segment s that are not.
// - `compact_kernel`: for every such position, in stream order from the
//   exclusive sums of `cnt`, a record {p, word p, word p + 1, word p + 2}.
// - (the host walk turns `mask` into the emit mask: the positions that
//   start an accepted attempt, and `base[s]`, the emits before segment s)
// - `emit_kernel`: every emitting position decided by one word writes
//   float(0.0 + sigma * x) at its rank among the emits, rank < n0 into
//   `out0`, the rest into `out1`; the walk's values fill the other ranks.
//
// Layout: one warp per segment of `seg_words` 32-position words, lane l on
// the positions 32 w + l. Each lane jumps once to its first position
// (square and multiply on the 128-bit LCG), then steps by 32 positions at a
// time, itself an affine map of the state; a word's decided bits are one
// ballot, and an emitting warp writes consecutive ranks. Arithmetic as
// numpy's, each operation rounded: x = rabs * wi[idx] (exact in double),
// then sigma * x, then 0.0 + that, then the cast to float; nothing fused.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ziggurat.h"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ const uint64_t g_ki[256] = RFM_ZIG_KI;
__device__ const double g_wi[256] = RFM_ZIG_WI;

// the stream's state and increment, as 64-bit halves
struct Stream {
  unsigned long long s_hi, s_lo, i_hi, i_lo;
};

struct Lane {
  rfm_u128 state;   // the state whose output is this lane's next word
  rfm_u128 a, c;    // 32 steps: state <- a * state + c
};

__device__ __forceinline__ Lane lane_start(Stream st, long long first_pos) {
  const rfm_u128 s0 = ((rfm_u128)st.s_hi << 64) | st.s_lo;
  const rfm_u128 inc = ((rfm_u128)st.i_hi << 64) | st.i_lo;
  Lane ln;
  ln.state = rfm_pcg_advance(s0, inc, (unsigned long long)first_pos + 1);
  ln.c = rfm_pcg_advance(0, inc, 32);
  ln.a = rfm_pcg_advance(1, inc, 32) - ln.c;
  return ln;
}

__device__ __forceinline__ uint64_t lane_word(Lane* ln) {
  const uint64_t r = rfm_pcg_output(ln->state);
  ln->state = ln->a * ln->state + ln->c;
  return r;
}

// numpy's tables into shared memory (a lane's idx is random: a table in
// constant memory would serialise the warp's reads); wi may be null
__device__ __forceinline__ void load_tables(uint64_t* ki, double* wi) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    ki[i] = g_ki[i];
    if (wi) wi[i] = g_wi[i];
  }
  __syncthreads();
}

__device__ __forceinline__ bool one_word(const uint64_t* ki, uint64_t r) {
  return ((r >> 9) & RFM_ZIG_MASK52) < ki[r & 0xff];
}

__global__ void __launch_bounds__(kThreads)
    scan_kernel(Stream st, long long N, int seg_words,
                unsigned* __restrict__ mask, int* __restrict__ cnt) {
  __shared__ uint64_t ki[256];
  load_tables(ki, nullptr);
  const long long seg = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  const long long nw = (N + 31) / 32;
  const long long w0 = seg * seg_words;
  if (w0 >= nw) return;
  Lane ln = lane_start(st, w0 * 32 + lane);
  int slow = 0;
  for (long long w = w0; w < w0 + seg_words && w < nw; ++w) {
    const long long p = w * 32 + lane;
    const uint64_t r = lane_word(&ln);
    const bool live = p < N;
    const bool fast = live && one_word(ki, r);
    const unsigned b = __ballot_sync(kFull, fast);
    slow += __popc(__ballot_sync(kFull, live && !fast));
    if (lane == 0) mask[w] = b;
  }
  if (lane == 0) cnt[seg] = slow;
}

__global__ void __launch_bounds__(kThreads)
    compact_kernel(Stream st, long long N, int seg_words,
                   const unsigned* __restrict__ mask,
                   const long long* __restrict__ off,
                   long long* __restrict__ rec) {
  const long long seg = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  const long long nw = (N + 31) / 32;
  const long long w0 = seg * seg_words;
  if (w0 >= nw) return;
  Lane ln = lane_start(st, w0 * 32 + lane);
  long long o = off[seg];
  uint64_t cur = lane_word(&ln);
  for (long long w = w0; w < w0 + seg_words && w < nw; ++w) {
    const long long p = w * 32 + lane;
    const uint64_t nxt = lane_word(&ln);   // word p + 32
    const uint64_t d1 = __shfl_down_sync(kFull, cur, 1);
    const uint64_t d2 = __shfl_down_sync(kFull, cur, 2);
    const uint64_t n0 = __shfl_sync(kFull, nxt, 0);
    const uint64_t n1 = __shfl_sync(kFull, nxt, 1);
    const uint64_t r1 = lane < 31 ? d1 : n0;
    const uint64_t r2 = lane < 30 ? d2 : (lane == 30 ? n0 : n1);
    const bool slow = p < N && !((mask[w] >> lane) & 1u);
    const unsigned b = __ballot_sync(kFull, slow);
    if (slow) {
      long long* out = rec + 4 * (o + __popc(b & ((1u << lane) - 1u)));
      out[0] = p;
      out[1] = (long long)cur;
      out[2] = (long long)r1;
      out[3] = (long long)r2;
    }
    o += __popc(b);
    cur = nxt;
  }
}

__global__ void __launch_bounds__(kThreads)
    emit_kernel(Stream st, long long N, int seg_words,
                const unsigned* __restrict__ mask,
                const long long* __restrict__ base, long long T, long long n0,
                double sigma, float* __restrict__ out0,
                float* __restrict__ out1) {
  __shared__ uint64_t ki[256];
  __shared__ double wi[256];
  load_tables(ki, wi);
  const long long seg = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  const long long nw = (N + 31) / 32;
  const long long w0 = seg * seg_words;
  if (w0 >= nw) return;
  long long rank = base[seg];
  if (rank >= T) return;
  Lane ln = lane_start(st, w0 * 32 + lane);
  for (long long w = w0; w < w0 + seg_words && w < nw && rank < T; ++w) {
    const uint64_t r = lane_word(&ln);
    const unsigned em = mask[w];
    const long long mine = rank + __popc(em & ((1u << lane) - 1u));
    if (((em >> lane) & 1u) && mine < T && one_word(ki, r)) {
      const int idx = (int)(r & 0xff);
      double x = __dmul_rn(__ull2double_rn((r >> 9) & RFM_ZIG_MASK52),
                           wi[idx]);
      if ((r >> 8) & 1) x = -x;
      const float v = __double2float_rn(__dadd_rn(0.0, __dmul_rn(sigma, x)));
      if (mine < n0)
        out0[mine] = v;
      else
        out1[mine - n0] = v;
    }
    rank += __popc(em);
  }
}

unsigned grid(long long N, int seg_words) {
  const long long segs = ((N + 31) / 32 + seg_words - 1) / seg_words;
  return (unsigned)((segs * 32 + kThreads - 1) / kThreads);
}

}  // namespace

// The stream's state and increment as 64-bit halves; N positions (from the
// state's next word); segments of `seg_words` words. mask [ceil(N / 32)]
// u32, cnt [segments] i32. Returns a CUDA error code (0: enqueued on
// `stream`).
extern "C" int rfm_pcg_scan(unsigned long long s_hi, unsigned long long s_lo,
                            unsigned long long i_hi, unsigned long long i_lo,
                            long long N, int seg_words, unsigned* mask,
                            int* cnt, void* stream) {
  if (N < 1 || seg_words < 1) return (int)cudaErrorInvalidValue;
  scan_kernel<<<grid(N, seg_words), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      Stream{s_hi, s_lo, i_hi, i_lo}, N, seg_words, mask, cnt);
  return (int)cudaGetLastError();
}

// off [segments] i64: exclusive sums of `cnt`; rec [sum(cnt), 4] i64.
extern "C" int rfm_pcg_compact(unsigned long long s_hi,
                               unsigned long long s_lo,
                               unsigned long long i_hi,
                               unsigned long long i_lo, long long N,
                               int seg_words, const unsigned* mask,
                               const long long* off, long long* rec,
                               void* stream) {
  if (N < 1 || seg_words < 1) return (int)cudaErrorInvalidValue;
  compact_kernel<<<grid(N, seg_words), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      Stream{s_hi, s_lo, i_hi, i_lo}, N, seg_words, mask, off, rec);
  return (int)cudaGetLastError();
}

// mask: the emit mask; base [segments] i64: emits before each segment;
// ranks [0, n0) go to out0, [n0, T) to out1 at rank - n0.
extern "C" int rfm_pcg_emit(unsigned long long s_hi, unsigned long long s_lo,
                            unsigned long long i_hi, unsigned long long i_lo,
                            long long N, int seg_words, const unsigned* mask,
                            const long long* base, long long T, long long n0,
                            double sigma, float* out0, float* out1,
                            void* stream) {
  if (N < 1 || seg_words < 1 || n0 < 0 || n0 > T)
    return (int)cudaErrorInvalidValue;
  emit_kernel<<<grid(N, seg_words), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      Stream{s_hi, s_lo, i_hi, i_lo}, N, seg_words, mask, base, T, n0,
      sigma, out0, out1);
  return (int)cudaGetLastError();
}

extern "C" const char* rfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
