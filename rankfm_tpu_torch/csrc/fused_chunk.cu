// Fused WARP/BPR chunk step for Hopper (sm_90a).
//
// Replaces the TPU kernel `rankfm_tpu/ops/fused.py:_kernel` (featureless,
// f32 tables). One batch is nT chunks of C rows; every row of a chunk shares
// one user block (UB rows) and one positive-item block (BLK items), and the
// chunk draws NW negative windows of BLK items. Chunks apply strictly in
// order, so the host loop below launches, per chunk, in stream order:
//
//   1. select_scatter, one block per row: score the row's NW*BLK window
//      slots against the chunk-start tables, decode window membership from
//      the blocked 16-bit history pack, make the closed-form WARP/BPR choice
//      (two block reductions: violator / non-member counts, then the key
//      maximum and its tie count), and atomically add the row's gradients
//      and touch counts into a per-chunk f32 accumulator;
//   2. apply_updates, one thread per touched table row: the geometric
//      per-touch decay plus the accumulated gradient, in the fixed order
//      user block, positive block, then each window block (a block drawn
//      twice, or equal to the positive block, is updated once per
//      occurrence, in that order), zeroing the accumulator rows it used.
//
// What bounds it on an H100: not FLOPs and not HBM. At ML-1M (F = 20) the
// tables are (6,144 + 4,096) rows x 22 x 4 B, about 0.9 MB, and live in L2;
// a chunk is ~5.8 MFLOP of window scoring. The bound is launch count and
// latency: two dependent launches per chunk, ~3,000 chunks per epoch at
// C = 256 and twice that at C = 128. The design keeps each launch short
// (no host sync, no allocation inside the batch, all per-chunk indices read
// on the device) and issues a whole batch from one host call; fusing the
// chunk loop into one persistent kernel, or capturing it in a CUDA graph,
// is the next step.
//
// Random draws: Philox4x32-10 keyed by (batch seed, 0) with the counter
// (slot, row, chunk, stream), stream 0 for the slot uniforms and 1 for the
// per-row geometric draw; `rankfm_tpu_torch/ops/_philox.py` computes the
// same bits in PyTorch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kMargin = 1.0f;

__device__ __forceinline__ uint32_t philox_word(uint32_t c0, uint32_t c1,
                                                uint32_t c2, uint32_t c3,
                                                uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return c0;
}

// top 24 bits scaled to [0, 1): exact in f32
__device__ __forceinline__ float to_u01(uint32_t bits) {
  return (float)(bits >> 8) * 5.9604644775390625e-08f;
}

// block-wide sum (is_max = false) or max (true); every thread gets the result
__device__ float block_reduce(float v, float* red, bool is_max) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float t = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, t) : v + t;
  }
  __syncthreads();  // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    v = is_max ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

__global__ void __launch_bounds__(kThreads)
select_scatter(const float* __restrict__ tab_u, const float* __restrict__ tab_i,
               int D, int F, const int* __restrict__ rec,
               const int* __restrict__ packed, int W,
               const int* __restrict__ blk, const int* __restrict__ ublk,
               const int* __restrict__ iblk, float* __restrict__ acc_u,
               float* __restrict__ acc_p, float* __restrict__ acc_w,
               float* __restrict__ ll_rows, int* __restrict__ chosen, int UB,
               int BLK, int lg_blk,
               int lg_lw, int NW, int M, float nm1, float log_I,
               float mult_bpr, uint32_t seed, uint32_t chunk) {
  extern __shared__ float smem[];
  float* s_u = smem;          // [D] user row
  float* s_i = s_u + D;       // [D] positive row
  float* s_j = s_i + D;       // [D] sum of the chosen rows
  float* s_red = s_j + D;     // [32] reduction scratch
  float* s_key = s_red + 32;  // [NW*BLK] pw, then the selection key

  __shared__ int s_jmin;       // lowest chosen slot
  const int row = blockIdx.x, tid = threadIdx.x;
  const int p0 = rec[2 * row];
  if (!((p0 >> 21) & 1)) {  // guard record: no reads, no updates
    if (tid == 0) {
      ll_rows[row] = 0.f;
      if (chosen) chosen[row] = -1;
    }
    return;
  }
  const float sw = __int_as_float(rec[2 * row + 1]);
  const int u_loc = p0 & 1023;
  const int i_loc = ((p0 >> 10) & 2047) - 1;
  const int u_abs = ublk[0] * UB + u_loc;
  const int i_abs = iblk[0] * BLK + i_loc;
  for (int k = tid; k < D; k += blockDim.x) {
    s_u[k] = tab_u[(size_t)u_abs * D + k];
    s_i[k] = tab_i[(size_t)i_abs * D + k];
    s_j[k] = 0.f;
  }
  if (tid == 0) s_jmin = 0x7fffffff;
  __syncthreads();
  float ut_ui = 0.f;
  for (int k = 0; k < D; ++k) ut_ui += s_u[k] * s_i[k];

  // pass 1: membership and pairwise utility of every window slot
  const int W2 = NW * BLK, LW = BLK >> 4;
  const int* prow = packed + (size_t)u_abs * W;
  float nv = 0.f, nn = 0.f;
  for (int s = tid; s < W2; s += blockDim.x) {
    const int b = blk[s >> lg_blk], j = s & (BLK - 1);
    const int word = prow[b * LW + (j & (LW - 1))];
    float pw = NAN;  // NaN marks a member (never a negative)
    if (!((word >> (j >> lg_lw)) & 1)) {
      const float* r = tab_i + (size_t)(b * BLK + j) * D;
      float dot = 0.f;
      for (int k = 0; k < D; ++k) dot += s_u[k] * r[k];
      pw = ut_ui - dot;
      nn += 1.f;
      nv += (pw < kMargin) ? 1.f : 0.f;
    }
    s_key[s] = pw;
  }
  nv = block_reduce(nv, s_red, false);
  nn = block_reduce(nn, s_red, false);

  // closed-form WARP draw (BPR: M == 1, a uniform non-member)
  float mult = mult_bpr, pthr = 0.f;
  bool found = false;
  if (M > 1) {
    const float r1 = to_u01(philox_word(0u, (uint32_t)row, chunk, 1u, seed, 0u));
    const float p_c = fminf(fmaxf(nv / fmaxf(nn, 1.f), 1e-9f), 1.f - 1e-7f);
    float geo = floorf(logf(fmaxf(1.f - r1, 1e-30f)) / logf(1.f - p_c)) + 1.f;
    if (!(nv > 0.f)) geo = (float)M;
    found = (nv > 0.f) && (geo <= (float)M);
    const float sampled = fminf(geo, (float)M);
    pthr = (float)M / fmaxf(nn, 1.f);
    mult = logf(fmaxf(floorf(nm1 / sampled), 1.f)) / log_I;
  }

  // pass 2: selection key of every slot, and its maximum
  float mx = -INFINITY;
  for (int s = tid; s < W2; s += blockDim.x) {
    const float pw = s_key[s];
    float key = -INFINITY;
    if (!isnan(pw)) {
      const float u = to_u01(
          philox_word((uint32_t)s, (uint32_t)row, chunk, 0u, seed, 0u));
      const bool viol = pw < kMargin;
      if (M == 1)
        key = u;
      else if (found)
        key = viol ? u : -INFINITY;
      else if (!viol)
        key = -pw - (u >= pthr ? 1e6f : 0.f);
    }
    s_key[s] = key;
    mx = fmaxf(mx, key);
  }
  mx = block_reduce(mx, s_red, true);

  // pass 3: the chosen slots (exact ties split evenly) and their mean row
  float cnt = 0.f;
  if (mx > -INFINITY) {
    for (int s = tid; s < W2; s += blockDim.x) {
      if (s_key[s] == mx) {
        cnt += 1.f;
        atomicMin(&s_jmin, s);
        const float* r =
            tab_i + (size_t)(blk[s >> lg_blk] * BLK + (s & (BLK - 1))) * D;
        for (int k = 0; k < D; ++k) atomicAdd(&s_j[k], r[k]);
      }
    }
  }
  cnt = block_reduce(cnt, s_red, false);  // its barriers publish s_j
  const float inv = cnt > 0.f ? 1.f / cnt : 0.f;
  float d = 0.f, ll = 0.f;
  if (cnt > 0.f) {
    float ut_uj = 0.f;
    for (int k = 0; k < D; ++k) ut_uj += s_u[k] * (s_j[k] * inv);
    const float x = ut_ui - ut_uj;
    d = sw * mult / (1.f + expf(x));                  // sw*mult*sigmoid(-x)
    ll = fminf(x, 0.f) - log1pf(expf(-fabsf(x)));     // log sigmoid(x)
  }

  // scatter: user row (col F = touch count), positive row (col F = bias
  // gradient d, col F+1 = touch count), chosen window slots (share 1/cnt)
  float* au = acc_u + (size_t)u_loc * D;
  for (int k = tid; k <= F; k += blockDim.x)
    atomicAdd(&au[k], k < F ? d * (s_i[k] - s_j[k] * inv) : 1.f);
  float* ap = acc_p + (size_t)i_loc * D;
  for (int k = tid; k < D; k += blockDim.x)
    atomicAdd(&ap[k], k <= F ? d * s_u[k] : 1.f);
  if (cnt > 0.f) {
    for (int s = tid; s < W2; s += blockDim.x) {
      if (s_key[s] == mx) {
        float* aw = acc_w + (size_t)s * D;
        for (int k = 0; k <= F; ++k) atomicAdd(&aw[k], -d * s_u[k] * inv);
        atomicAdd(&aw[F + 1], inv);
      }
    }
  }
  if (tid == 0) {
    ll_rows[row] = ll;
    if (chosen) chosen[row] = cnt > 0.f ? s_jmin : -1;
  }
}

__device__ __forceinline__ void decay_row(float* t, float* a, float cnt,
                                          int ncols, int D, float eta,
                                          float cdec, float ldec) {
  const float ck = expf(cnt * ldec);
  const float denom = cnt * (1.f - cdec);
  const float f = denom > 1e-12f ? (1.f - ck) / fmaxf(denom, 1e-12f) : 1.f;
  const float gf = eta * f;
  for (int k = 0; k < ncols; ++k) t[k] = t[k] * ck + gf * a[k];
  for (int k = 0; k < D; ++k) a[k] = 0.f;
}

__global__ void __launch_bounds__(kThreads)
apply_updates(float* __restrict__ tab_u, float* __restrict__ tab_i, int D,
              int F, float* __restrict__ acc_u, float* __restrict__ acc_p,
              float* __restrict__ acc_w, const int* __restrict__ blk,
              const int* __restrict__ ublk, const int* __restrict__ iblk,
              int UB, int BLK, int lg_blk, int NW, float eta, float dreg) {
  const float cdec = fmaxf(1.f - dreg, 1e-8f);
  const float ldec = logf(cdec);
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < UB) {  // user row: factors only, col F stays 1
    float* a = acc_u + (size_t)p * D;
    if (a[F] != 0.f)
      decay_row(tab_u + (size_t)(ublk[0] * UB + p) * D, a, a[F], F, D, eta,
                cdec, ldec);
    return;
  }
  p -= UB;
  if (p >= (1 + NW) * BLK) return;
  // occurrence q0 of the block list [positive, window 0, ..., window NW-1];
  // the thread of a block's FIRST occurrence applies all its occurrences
  const int q0 = p >> lg_blk, r = p & (BLK - 1);
  const int b = q0 == 0 ? iblk[0] : blk[q0 - 1];
  for (int q = 0; q < q0; ++q)
    if ((q == 0 ? iblk[0] : blk[q - 1]) == b) return;
  float* t = tab_i + (size_t)(b * BLK + r) * D;
  for (int q = q0; q <= NW; ++q) {
    if ((q == 0 ? iblk[0] : blk[q - 1]) != b) continue;
    float* a = (q == 0 ? acc_p : acc_w + (size_t)(q - 1) * BLK * D) +
               (size_t)r * D;
    if (a[F + 1] != 0.f)  // factors and bias, col F+1 stays 0
      decay_row(t, a, a[F + 1], F + 1, D, eta, cdec, ldec);
  }
}

int ilog2(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

}  // namespace

// One batch of nT chunks, launched on `stream` in chunk order. `acc` is a
// zeroed f32 scratch of (UB + (1 + NW) * BLK) * D floats (zero again on
// return); `ll_rows` gets each row's log-likelihood term and, when not null,
// `chosen` each row's lowest chosen window slot (-1: none). Returns the first
// CUDA error of any launch, 0 when every launch was accepted.
extern "C" int rfm_fused_batch(float* tab_u, float* tab_i, int D, int F,
                               const int* rec, const int* packed, int W,
                               const int* blk, const int* ublk,
                               const int* iblk, float* acc, float* ll_rows,
                               int* chosen,
                               int nT, int C, int UB, int BLK, int NW, int M,
                               float nm1, float log_I, float mult_bpr,
                               unsigned int seed, float eta, float dreg,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lg_blk = ilog2(BLK), lg_lw = ilog2(BLK >> 4);
  const size_t smem = (size_t)(3 * D + 32 + NW * BLK) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      select_scatter, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  float* acc_u = acc;
  float* acc_p = acc_u + (size_t)UB * D;
  float* acc_w = acc_p + (size_t)BLK * D;
  const int apply_blocks = (UB + (1 + NW) * BLK + kThreads - 1) / kThreads;
  for (int k = 0; k < nT; ++k) {
    select_scatter<<<C, kThreads, smem, st>>>(
        tab_u, tab_i, D, F, rec + (size_t)2 * k * C, packed, W,
        blk + (size_t)k * NW, ublk + k, iblk + k, acc_u, acc_p, acc_w,
        ll_rows + (size_t)k * C, chosen ? chosen + (size_t)k * C : nullptr,
        UB, BLK, lg_blk, lg_lw, NW, M, nm1, log_I,
        mult_bpr, seed, (uint32_t)k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    apply_updates<<<apply_blocks, kThreads, 0, st>>>(
        tab_u, tab_i, D, F, acc_u, acc_p, acc_w, blk + (size_t)k * NW,
        ublk + k, iblk + k, UB, BLK, lg_blk, NW, eta, dreg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" const char* rfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
