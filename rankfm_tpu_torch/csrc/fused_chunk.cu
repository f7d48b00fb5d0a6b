// Fused WARP/BPR chunk step for Hopper (sm_90a).
//
// Replaces the TPU kernel `rankfm_tpu/ops/fused.py:_kernel` (f32 tables,
// featureless and with side features, HAS_UF / HAS_IF). One batch is nT
// chunks of C rows; every row of a chunk shares one user block (UB rows) and
// one positive-item block (BLK items), and the chunk draws NW negative windows
// of BLK items. Chunks apply strictly in order, so the host loop below
// launches, per chunk, in stream order:
//
//   0. feature_reps (side features only), one thread per output element: the
//      chunk-start representations x_uf @ tab_uf of the user block's rows and
//      x_if @ tab_if of the positive block's and each window's items (col F of
//      an item representation is its feature bias x_if . w_if), skipping
//      zero features (one-hot and multi-hot columns are sparse). Computed
//      once per chunk instead of once per row and slot;
//   1. select_scatter, one block per row: score the row's NW*BLK window
//      slots against the chunk-start tables, decode window membership from
//      the blocked 16-bit history pack, make the closed-form WARP/BPR choice
//      (two block reductions: violator / non-member counts, then the key
//      maximum and its tie count), and atomically add the row's gradients
//      and touch counts into a per-chunk f32 accumulator; with side features
//      also the feature-table gradients and touch counts;
//   2. apply_updates, one thread per touched table row: the geometric
//      per-touch decay plus the accumulated gradient, in the fixed order
//      user block, positive block, then each window block (a block drawn
//      twice, or equal to the positive block, is updated once per
//      occurrence, in that order), zeroing the accumulator rows it used;
//   3. feature_update (side features only), one block per feature row: the
//      same decay at c = 1 - eta*2*beta, v_if and v_uf per their touch
//      counts, w_if per the chunk's count of rows with a negative.
//
// select_scatter is a template on the two feature flags: the featureless
// instantiation is the step without side features, unchanged.
//
// What bounds it on an H100: not FLOPs and not HBM. At ML-1M (F = 20) the
// tables are (6,144 + 4,096) rows x 22 x 4 B, about 0.9 MB, and live in L2;
// a chunk is ~5.8 MFLOP of window scoring. The bound is launch count and
// latency: two dependent launches per chunk (four with side features),
// ~3,000 chunks per epoch at C = 256 and twice that at C = 128. The design
// keeps each launch short (no host sync, no allocation inside the batch, all
// per-chunk indices read on the device) and issues a whole batch from one
// host call; fusing the chunk loop into one persistent kernel, or capturing
// it in a CUDA graph, is the next step. With item features every window
// slot reads two rows (its table row and its representation), so the
// scoring pass reads twice the bytes of the featureless one.
//
// Side features use the identity (reference FM, no uf x if term)
//   u_aug . (i + r_i) - r_u . r_i = u_aug . i + u . r_i,
// with u_aug = u + r_u: every utility is the augmented user row against the
// raw item row plus the raw user row against the item representation.
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

// The side-feature operands of one chunk (all null / 0 without features).
// feature_reps overwrites `rep_u` / `rep_i` every chunk; the gradients and
// counts are zero between chunks (feature_update re-zeroes what it reads).
struct Feat {
  const float* x_uf;  // [U_pad, P] user features
  const float* x_if;  // [I_pad, Q] item features
  float* tab_uf;      // [P, D]: v_uf, col F = 0
  float* tab_if;      // [Q, D]: v_if, col F = w_if
  int P, Q;
  float* rep_u;   // [UB, D] x_uf @ tab_uf of the chunk's user block
  float* rep_i;   // [(1 + NW) * BLK, D] x_if @ tab_if: positive block, windows
  float* g_uf;    // [P, D] gradient (cols < F)
  float* cnt_uf;  // [P] touch counts
  float* g_if;    // [Q, D] gradient (cols <= F)
  float* cnt_if;  // [Q] touch counts
  float* n_ok;    // this chunk's count of rows with a negative
};

template <bool UF, bool IF>
__global__ void __launch_bounds__(kThreads)
feature_reps(Feat f, int D, const int* __restrict__ blk,
             const int* __restrict__ ublk, const int* __restrict__ iblk,
             int UB, int BLK, int lg_blk, int NW) {
  const int nu = UF ? UB : 0;
  const int rows = nu + (IF ? (1 + NW) * BLK : 0);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * D) return;
  const int r = e / D, k = e % D;
  const float* x;
  const float* tab;
  float* out;
  int n;
  if (UF && r < nu) {
    x = f.x_uf + (size_t)(ublk[0] * UB + r) * f.P;
    tab = f.tab_uf;
    n = f.P;
    out = f.rep_u + (size_t)r * D;
  } else {
    const int rr = r - nu, q = rr >> lg_blk, j = rr & (BLK - 1);
    const int b = q == 0 ? iblk[0] : blk[q - 1];
    x = f.x_if + (size_t)(b * BLK + j) * f.Q;
    tab = f.tab_if;
    n = f.Q;
    out = f.rep_i + (size_t)rr * D;
  }
  float acc = 0.f;
  for (int c = 0; c < n; ++c) {
    const float xv = x[c];
    if (xv != 0.f) acc += xv * tab[(size_t)c * D + k];
  }
  out[k] = acc;
}

template <bool UF, bool IF>
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
               float mult_bpr, uint32_t seed, uint32_t chunk, Feat f) {
  constexpr bool FEAT = UF || IF;
  extern __shared__ float smem[];
  float* s_u = smem;          // [D] user row
  float* s_i = s_u + D;       // [D] positive row
  float* s_j = s_i + D;       // [D] sum of the chosen rows
  float* s_red = s_j + D;     // [32] reduction scratch
  float* s_key = s_red + 32;  // [NW*BLK] pw, then the selection key
  // side features only
  float* s_ua = s_key + NW * BLK;  // [D] augmented user row u + x_uf @ tab_uf
  float* s_ir = s_ua + D;          // [D] the positive's representation
  float* s_jr = s_ir + D;          // [D] sum of the chosen representations
  float* s_xj = s_jr + D;          // [Q] sum of the chosen slots' x_if rows

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
    if constexpr (FEAT) {
      s_ua[k] = s_u[k] + (UF ? f.rep_u[(size_t)u_loc * D + k] : 0.f);
      s_ir[k] = IF ? f.rep_i[(size_t)i_loc * D + k] : 0.f;
      s_jr[k] = 0.f;
    }
  }
  if constexpr (IF)
    for (int q = tid; q < f.Q; q += blockDim.x) s_xj[q] = 0.f;
  if (tid == 0) s_jmin = 0x7fffffff;
  __syncthreads();
  float ut_ui = 0.f;
  if constexpr (FEAT) {
    for (int k = 0; k < D; ++k) ut_ui += s_ua[k] * s_i[k] + s_u[k] * s_ir[k];
  } else {
    for (int k = 0; k < D; ++k) ut_ui += s_u[k] * s_i[k];
  }

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
      if constexpr (FEAT) {
        for (int k = 0; k < D; ++k) dot += s_ua[k] * r[k];
        if constexpr (IF) {
          const float* rr = f.rep_i + (size_t)(BLK + s) * D;
          for (int k = 0; k < D; ++k) dot += s_u[k] * rr[k];
        }
      } else {
        for (int k = 0; k < D; ++k) dot += s_u[k] * r[k];
      }
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
        const int item = blk[s >> lg_blk] * BLK + (s & (BLK - 1));
        const float* r = tab_i + (size_t)item * D;
        for (int k = 0; k < D; ++k) atomicAdd(&s_j[k], r[k]);
        if constexpr (IF) {
          const float* rr = f.rep_i + (size_t)(BLK + s) * D;
          for (int k = 0; k < D; ++k) atomicAdd(&s_jr[k], rr[k]);
          const float* xr = f.x_if + (size_t)item * f.Q;
          for (int q = 0; q < f.Q; ++q)
            if (xr[q] != 0.f) atomicAdd(&s_xj[q], xr[q]);
        }
      }
    }
  }
  cnt = block_reduce(cnt, s_red, false);  // its barriers publish s_j
  const float inv = cnt > 0.f ? 1.f / cnt : 0.f;
  float d = 0.f, ll = 0.f;
  if (cnt > 0.f) {
    float ut_uj = 0.f;
    if constexpr (FEAT) {
      for (int k = 0; k < D; ++k)
        ut_uj += s_ua[k] * (s_j[k] * inv) + s_u[k] * (s_jr[k] * inv);
    } else {
      for (int k = 0; k < D; ++k) ut_uj += s_u[k] * (s_j[k] * inv);
    }
    const float x = ut_ui - ut_uj;
    d = sw * mult / (1.f + expf(x));                  // sw*mult*sigmoid(-x)
    ll = fminf(x, 0.f) - log1pf(expf(-fabsf(x)));     // log sigmoid(x)
  }

  // scatter: user row (col F = touch count), positive row (col F = bias
  // gradient d, col F+1 = touch count), chosen window slots (share 1/cnt).
  // With side features the user gradient is d * (i_tot - j_tot) and the item
  // gradients carry the augmented user row (its col F is still 1).
  const float* s_uu = FEAT ? s_ua : s_u;
  float* au = acc_u + (size_t)u_loc * D;
  for (int k = tid; k <= F; k += blockDim.x) {
    float g = 1.f;
    if (k < F) {
      g = FEAT ? d * ((s_i[k] + s_ir[k]) - (s_j[k] + s_jr[k]) * inv)
               : d * (s_i[k] - s_j[k] * inv);
    }
    atomicAdd(&au[k], g);
  }
  float* ap = acc_p + (size_t)i_loc * D;
  for (int k = tid; k < D; k += blockDim.x)
    atomicAdd(&ap[k], k <= F ? d * s_uu[k] : 1.f);
  if (cnt > 0.f) {
    for (int s = tid; s < W2; s += blockDim.x) {
      if (s_key[s] == mx) {
        float* aw = acc_w + (size_t)s * D;
        for (int k = 0; k <= F; ++k) atomicAdd(&aw[k], -d * s_uu[k] * inv);
        atomicAdd(&aw[F + 1], inv);
      }
    }
  }
  if constexpr (FEAT) {
    // feature tables: one touch per row with a negative
    if (cnt > 0.f) {
      if (tid == 0) atomicAdd(f.n_ok, 1.f);
      if constexpr (IF) {
        // (x_if[i] - mean x_if[j]) (x) d * raw user row (col F: w_if)
        const float* xi = f.x_if + (size_t)i_abs * f.Q;
        for (int e = tid; e < f.Q * (F + 1); e += blockDim.x) {
          const int q = e / (F + 1), k = e % (F + 1);
          const float diff = xi[q] - s_xj[q] * inv;
          if (diff != 0.f) {
            atomicAdd(&f.g_if[(size_t)q * D + k], diff * (d * s_u[k]));
            if (k == 0) atomicAdd(&f.cnt_if[q], 1.f);
          }
        }
      }
      if constexpr (UF) {
        // x_uf[u] (x) d * (raw positive row - raw chosen row)
        const float* xu = f.x_uf + (size_t)u_abs * f.P;
        for (int e = tid; e < f.P * F; e += blockDim.x) {
          const int p = e / F, k = e % F;
          const float xv = xu[p];
          if (xv != 0.f) {
            atomicAdd(&f.g_uf[(size_t)p * D + k],
                      xv * (d * (s_i[k] - s_j[k] * inv)));
            if (k == 0) atomicAdd(&f.cnt_uf[p], 1.f);
          }
        }
      }
    }
  }
  if (tid == 0) {
    ll_rows[row] = ll;
    if (chosen) chosen[row] = cnt > 0.f ? s_jmin : -1;
  }
}

// the geometric per-touch decay over k touches, c = max(1 - dreg, 1e-8):
//   w <- c^k w + eta (1 - c^k) / (k (1 - c)) * sum(g)
__device__ __forceinline__ void decay_factors(float cnt, float eta, float cdec,
                                              float ldec, float* ck,
                                              float* gf) {
  *ck = expf(cnt * ldec);
  const float denom = cnt * (1.f - cdec);
  const float f = denom > 1e-12f ? (1.f - *ck) / fmaxf(denom, 1e-12f) : 1.f;
  *gf = eta * f;
}

__device__ __forceinline__ void decay_row(float* t, float* a, float cnt,
                                          int ncols, int D, float eta,
                                          float cdec, float ldec) {
  float ck, gf;
  decay_factors(cnt, eta, cdec, ldec, &ck, &gf);
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

// one block per feature row: rows [0, P) of tab_uf (UF), then [0, Q) of
// tab_if (IF). v_uf / v_if decay by the row's touch count, w_if (tab_if col
// F) by the chunk's count of rows with a negative; tab_uf col F stays 0.
template <bool UF, bool IF>
__global__ void __launch_bounds__(kThreads)
feature_update(Feat f, int D, int F, float eta, float dreg_f) {
  const float cdec = fmaxf(1.f - dreg_f, 1e-8f);
  const float ldec = logf(cdec);
  const int np = UF ? f.P : 0;
  const bool is_uf = UF && (int)blockIdx.x < np;
  const int r = is_uf ? blockIdx.x : blockIdx.x - np;
  float* t = (is_uf ? f.tab_uf : f.tab_if) + (size_t)r * D;
  float* g = (is_uf ? f.g_uf : f.g_if) + (size_t)r * D;
  float* cntp = (is_uf ? f.cnt_uf : f.cnt_if) + r;
  const float cnt = *cntp;
  const float n_ok = is_uf ? 0.f : *f.n_ok;
  __syncthreads();  // every thread has read the count before it is zeroed
  for (int k = threadIdx.x; k <= F; k += blockDim.x) {
    if (is_uf && k == F) {
      t[k] = 0.f;
      continue;
    }
    float ck, gf;
    decay_factors(k == F ? n_ok : cnt, eta, cdec, ldec, &ck, &gf);
    t[k] = t[k] * ck + gf * g[k];
    g[k] = 0.f;
  }
  if (threadIdx.x == 0) *cntp = 0.f;
}

int ilog2(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

template <bool UF, bool IF>
int run_batch(float* tab_u, float* tab_i, int D, int F, const int* rec,
              const int* packed, int W, const int* blk, const int* ublk,
              const int* iblk, float* acc, float* ll_rows, int* chosen,
              int nT, int C, int UB, int BLK, int NW, int M, float nm1,
              float log_I, float mult_bpr, uint32_t seed, float eta,
              float dreg, Feat f, float* facc, float dreg_f,
              cudaStream_t st) {
  constexpr bool FEAT = UF || IF;
  const int lg_blk = ilog2(BLK), lg_lw = ilog2(BLK >> 4);
  size_t smem = (size_t)(3 * D + 32 + NW * BLK) * sizeof(float);
  if constexpr (FEAT) smem += (size_t)(3 * D + f.Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      select_scatter<UF, IF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  float* acc_u = acc;
  float* acc_p = acc_u + (size_t)UB * D;
  float* acc_w = acc_p + (size_t)BLK * D;
  const int apply_blocks = (UB + (1 + NW) * BLK + kThreads - 1) / kThreads;
  float* n_ok = nullptr;
  int rep_blocks = 0;
  if constexpr (FEAT) {
    // facc: rep_u [nu * D], rep_i [ni * D], g_uf [P * D], cnt_uf [P],
    // g_if [Q * D], cnt_if [Q], n_ok [nT]
    const int nu = UF ? UB : 0, ni = IF ? (1 + NW) * BLK : 0;
    f.rep_u = facc;
    f.rep_i = f.rep_u + (size_t)nu * D;
    f.g_uf = f.rep_i + (size_t)ni * D;
    f.cnt_uf = f.g_uf + (size_t)f.P * D;
    f.g_if = f.cnt_uf + f.P;
    f.cnt_if = f.g_if + (size_t)f.Q * D;
    n_ok = f.cnt_if + f.Q;
    rep_blocks = ((nu + ni) * D + kThreads - 1) / kThreads;
  }
  for (int k = 0; k < nT; ++k) {
    if constexpr (FEAT) {
      f.n_ok = n_ok + k;
      feature_reps<UF, IF><<<rep_blocks, kThreads, 0, st>>>(
          f, D, blk + (size_t)k * NW, ublk + k, iblk + k, UB, BLK, lg_blk,
          NW);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    select_scatter<UF, IF><<<C, kThreads, smem, st>>>(
        tab_u, tab_i, D, F, rec + (size_t)2 * k * C, packed, W,
        blk + (size_t)k * NW, ublk + k, iblk + k, acc_u, acc_p, acc_w,
        ll_rows + (size_t)k * C, chosen ? chosen + (size_t)k * C : nullptr,
        UB, BLK, lg_blk, lg_lw, NW, M, nm1, log_I,
        mult_bpr, seed, (uint32_t)k, f);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    apply_updates<<<apply_blocks, kThreads, 0, st>>>(
        tab_u, tab_i, D, F, acc_u, acc_p, acc_w, blk + (size_t)k * NW,
        ublk + k, iblk + k, UB, BLK, lg_blk, NW, eta, dreg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if constexpr (FEAT) {
      feature_update<UF, IF><<<(UF ? f.P : 0) + (IF ? f.Q : 0), kThreads, 0,
                               st>>>(f, D, F, eta, dreg_f);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

}  // namespace

// One batch of nT chunks, launched on `stream` in chunk order. `acc` is a
// zeroed f32 scratch of (UB + (1 + NW) * BLK) * D floats (zero again on
// return); `ll_rows` gets each row's log-likelihood term and, when not null,
// `chosen` each row's lowest chosen window slot (-1: none).
//
// Side features: `x_uf` [U_pad, P] with `tab_uf` [P, D] and/or `x_if`
// [I_pad, Q] with `tab_if` [Q, D] (null and 0 when absent); `facc` is then a
// zeroed f32 scratch of (nu + ni + P + Q) * D + P + Q + nT floats, nu = UB
// with user features, ni = (1 + NW) * BLK with item features; `dreg_f` is
// eta * 2 * beta. The feature tables are updated in place.
//
// Returns the first CUDA error of any launch, 0 when every launch was
// accepted.
extern "C" int rfm_fused_batch(float* tab_u, float* tab_i, int D, int F,
                               const int* rec, const int* packed, int W,
                               const int* blk, const int* ublk,
                               const int* iblk, float* acc, float* ll_rows,
                               int* chosen,
                               int nT, int C, int UB, int BLK, int NW, int M,
                               float nm1, float log_I, float mult_bpr,
                               unsigned int seed, float eta, float dreg,
                               const float* x_uf, const float* x_if,
                               float* tab_uf, float* tab_if, int P, int Q,
                               float* facc, float dreg_f, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Feat f = {};
  f.x_uf = x_uf;
  f.x_if = x_if;
  f.tab_uf = tab_uf;
  f.tab_if = tab_if;
  f.P = x_uf ? P : 0;
  f.Q = x_if ? Q : 0;
#define RFM_RUN(UF, IF)                                                    \
  run_batch<UF, IF>(tab_u, tab_i, D, F, rec, packed, W, blk, ublk, iblk,   \
                    acc, ll_rows, chosen, nT, C, UB, BLK, NW, M, nm1,      \
                    log_I, mult_bpr, seed, eta, dreg, f, facc, dreg_f, st)
  if (x_uf && x_if) return RFM_RUN(true, true);
  if (x_uf) return RFM_RUN(true, false);
  if (x_if) return RFM_RUN(false, true);
  return RFM_RUN(false, false);
#undef RFM_RUN
}

extern "C" const char* rfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
