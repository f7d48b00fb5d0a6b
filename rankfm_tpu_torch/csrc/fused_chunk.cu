// Fused WARP/BPR chunk step for Hopper (sm_90a).
//
// Replaces the TPU kernel `rankfm_tpu/ops/fused.py:_kernel` (f32 tables,
// featureless and with side features, HAS_UF / HAS_IF). One batch is nT
// chunks of C rows; every row of a chunk shares one user block (UB rows) and
// one positive-item block (BLK items), and the chunk draws NW negative windows
// of BLK items. Chunks apply strictly in order.
//
// One batch is ONE cooperative launch of `fused_batch_kernel<UF, IF>`: a
// persistent grid (kBlocksPerSM blocks on every SM) walks the chunks, and
// inside a chunk the phases below, each a grid-stride loop, with a grid-wide
// barrier (`cooperative_groups::this_grid().sync()`) after every phase:
//
//   0. feature_reps (side features only), one warp per row: the chunk-start
//      representations x_uf @ tab_uf of the user block's rows and
//      x_if @ tab_if of the positive block's and each window's items (col F of
//      an item representation is its feature bias x_if . w_if). The lanes
//      read the row's features, a ballot finds the nonzero ones (one-hot and
//      multi-hot rows have few), and each adds its feature-table row with the
//      lanes over the columns;
//   1. score_tiles: all rows of a chunk score the same NW*BLK window slots,
//      so the scoring is one [C x K] . [K x NW*BLK] product, cut into tiles
//      of kTM rows x kTN slots. A block stages its user rows, their positive
//      rows and its window rows in shared memory in depth steps of kKT
//      (coalesced loads, row stride kKS = kKT + 4 words, which makes the
//      16-byte reads of 8 neighbouring rows hit 32 different banks); each
//      thread owns a 2 x 4 register tile and accumulates over k ascending in
//      f32 FMA, and sums ut_ui of its rows in the same order in every tile.
//      The epilogue decodes window membership from the blocked 16-bit
//      history pack, stores pw = ut_ui - dot (NaN for a member) into the
//      scratch `pw [C, NW*BLK]` (it stays in L2), and adds the row's
//      non-member and violator counts, as integers, to `cnt` (one atomic
//      pair per row and tile: the sums do not depend on the order). With
//      item features the product has depth K = 2D: [u_aug | u] . [i | r_i];
//   2. select_scatter, one block per row: read the row's pw and its counts,
//      make the closed-form WARP/BPR choice (Philox draws only for the slots
//      whose key can be finite; one block reduction for the key maximum; the
//      slots at the maximum are listed in ascending order by ballots and one
//      prefix over the warps, and their rows summed in a fixed order), and
//      atomically add the row's gradients and touch counts into a per-chunk
//      fixed-point accumulator; with side features also the feature-table
//      gradients and touch counts;
//   3. apply_updates, one warp per table row of the user block, the
//      positive block and the window blocks, lanes over the columns (a warp
//      reads the touch counts of its few rows together; most are zero): the
//      geometric per-touch decay plus the accumulated gradient, in the fixed
//      order user block, positive block, then each window block (a block
//      drawn twice, or equal to the positive block, is updated once per
//      occurrence, in that order, by the warp of its first occurrence),
//      zeroing the accumulator rows it used; in the same phase
//      feature_update, one warp per feature row: the same decay at
//      c = 1 - eta*2*beta, v_if and v_uf per their touch counts, w_if per
//      the chunk's count of rows with a negative.
//
// What bounds it on an H100: neither FLOPs nor HBM. A chunk is 11.5 MFLOP
// (ML-1M: C 256, 1,024 slots, D 22) to 109 MFLOP (Instacart with item
// features: C 128, 4,096 slots, K 104) over ~1 MB of tables that live in
// L2: 0.2-1.6 us at the f32 FMA peak, while chunks must apply in order. The
// bound is the latency of a chunk's dependent steps: three grid barriers
// (four with side features; 1.3-1.4 us each on an H100 at 264 blocks,
// against 3.8-4.5 us for an empty dependent launch from a host loop) and,
// inside each phase, a chain of round trips to L2 (records, then rows, then
// the rows they point to). The design therefore (a) scores every window row
// once per row tile from shared memory instead of once per row from L2,
// (b) keeps every global access coalesced (lanes over k when staging, over
// slots in the epilogue, over columns in the gathers and the updates),
// (c) sends the independent loads of a step out together (unconditional
// `ld.global` at clamped addresses, masked when used: a load inside a branch,
// or a generic load between shared stores, waits for the one before it), and
// (d) launches nothing per chunk: the host enqueues one kernel per batch.
// Two blocks per SM (128 registers a thread) give every row of a 256-row
// chunk its own block in the selection; one or three blocks per SM, and
// tiles of 128 slots, measured slower at every shape.
//
// Every sum is taken in an order fixed by the inputs, so a batch's output is
// a function of its inputs alone, bit for bit, run after run: a block's sums
// over the chosen slots run in slot order, and what several blocks add into
// one accumulator element is quantised to 64-bit fixed point (scale 2^32:
// 2.3e-10 resolution) and added with integer atomics, whose sum does not
// depend on their order. An addend beyond `fix_lim` = 2^30 / C (so that the
// C rows of a chunk cannot overflow an element) or not finite is not added:
// the row's ll term becomes NaN, which the fit's divergence check reports.
// The touch counts are whole numbers in f32 and exact in any order. (With f32
// atomics a near-tie of the selection could flip from one run to the next and
// move a table row by several percent.)
//
// No tensor cores: after tiling the chunk is latency-bound, and TF32 or bf16
// `wgmma` keeps about three digits, while the selection turns on pw < 1 and
// on exact key maxima that the plain PyTorch version must reproduce (equal
// negatives up to near-ties of 1e-5). Tables, scores and sums stay f32.
//
// The tables, the representations and the scratch change inside the launch,
// so they are read with `__ldcg` (ld.global.cg: coherent in L2, and known to
// the compiler not to alias shared memory) and never through `__restrict__`
// or `__ldg`; only the records, the history pack, the block ids and the
// feature matrices are read-only.
//
// Side features use the identity (reference FM, no uf x if term)
//   u_aug . (i + r_i) - r_u . r_i = u_aug . i + u . r_i,
// with u_aug = u + r_u: every utility is the augmented user row against the
// raw item row plus the raw user row against the item representation.
//
// Random draws: Philox4x32-10 keyed by (batch seed, 0) with the counter
// (slot, row, chunk, stream), stream 0 for the slot uniforms and 1 for the
// per-row geometric draw; `rankfm_tpu_torch/ops/_philox.py` computes the
// same bits in PyTorch. A draw that cannot change a key is skipped: the
// counters make that unobservable.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#if !defined(RFM_UF) || !defined(RFM_IF)
#error "compile with -DRFM_UF=0|1 -DRFM_IF=0|1: one kernel instantiation a library"
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 2;  // persistent blocks per SM (if they fit)
constexpr int kTM = 32;          // rows of a score tile
constexpr int kTN = 64;          // window slots of a score tile
constexpr int kRT = kTM / 16;    // rows of a thread's register tile
constexpr int kCT = kTN / 16;    // slots of a thread's register tile
constexpr int kKT = 32;          // depth of one staging step
constexpr int kKS = kKT + 4;     // shared-memory row stride in words
constexpr int kMaxNW = 64;       // windows per chunk the kernel takes
constexpr int kApplyRows = 4;    // rows whose counts a warp reads together
constexpr float kMargin = 1.0f;
constexpr float kFix = 4294967296.0f;               // 2^32, the fixed point
constexpr float kUnfix = 2.3283064365386963e-10f;   // 2^-32

static_assert(kThreads == 16 * 16, "16 x 16 threads over a score tile");

__device__ __forceinline__ uint32_t philox_word(uint32_t c0, uint32_t c1,
                                                uint32_t c2, uint32_t c3,
                                                uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    // one 32 x 32 -> 64-bit multiply gives both words
    const uint64_t p0 = (uint64_t)0xD2511F53u * c0;
    const uint64_t p1 = (uint64_t)0xCD9E8D57u * c2;
    const uint32_t hi0 = (uint32_t)(p0 >> 32), lo0 = (uint32_t)p0;
    const uint32_t hi1 = (uint32_t)(p1 >> 32), lo1 = (uint32_t)p1;
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

__device__ __forceinline__ float unfix(unsigned long long v) {
  return __ll2float_rn((long long)v) * kUnfix;
}

// block-wide maximum; every thread gets the result
__device__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = fmaxf(v, red[w]);
  return v;
}

// The side-feature operands (all null / 0 without features). feature_reps
// overwrites `rep_u` / `rep_i` every chunk; the gradients and counts are
// zero between chunks (feature_update re-zeroes what it reads).
struct Feat {
  const float* x_uf;  // [U_pad, P] user features
  const float* x_if;  // [I_pad, Q] item features
  float* tab_uf;      // [P, D]: v_uf, col F = 0
  float* tab_if;      // [Q, D]: v_if, col F = w_if
  int P, Q;
  float* rep_u;   // [UB, D] x_uf @ tab_uf of the chunk's user block
  float* rep_i;   // [(1 + NW) * BLK, D] x_if @ tab_if: positive block, windows
  unsigned long long* g_uf;  // [P, D] gradient (cols < F), fixed point
  float* cnt_uf;  // [P] touch counts
  unsigned long long* g_if;  // [Q, D] gradient (cols <= F), fixed point
  float* cnt_if;  // [Q] touch counts
  float* n_ok;    // [nT] each chunk's count of rows with a negative
};

// Everything one batch needs; `rec`, `blk`, `ublk`, `iblk`, `ll_rows` and
// `chosen` are the batch's arrays, indexed by chunk inside the kernel.
struct Args {
  float* tab_u;
  float* tab_i;
  int D, F;
  const int* rec;
  const int* packed;
  int W;
  const int* blk;
  const int* ublk;
  const int* iblk;
  unsigned long long* acc_u;  // [UB, D] fixed point (2^32)
  unsigned long long* acc_p;  // [BLK, D]
  unsigned long long* acc_w;  // [NW * BLK, D]
  float fix_lim;              // the largest addend |x| taken
  float* ll_rows;
  int* chosen;
  int nT, C, UB, BLK, lg_blk, lg_lw, NW, M;
  float nm1, log_I, mult_bpr;
  uint32_t seed;
  float eta, dreg, dreg_f;
  float* pw;  // [C, NW * BLK] pairwise utilities of the chunk, then ut_ui [C]
  int* cnt;   // [2, C] non-member / violator counts, zero between chunks
  unsigned long long* phase_ns;  // null, or [4] ns summed by phase
  Feat f;
};

// One chunk's view of the batch arrays.
struct Chunk {
  const int* rec;  // [C, 2]
  const int* blk;  // [NW]
  int ub;          // first row of the user block
  int ib;          // first row of the positive block
  uint32_t k;
};

__device__ __forceinline__ Chunk chunk_of(const Args& a, int k) {
  Chunk c;
  c.rec = a.rec + (size_t)2 * k * a.C;
  c.blk = a.blk + (size_t)k * a.NW;
  c.ub = a.ublk[k] * a.UB;
  c.ib = a.iblk[k] * a.BLK;
  c.k = (uint32_t)k;
  return c;
}

// One warp per representation row: the lanes read the row's features, the
// nonzero ones are found with a ballot (one-hot and multi-hot rows have few),
// and each adds its feature-table row with the lanes over the columns
// (D <= 128: four columns a lane), features ascending.
template <bool UF, bool IF>
__device__ void feature_reps(const Args& a, const Chunk& c) {
  const Feat& f = a.f;
  const int D = a.D;
  const int nu = UF ? a.UB : 0;
  const int rows = nu + (IF ? (1 + a.NW) * a.BLK : 0);
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5);
  for (int r = gw; r < rows; r += gridDim.x * kWarps) {
    const float* x;
    const float* tab;
    float* out;
    int n;
    if (UF && r < nu) {
      x = f.x_uf + (size_t)(c.ub + r) * f.P;
      tab = f.tab_uf;
      n = f.P;
      out = f.rep_u + (size_t)r * D;
    } else {
      const int rr = r - nu, q = rr >> a.lg_blk, j = rr & (a.BLK - 1);
      const int b = q == 0 ? c.ib : c.blk[q - 1] * a.BLK;
      x = f.x_if + (size_t)(b + j) * f.Q;
      tab = f.tab_if;
      n = f.Q;
      out = f.rep_i + (size_t)rr * D;
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q0 = 0; q0 < n; q0 += 32) {
      const float xv = q0 + lane < n ? __ldg(x + q0 + lane) : 0.f;
      unsigned mask = __ballot_sync(0xffffffffu, xv != 0.f);
      while (mask) {
        const int bit = __ffs(mask) - 1;
        mask &= mask - 1;
        const float v = __shfl_sync(0xffffffffu, xv, bit);
        const float* trow = tab + (size_t)(q0 + bit) * D;
#pragma unroll
        for (int it = 0; it < 4; ++it)
          if (lane + 32 * it < D) acc[it] += v * __ldcg(trow + lane + 32 * it);
      }
    }
#pragma unroll
    for (int it = 0; it < 4; ++it)
      if (lane + 32 * it < D) out[lane + 32 * it] = acc[it];
  }
}

// The chunk's window scoring, one tile of kTM rows x kTN slots per block and
// loop step. Operands of depth K (D, or 2D with item features):
//   A[m] = [u_aug | u]   the tile's user rows (u_aug = u + rep_u with UF)
//   P[m] = [i | r_i]     their positive rows: ut_ui[m] = A[m] . P[m]
//   B[n] = [w | r_w]     the tile's window rows: dot[m][n] = A[m] . B[n]
// Thread (ty, tx) owns rows ty + 16i (i < kRT) and slots tx + 16j (j < kCT).
// A chunk is a chain of dependent round trips to L2, so the loads are
// arranged to keep the chain short: the window rows do not wait for the
// records; the user rows, positive rows and history words of a tile go out
// together; the next depth step's loads fly during this step's arithmetic.
template <bool UF, bool IF>
__device__ void score_tiles(const Args& a, const Chunk& c, float* smem) {
  const int D = a.D, C = a.C, W2 = a.NW * a.BLK, LW = a.BLK >> 4;
  const int K = IF ? 2 * D : D;
  float* As = smem;            // [kTM][kKS]
  float* Ps = As + kTM * kKS;  // [kTM][kKS]
  float* Bs = Ps + kTM * kKS;  // [kTN][kKS]
  int* s_ul = reinterpret_cast<int*>(Bs + kTN * kKS);  // [kTM] u_loc, -1: guard
  int* s_il = s_ul + kTM;                              // [kTM] i_loc
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n_mt = (C + kTM - 1) / kTM, n_nt = W2 / kTN;
  constexpr int kNA = kTM * kKT / kThreads, kNB = kTN * kKT / kThreads;
  for (int tile = blockIdx.x; tile < n_mt * n_nt; tile += gridDim.x) {
    const int m0 = (tile / n_nt) * kTM, s0 = (tile % n_nt) * kTN;
    const int b = c.blk[s0 >> a.lg_blk], j0 = s0 & (a.BLK - 1);
    float av[kNA], pv[kNA], bv[kNB];
    // every load is an unconditional `ld.global` at a clamped address, masked
    // when it is stored: nothing keeps the loads of a step from going out
    // together. A warp reads 32 consecutive k of one row.
    auto load_b = [&](int k0) {
#pragma unroll
      for (int it = 0; it < kNB; ++it) {
        const int e = tid + it * kThreads;
        const int n = e / kKT, g = k0 + e % kKT;
        const bool lo = !IF || g < D;  // first half: table rows
        const int gk = min(lo ? g : g - D, D - 1);
        bv[it] = __ldcg(lo ? a.tab_i + (size_t)(b * a.BLK + j0 + n) * D + gk
                           : a.f.rep_i + (size_t)(a.BLK + s0 + n) * D + gk);
      }
    };
    auto load_a = [&](int k0) {
#pragma unroll
      for (int it = 0; it < kNA; ++it) {
        const int e = tid + it * kThreads;
        const int m = e / kKT, g = k0 + e % kKT;
        const bool lo = !IF || g < D;
        const int gk = min(lo ? g : g - D, D - 1);
        const int ul = max(s_ul[m], 0), il = max(s_il[m], 0);
        av[it] = __ldcg(a.tab_u + (size_t)(c.ub + ul) * D + gk);
        if (UF) {
          const float r = __ldcg(a.f.rep_u + (size_t)ul * D + gk);
          av[it] += lo ? r : 0.f;
        }
        pv[it] = __ldcg(lo ? a.tab_i + (size_t)(c.ib + il) * D + gk
                           : a.f.rep_i + (size_t)il * D + gk);
      }
    };
    __syncthreads();  // the previous tile's readers are done
    if (tid < kTM) {
      const int row = m0 + tid;
      const int p0 = row < C ? __ldg(c.rec + 2 * row) : 0;
      s_ul[tid] = ((p0 >> 21) & 1) ? (p0 & 1023) : -1;
      s_il[tid] = ((p0 >> 10) & 2047) - 1;
    }
    load_b(0);
    __syncthreads();
    load_a(0);
    // the history words of the thread's outputs (a guard row reads the user
    // block's first row and drops it)
    int words[kRT][kCT];
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const int* prow = a.packed +
                        (size_t)(c.ub + max(s_ul[ty + 16 * i], 0)) * a.W +
                        b * LW;
#pragma unroll
      for (int j = 0; j < kCT; ++j)
        words[i][j] = __ldg(prow + ((j0 + tx + 16 * j) & (LW - 1)));
    }
    float acc[kRT][kCT], ut[kRT];
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      ut[i] = 0.f;
#pragma unroll
      for (int j = 0; j < kCT; ++j) acc[i][j] = 0.f;
    }
    for (int k0 = 0; k0 < K; k0 += kKT) {
#pragma unroll
      for (int it = 0; it < kNA; ++it) {
        const int e = tid + it * kThreads;
        const int m = e / kKT, kk = e % kKT;
        const bool ok = k0 + kk < K && s_ul[m] >= 0;
        As[m * kKS + kk] = ok ? av[it] : 0.f;
        Ps[m * kKS + kk] = ok ? pv[it] : 0.f;
      }
#pragma unroll
      for (int it = 0; it < kNB; ++it) {
        const int e = tid + it * kThreads;
        const int n = e / kKT, kk = e % kKT;
        Bs[n * kKS + kk] = k0 + kk < K ? bv[it] : 0.f;
      }
      __syncthreads();
      if (k0 + kKT < K) {
        load_b(k0 + kKT);
        load_a(k0 + kKT);
      }
      // k ascending, f32 FMA; the staged zeros pad the step to 4. Every
      // thread also sums ut_ui of its rows, in the same order in every tile.
      const int kt = min(kKT, K - k0);
      for (int kk = 0; kk < kt; kk += 4) {
        float4 a4[kRT], p4[kRT], b4[kCT];
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          a4[i] = *reinterpret_cast<const float4*>(
              &As[(ty + 16 * i) * kKS + kk]);
          p4[i] = *reinterpret_cast<const float4*>(
              &Ps[(ty + 16 * i) * kKS + kk]);
        }
#pragma unroll
        for (int j = 0; j < kCT; ++j)
          b4[j] = *reinterpret_cast<const float4*>(
              &Bs[(tx + 16 * j) * kKS + kk]);
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          float u = ut[i];
          u = fmaf(a4[i].x, p4[i].x, u);
          u = fmaf(a4[i].y, p4[i].y, u);
          u = fmaf(a4[i].z, p4[i].z, u);
          u = fmaf(a4[i].w, p4[i].w, u);
          ut[i] = u;
#pragma unroll
          for (int j = 0; j < kCT; ++j) {
            float s = acc[i][j];
            s = fmaf(a4[i].x, b4[j].x, s);
            s = fmaf(a4[i].y, b4[j].y, s);
            s = fmaf(a4[i].z, b4[j].z, s);
            s = fmaf(a4[i].w, b4[j].w, s);
            acc[i][j] = s;
          }
        }
      }
      __syncthreads();  // before the next step overwrites the stage
    }
    // epilogue: 16 lanes hold one row's 64 slots (guard rows: nothing)
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const int m = ty + 16 * i, row = m0 + m;
      const bool valid = s_ul[m] >= 0;
      float* out = a.pw + (size_t)row * W2 + s0;
      int nn = 0, nv = 0;
#pragma unroll
      for (int j = 0; j < kCT; ++j) {
        const int n = tx + 16 * j, jj = j0 + n;
        float pw = NAN;  // NaN marks a member (never a negative)
        if (!((words[i][j] >> (jj >> a.lg_lw)) & 1)) {
          pw = ut[i] - acc[i][j];
          nn += 1;
          nv += (pw < kMargin) ? 1 : 0;
        }
        if (valid) out[n] = pw;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        nn += __shfl_xor_sync(0xffffffffu, nn, o);
        nv += __shfl_xor_sync(0xffffffffu, nv, o);
      }
      if (tx == 0 && valid) {
        if (nn) atomicAdd(&a.cnt[row], nn);
        if (nv) atomicAdd(&a.cnt[C + row], nv);
        if (s0 == 0) a.pw[(size_t)C * W2 + row] = ut[i];
      }
    }
  }
}

template <bool UF, bool IF>
__device__ void select_scatter(const Args& a, const Chunk& c, float* smem) {
  constexpr bool FEAT = UF || IF;
  const Feat& f = a.f;
  const int D = a.D, F = a.F, C = a.C, M = a.M, BLK = a.BLK;
  const int W2 = a.NW * BLK;
  float* s_key = smem;        // [NW*BLK] the selection key (16-byte aligned)
  float* s_red = s_key + W2;  // [32] reduction scratch
  float* s_part = s_red + 32;  // [3 * kThreads] partial sums, chosen slots
  float* s_u = s_part + 3 * kThreads;  // [D] user row
  float* s_i = s_u + D;       // [D] positive row
  float* s_j = s_i + D;       // [D] sum of the chosen rows
  // side features only
  float* s_ua = s_j + D;      // [D] augmented user row u + x_uf @ tab_uf
  float* s_ir = s_ua + D;     // [D] the positive's representation
  float* s_jr = s_ir + D;     // [D] sum of the chosen representations
  float* s_xj = s_jr + D;     // [Q] sum of the chosen slots' x_if rows
  float* s_xi = s_xj + f.Q;   // [Q] the positive's x_if row
  float* s_xu = s_xi + f.Q;   // [P] the user's x_uf row
  // [NW*BLK] the chosen slots, ascending (NW*BLK <= 64 * 1024); the rows
  // above are laid out only with side features (`smem_bytes` counts alike)
  uint16_t* s_list = reinterpret_cast<uint16_t*>(FEAT ? s_xu + f.P : s_j + D);
  __shared__ int s_wn[kWarps];  // chosen slots in each warp's segment
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* ll_rows = a.ll_rows + (size_t)c.k * C;
  int* chosen = a.chosen ? a.chosen + (size_t)c.k * C : nullptr;
  // a fixed-point add; an addend out of range or not finite marks the row
  bool bad = false;
  auto add = [&](unsigned long long* dst, float x) {
    if (!(fabsf(x) <= a.fix_lim))
      bad = true;
    else if (x != 0.f)
      atomicAdd(dst, (unsigned long long)__float2ll_rn(x * kFix));
  };
  for (int row = blockIdx.x; row < C; row += gridDim.x) {
    const int p0 = __ldg(c.rec + 2 * row);
    if (!((p0 >> 21) & 1)) {  // guard record: no reads, no updates
      if (tid == 0) {
        ll_rows[row] = 0.f;
        if (chosen) chosen[row] = -1;
      }
      continue;
    }
    __syncthreads();  // the previous row's readers are done
    bad = false;
    const float sw = __int_as_float(__ldg(c.rec + 2 * row + 1));
    const int u_loc = p0 & 1023;
    const int i_loc = ((p0 >> 10) & 2047) - 1;
    const int u_abs = c.ub + u_loc;
    const int i_abs = c.ib + i_loc;
    for (int k = tid; k < D; k += kThreads) {
      const float u = __ldcg(a.tab_u + (size_t)u_abs * D + k);
      s_u[k] = u;
      s_i[k] = __ldcg(a.tab_i + (size_t)i_abs * D + k);
      if constexpr (FEAT) {
        s_ua[k] = u + (UF ? __ldcg(f.rep_u + (size_t)u_loc * D + k) : 0.f);
        s_ir[k] = IF ? __ldcg(f.rep_i + (size_t)i_loc * D + k) : 0.f;
      }
    }
    if constexpr (IF)
      for (int q = tid; q < f.Q; q += kThreads)
        s_xi[q] = __ldg(f.x_if + (size_t)i_abs * f.Q + q);
    if constexpr (UF)
      for (int p = tid; p < f.P; p += kThreads)
        s_xu[p] = __ldg(f.x_uf + (size_t)u_abs * f.P + p);
    // what score_tiles left for this row
    const float4* pw_row =
        reinterpret_cast<const float4*>(a.pw + (size_t)row * W2);
    const float ut_ui = __ldcg(a.pw + (size_t)C * W2 + row);
    const float nn = (float)__ldcg(a.cnt + row);
    const float nv = (float)__ldcg(a.cnt + C + row);
    __syncthreads();
    if (tid == 0) a.cnt[row] = a.cnt[C + row] = 0;

    // closed-form WARP draw (BPR: M == 1, a uniform non-member)
    float mult = a.mult_bpr, pthr = 0.f;
    bool found = false;
    if (M > 1) {
      const float r1 =
          to_u01(philox_word(0u, (uint32_t)row, c.k, 1u, a.seed, 0u));
      const float p_c = fminf(fmaxf(nv / fmaxf(nn, 1.f), 1e-9f), 1.f - 1e-7f);
      float geo = floorf(logf(fmaxf(1.f - r1, 1e-30f)) / logf(1.f - p_c)) + 1.f;
      if (!(nv > 0.f)) geo = (float)M;
      found = (nv > 0.f) && (geo <= (float)M);
      const float sampled = fminf(geo, (float)M);
      pthr = (float)M / fmaxf(nn, 1.f);
      mult = logf(fmaxf(floorf(a.nm1 / sampled), 1.f)) / a.log_I;
    }

    // selection key of every slot, and its maximum; a uniform is drawn only
    // where the key reads it. A thread takes 4 neighbouring slots at a time
    // (the pw row is W2 = 128n floats); four such loads go out together
    float mx = -INFINITY;
    for (int q0 = tid; q0 < W2 / 4; q0 += 4 * kThreads) {
      float4 v4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v4[j] = __ldcg(pw_row + min(q0 + j * kThreads, W2 / 4 - 1));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = q0 + j * kThreads;
        if (q >= W2 / 4) break;
        const float4 v = v4[j];
        const float pws[4] = {v.x, v.y, v.z, v.w};
        float keys[4];
        bool need[4], any = false;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool viol = pws[i] < kMargin;
          need[i] = !isnan(pws[i]) && (M == 1 || (found ? viol : !viol));
          any |= need[i];
        }
        // one branch around four independent Philox chains (a branch per slot
        // would run them one after another)
        float u[4] = {0.f, 0.f, 0.f, 0.f};
        if (any) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            u[i] = to_u01(philox_word((uint32_t)(4 * q + i), (uint32_t)row, c.k,
                                      0u, a.seed, 0u));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float key = -INFINITY;
          if (need[i])
            key = (M == 1 || found) ? u[i]
                                    : -pws[i] - (u[i] >= pthr ? 1e6f : 0.f);
          keys[i] = key;
          mx = fmaxf(mx, key);
        }
        *reinterpret_cast<float4*>(s_key + 4 * q) =
            make_float4(keys[0], keys[1], keys[2], keys[3]);
      }
    }
    mx = block_max(mx, s_red);

    // the chosen slots (exact ties split evenly: keys off the Bernoulli
    // subset are quantised by the 1e6 offset, so ties can be many), listed
    // in ascending order: each warp counts the ties of its own contiguous
    // segment of slots with ballots, then lists them after those of the
    // warps before it
    const int seg = ((W2 + kWarps - 1) / kWarps + 31) & ~31;
    const int lo = min(warp * seg, W2), hi = min(lo + seg, W2);
    int mine = 0;
    if (mx > -INFINITY)
      for (int s0 = lo; s0 < hi; s0 += 32) {
        const int s = s0 + lane;
        mine += __popc(__ballot_sync(0xffffffffu, s < hi && s_key[s] == mx));
      }
    if (lane == 0) s_wn[warp] = mine;
    __syncthreads();
    int off = 0, n_j = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      off += w < warp ? s_wn[w] : 0;
      n_j += s_wn[w];
    }
    if (mine)
      for (int s0 = lo; s0 < hi; s0 += 32) {
        const int s = s0 + lane;
        const bool tie = s < hi && s_key[s] == mx;
        const unsigned b = __ballot_sync(0xffffffffu, tie);
        if (tie) s_list[off + __popc(b & ((1u << lane) - 1u))] = (uint16_t)s;
        off += __popc(b);
      }
    __syncthreads();

    // the chosen rows summed in a fixed order: thread (g, k) adds list
    // entries g, g + G, g + 2G, ... of column k, then the G partials of a
    // column are added in g order (the x_if rows likewise over Q columns)
    const int G = kThreads / D;
    if (tid < G * D) {
      const int g = tid / D, k = tid % D;
      float sj = 0.f, sjr = 0.f;
      for (int e = g; e < n_j; e += G) {
        const int s = s_list[e];
        const int item = c.blk[s >> a.lg_blk] * BLK + (s & (BLK - 1));
        sj += __ldcg(a.tab_i + (size_t)item * D + k);
        if constexpr (IF) sjr += __ldcg(f.rep_i + (size_t)(BLK + s) * D + k);
      }
      s_part[tid] = sj;
      if constexpr (IF) s_part[kThreads + tid] = sjr;
    }
    const int GQ = IF ? kThreads / f.Q : 0;
    if constexpr (IF) {
      if (tid < GQ * f.Q) {
        const int g = tid / f.Q, q = tid % f.Q;
        float sx = 0.f;
        for (int e = g; e < n_j; e += GQ) {
          const int s = s_list[e];
          const int item = c.blk[s >> a.lg_blk] * BLK + (s & (BLK - 1));
          sx += __ldg(f.x_if + (size_t)item * f.Q + q);
        }
        s_part[2 * kThreads + tid] = sx;
      }
    }
    __syncthreads();
    for (int k = tid; k < D; k += kThreads) {
      float sj = 0.f, sjr = 0.f;
      for (int g = 0; g < G; ++g) {
        sj += s_part[g * D + k];
        if constexpr (IF) sjr += s_part[kThreads + g * D + k];
      }
      s_j[k] = sj;
      if constexpr (FEAT) s_jr[k] = sjr;
    }
    if constexpr (IF)
      for (int q = tid; q < f.Q; q += kThreads) {
        float sx = 0.f;
        for (int g = 0; g < GQ; ++g) sx += s_part[2 * kThreads + g * f.Q + q];
        s_xj[q] = sx;
      }
    __syncthreads();
    const float cnt = (float)n_j;
    const float inv = cnt > 0.f ? 1.f / cnt : 0.f;
    float d = 0.f, ll = 0.f;
    if (cnt > 0.f) {
      float ut_uj = 0.f;
      if constexpr (FEAT) {
#pragma unroll 4
        for (int k = 0; k < D; ++k)
          ut_uj += s_ua[k] * (s_j[k] * inv) + s_u[k] * (s_jr[k] * inv);
      } else {
#pragma unroll 4
        for (int k = 0; k < D; ++k) ut_uj += s_u[k] * (s_j[k] * inv);
      }
      const float x = ut_ui - ut_uj;
      d = sw * mult / (1.f + expf(x));               // sw*mult*sigmoid(-x)
      ll = fminf(x, 0.f) - log1pf(expf(-fabsf(x)));  // log sigmoid(x)
    }

    // scatter: user row (col F = touch count), positive row (col F = bias
    // gradient d, col F+1 = touch count), chosen window slots (share 1/cnt).
    // With side features the user gradient is d * (i_tot - j_tot) and the
    // item gradients carry the augmented user row (its col F is still 1).
    const float* s_uu = FEAT ? s_ua : s_u;
    unsigned long long* au = a.acc_u + (size_t)u_loc * D;
    for (int k = tid; k <= F; k += kThreads) {
      float g = 1.f;
      if (k < F) {
        g = FEAT ? d * ((s_i[k] + s_ir[k]) - (s_j[k] + s_jr[k]) * inv)
                 : d * (s_i[k] - s_j[k] * inv);
      }
      add(&au[k], g);
    }
    unsigned long long* ap = a.acc_p + (size_t)i_loc * D;
    for (int k = tid; k < D; k += kThreads)
      add(&ap[k], k <= F ? d * s_uu[k] : 1.f);
    for (int e = tid; e < n_j * D; e += kThreads) {
      const int s = s_list[e / D], k = e % D;
      add(&a.acc_w[(size_t)s * D + k], k <= F ? -d * s_uu[k] * inv : inv);
    }
    if constexpr (FEAT) {
      // feature tables: one touch per row with a negative
      if (cnt > 0.f) {
        if (tid == 0) atomicAdd(f.n_ok + c.k, 1.f);
        if constexpr (IF) {
          // (x_if[i] - mean x_if[j]) (x) d * raw user row (col F: w_if)
          for (int e = tid; e < f.Q * (F + 1); e += kThreads) {
            const int q = e / (F + 1), k = e % (F + 1);
            const float diff = s_xi[q] - s_xj[q] * inv;
            if (diff != 0.f) {
              add(&f.g_if[(size_t)q * D + k], diff * (d * s_u[k]));
              if (k == 0) atomicAdd(&f.cnt_if[q], 1.f);
            }
          }
        }
        if constexpr (UF) {
          // x_uf[u] (x) d * (raw positive row - raw chosen row)
          for (int e = tid; e < f.P * F; e += kThreads) {
            const int p = e / F, k = e % F;
            const float xv = s_xu[p];
            if (xv != 0.f) {
              add(&f.g_uf[(size_t)p * D + k],
                  xv * (d * (s_i[k] - s_j[k] * inv)));
              if (k == 0) atomicAdd(&f.cnt_uf[p], 1.f);
            }
          }
        }
      }
    }
    const int any_bad = __syncthreads_or(bad);
    if (tid == 0) {
      ll_rows[row] = any_bad ? NAN : ll;
      if (chosen) chosen[row] = n_j > 0 ? (int)s_list[0] : -1;
    }
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

// One warp, lanes over the columns: the first `ncols` columns of table row
// `t` take `cnt` touches with the accumulated gradient `g` (fixed point),
// whose D columns are zeroed. Every lane has read `cnt` (it may be a column
// of `g`) before the call.
__device__ __forceinline__ void decay_row(float* t, unsigned long long* g,
                                          float cnt,
                                          int ncols, int D, float eta,
                                          float cdec, float ldec, int lane) {
  float ck, gf;
  decay_factors(cnt, eta, cdec, ldec, &ck, &gf);
  __syncwarp();
  for (int k = lane; k < D; k += 32) {
    if (k < ncols) t[k] = __ldcg(t + k) * ck + gf * unfix(__ldcg(g + k));
    g[k] = 0ull;
  }
  __syncwarp();
}

// The table updates of one chunk, one warp per accumulator row (user block,
// positive block, window blocks), lanes over the columns. A warp takes
// kApplyRows rows at a time and reads their touch counts together (most rows
// of a chunk are untouched: one round trip settles them). A table row that
// several occurrences of one block touched is updated by the warp of the
// block's first occurrence, occurrence after occurrence.
template <bool UF, bool IF>
__device__ void apply_updates(const Args& a, const Chunk& c) {
  const int D = a.D, F = a.F, UB = a.UB, BLK = a.BLK, NW = a.NW;
  const int tid = threadIdx.x, lane = tid & 31;
  const int gw = blockIdx.x * kWarps + (tid >> 5);
  const int n_warps = gridDim.x * kWarps;
  const float cdec = fmaxf(1.f - a.dreg, 1e-8f), ldec = logf(cdec);
  const int rows = UB + (1 + NW) * BLK;
  // first item of each occurrence's block: [positive, window 0, ...]
  __shared__ int s_base[kMaxNW + 1];
  if (tid <= NW) s_base[tid] = tid == 0 ? c.ib : __ldg(c.blk + tid - 1) * BLK;
  __syncthreads();
  // the count column of accumulator row p: col F of a user row, col F+1 of
  // an item row (acc_u, acc_p and acc_w are one array)
  auto count_of = [&](int p) {
    return a.acc_u + (size_t)p * D + (p < UB ? F : F + 1);
  };
  for (int p0 = gw; p0 < rows; p0 += kApplyRows * n_warps) {
    float cnts[kApplyRows];
#pragma unroll
    for (int i = 0; i < kApplyRows; ++i)
      cnts[i] = unfix(__ldcg(count_of(min(p0 + i * n_warps, rows - 1))));
#pragma unroll
    for (int i = 0; i < kApplyRows; ++i) {
      const int p = p0 + i * n_warps;
      if (p >= rows) break;
      if (p < UB) {  // user row: factors only, col F stays 1
        if (cnts[i] != 0.f)
          decay_row(a.tab_u + (size_t)(c.ub + p) * D, a.acc_u + (size_t)p * D,
                    cnts[i], F, D, a.eta, cdec, ldec, lane);
        continue;
      }
      // factors and bias of an item row, col F+1 stays 0
      const int q0 = (p - UB) >> a.lg_blk, r = (p - UB) & (BLK - 1);
      const int b = s_base[q0];
      bool first = true, last = true;
      for (int q = 0; q <= NW; ++q) {
        if (q < q0 && s_base[q] == b) first = false;
        if (q > q0 && s_base[q] == b) last = false;
      }
      if (!first) continue;
      float* t = a.tab_i + (size_t)(b + r) * D;
      if (cnts[i] != 0.f)
        decay_row(t, a.acc_u + (size_t)p * D, cnts[i], F + 1, D, a.eta, cdec,
                  ldec, lane);
      if (last) continue;
      for (int q = q0 + 1; q <= NW; ++q) {  // the block was drawn again
        if (s_base[q] != b) continue;
        unsigned long long* g = a.acc_u + (size_t)(UB + q * BLK + r) * D;
        const float cnt = unfix(__ldcg(g + F + 1));
        if (cnt != 0.f) decay_row(t, g, cnt, F + 1, D, a.eta, cdec, ldec, lane);
      }
    }
  }
  if constexpr (UF || IF) {
    // feature rows [0, P) of tab_uf (UF), then [0, Q) of tab_if (IF), one
    // warp each, lanes over the columns, taken from the last warp down.
    // v_uf / v_if decay by the row's touch count, w_if (tab_if col F) by the
    // chunk's count of rows with a negative; tab_uf col F stays 0.
    const Feat& f = a.f;
    const float cdf = fmaxf(1.f - a.dreg_f, 1e-8f), ldf = logf(cdf);
    const int np = UF ? f.P : 0, nf = np + (IF ? f.Q : 0);
    for (int p = n_warps - 1 - gw; p < nf; p += n_warps) {
      const bool is_uf = p < np;
      const int r = is_uf ? p : p - np;
      float* t = (is_uf ? f.tab_uf : f.tab_if) + (size_t)r * D;
      unsigned long long* g = (is_uf ? f.g_uf : f.g_if) + (size_t)r * D;
      float* cntp = (is_uf ? f.cnt_uf : f.cnt_if) + r;
      const float cnt = *cntp;
      const float n_ok = is_uf ? 0.f : f.n_ok[c.k];
      __syncwarp();  // every lane has read the count before it is zeroed
      for (int k = lane; k <= F; k += 32) {
        if (is_uf && k == F) {
          t[k] = 0.f;
          continue;
        }
        float ck, gf;
        decay_factors(k == F ? n_ok : cnt, a.eta, cdf, ldf, &ck, &gf);
        t[k] = t[k] * ck + gf * unfix(g[k]);
        g[k] = 0ull;
      }
      if (lane == 0) *cntp = 0.f;
    }
  }
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

// The whole batch: chunk after chunk, phase after phase, a grid barrier
// after each phase (none after the last chunk's updates). With `phase_ns`,
// thread 0 of block 0 adds the nanoseconds from one of its barriers to the
// next to the phase's sum: [0] feature_reps, [1] score_tiles,
// [2] select_scatter, [3] apply_updates, each with its barrier.
template <bool UF, bool IF>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fused_batch_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const bool timed = a.phase_ns && blockIdx.x == 0 && threadIdx.x == 0;
  unsigned long long t0 = timed ? global_ns() : 0;
  auto phase_end = [&](int phase, bool sync) {
    if (sync) grid.sync();
    if (timed) {
      const unsigned long long t = global_ns();
      a.phase_ns[phase] += t - t0;
      t0 = t;
    }
  };
  for (int k = 0; k < a.nT; ++k) {
    const Chunk c = chunk_of(a, k);
    if constexpr (UF || IF) {
      feature_reps<UF, IF>(a, c);
      phase_end(0, true);
    }
    score_tiles<UF, IF>(a, c, smem);
    phase_end(1, true);
    select_scatter<UF, IF>(a, c, smem);
    phase_end(2, true);
    apply_updates<UF, IF>(a, c);
    phase_end(3, k + 1 < a.nT);
  }
}

__global__ void __launch_bounds__(kThreads) probe_syncs(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

__global__ void __launch_bounds__(kThreads) probe_empty() {}

int ilog2(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// blocks of the persistent grid: kBlocksPerSM per SM, fewer if fewer fit
cudaError_t persistent_grid(const void* kernel, size_t smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  *blocks = sms * (per_sm < kBlocksPerSM ? per_sm : kBlocksPerSM);
  return cudaSuccess;
}

// Shared memory of one block: the larger of the score stage and the
// selection's row (its keys, its list of chosen slots as 16-bit indices,
// the partial sums and the rows it reads).
size_t smem_bytes(int D, int W2, int P, int Q, bool feat) {
  const size_t score =
      (size_t)((2 * kTM + kTN) * kKS + 2 * kTM) * sizeof(float);
  size_t select = (size_t)(W2 + 32 + 3 * kThreads + 3 * D) * sizeof(float) +
                  (size_t)W2 * sizeof(uint16_t);
  if (feat) select += (size_t)(3 * D + 2 * Q + P) * sizeof(float);
  return score > select ? score : select;
}

template <bool UF, bool IF>
int run_batch(Args a, unsigned long long* acc, float* facc, cudaStream_t st) {
  const int D = a.D, W2 = a.NW * a.BLK;
  if (a.NW > kMaxNW || D > 128 || a.f.Q > kThreads)
    return (int)cudaErrorInvalidValue;
  a.lg_blk = ilog2(a.BLK);
  a.lg_lw = ilog2(a.BLK >> 4);
  // at most C addends reach one accumulator element in a chunk
  a.fix_lim = 1073741824.0f / (float)a.C;
  // acc: the user block, the positive block and the windows, then (side
  // features) g_uf [P * D] and g_if [Q * D]
  a.acc_u = acc;
  a.acc_p = a.acc_u + (size_t)a.UB * D;
  a.acc_w = a.acc_p + (size_t)a.BLK * D;
  if constexpr (UF || IF) {
    // facc: rep_u [nu * D], rep_i [ni * D], cnt_uf [P], cnt_if [Q], n_ok [nT]
    Feat& f = a.f;
    const int nu = UF ? a.UB : 0, ni = IF ? (1 + a.NW) * a.BLK : 0;
    f.rep_u = facc;
    f.rep_i = f.rep_u + (size_t)nu * D;
    f.cnt_uf = f.rep_i + (size_t)ni * D;
    f.cnt_if = f.cnt_uf + f.P;
    f.n_ok = f.cnt_if + f.Q;
    f.g_uf = a.acc_w + (size_t)W2 * D;
    f.g_if = f.g_uf + (size_t)f.P * D;
  }
  const size_t smem = smem_bytes(D, W2, a.f.P, a.f.Q, UF || IF);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return -(int)smem;  // the row does not fit
  const void* kernel =
      reinterpret_cast<const void*>(fused_batch_kernel<UF, IF>);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = persistent_grid(kernel, smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args,
                                    smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// One batch of nT chunks in one cooperative launch on `stream`. `acc` is a
// zeroed 64-bit scratch of (UB + (1 + NW) * BLK + P + Q) * D words (P and Q
// only with side features; zero again when the kernel ends), the fixed-point
// accumulator; `pw` an f32 scratch of C * NW * BLK + C floats (any
// contents); `cnt` a zeroed int scratch of 2 * C (zero again when the kernel
// ends); `ll_rows` gets each row's log-likelihood term and, when not null,
// `chosen` each row's lowest chosen window slot (-1: none); when not null,
// `phase_ns` (4 x uint64) gains the nanoseconds block 0 spent in each phase.
// NW <= 64 and D <= 128.
//
// Side features: `x_uf` [U_pad, P] with `tab_uf` [P, D] and/or `x_if`
// [I_pad, Q] with `tab_if` [Q, D] (null and 0 when absent, Q <= 256);
// `facc` is then a zeroed f32 scratch of (nu + ni) * D + P + Q + nT floats,
// nu = UB with user features, ni = (1 + NW) * BLK with item features;
// `dreg_f` is eta * 2 * beta. The feature tables are updated in place.
//
// Returns the CUDA error of the launch, 0 when it was accepted, or minus
// the bytes of shared memory a block needs when the selection's row needs
// more than a block of this card may have. The library
// is compiled with -DRFM_UF=0|1 -DRFM_IF=0|1 and holds that one instantiation
// of the kernel; it refuses the other three.
extern "C" int rfm_fused_batch(float* tab_u, float* tab_i, int D, int F,
                               const int* rec, const int* packed, int W,
                               const int* blk, const int* ublk,
                               const int* iblk, unsigned long long* acc,
                               float* ll_rows,
                               int* chosen,
                               int nT, int C, int UB, int BLK, int NW, int M,
                               float nm1, float log_I, float mult_bpr,
                               unsigned int seed, float eta, float dreg,
                               const float* x_uf, const float* x_if,
                               float* tab_uf, float* tab_if, int P, int Q,
                               float* facc, float dreg_f, float* pw, int* cnt,
                               unsigned long long* phase_ns, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a = {};
  a.tab_u = tab_u;
  a.tab_i = tab_i;
  a.D = D;
  a.F = F;
  a.rec = rec;
  a.packed = packed;
  a.W = W;
  a.blk = blk;
  a.ublk = ublk;
  a.iblk = iblk;
  a.ll_rows = ll_rows;
  a.chosen = chosen;
  a.nT = nT;
  a.C = C;
  a.UB = UB;
  a.BLK = BLK;
  a.NW = NW;
  a.M = M;
  a.nm1 = nm1;
  a.log_I = log_I;
  a.mult_bpr = mult_bpr;
  a.seed = seed;
  a.eta = eta;
  a.dreg = dreg;
  a.dreg_f = dreg_f;
  a.pw = pw;
  a.cnt = cnt;
  a.phase_ns = phase_ns;
  a.f.x_uf = x_uf;
  a.f.x_if = x_if;
  a.f.tab_uf = tab_uf;
  a.f.tab_if = tab_if;
  a.f.P = x_uf ? P : 0;
  a.f.Q = x_if ? Q : 0;
  // this library holds one instantiation (the four build side by side)
  if ((x_uf != nullptr) != (RFM_UF != 0) || (x_if != nullptr) != (RFM_IF != 0))
    return (int)cudaErrorInvalidValue;
  return run_batch<RFM_UF != 0, RFM_IF != 0>(a, acc, facc, st);
}

// What a phase boundary costs, for the choice between one persistent launch
// and one launch per phase: `n` grid barriers inside one cooperative launch
// (cooperative != 0) or `n` empty dependent launches, both on the batch
// kernel's grid. Timed by the caller around the call (CUDA events).
extern "C" int rfm_phase_probe(int n, int cooperative, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int blocks = 0;
  cudaError_t err = persistent_grid(
      reinterpret_cast<const void*>(probe_syncs), 0, &blocks);
  if (err != cudaSuccess) return (int)err;
  if (cooperative) {
    void* args[] = {&n};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(probe_syncs), dim3(blocks),
        dim3(kThreads), args, 0, st);
    if (err != cudaSuccess) return (int)err;
  } else {
    for (int i = 0; i < n; ++i) probe_empty<<<blocks, kThreads, 0, st>>>();
  }
  return (int)cudaGetLastError();
}

extern "C" const char* rfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
