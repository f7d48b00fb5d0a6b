// Filtered top-N retrieval for Hopper (sm_90a): score, seen-item filter and
// top-k in one pass over the catalog (entry point `rfm_topk_select`).
//
// Replaces no TPU kernel: the JAX package scores a user chunk against the
// whole catalog with XLA's matmul, masks the seen items and calls `top_k`
// (`rankfm_tpu/ops/topk.py`), and the port's plain version does the same
// with ~20 PyTorch ops (`rankfm_tpu_torch/ops/topk.py:topk_bitmap_plain`).
// On this card that chain writes a `[B, I]` score matrix, a `[B, I]` matrix
// of bitmap words, a mask and a radix top-k's passes, seven eighths of its
// device time, around a score product that is one eighth of it.
//
// It computes, for B users `u_idx` and every item i < I,
//
//   s(u, i) = ib[i] + ur[u] . v_i[i] + v_u[u] . (x_if[i] @ v_if)
//   ur = v_u + x_uf @ v_uf,   ib = w_i + x_if @ w_if
//
// in f32 with f32 accumulation on the CUDA cores (no TF32 or tensor-core
// rounding), skips item i for user u when bit i & 31 of word i >> 5 of
// `bitmap[u]` is set (no bitmap: nothing is skipped), and returns each
// user's k best items sorted by descending score; a slot with no item left
// is item -1 with score -inf. A NaN score is never listed, and a user index
// outside [0, U) gets an empty list (all -1).
//
// What bounds it on an H100: operations. A 1,000-user request over 33,362
// items at F = 50 is 2 * B * I * 2F = 6.67 GFLOP, 0.10 ms at 67 TFLOP/s of
// f32 FMA; its operands (13 MB of items, 0.4 MB of users, 4 MB of bitmap
// rows) are a few microseconds of memory time. At 3,706 items and F = 20 it
// is 0.30 GFLOP, 4.4 us, and the three launches and the first tile's
// selection set the time. Design:
//
// - `operands_kernel` (launch 1) builds the 2F-wide operands once per call:
//   `i_mat [Ip, Kp]` = [v_i | x_if @ v_if] and `ib [Ip]` for every item,
//   `u_mat [Bp, Kp]` = [ur | v_u] for the B users, row-major, zero beyond
//   2F (Kp = 2F rounded up to the staged depth) and beyond I and B (Ip, Bp
//   rounded up to the tiles). Nothing is kept between calls.
// - `select_kernel` (launch 2): block (s, b) takes users [128 b, 128 b +
//   128) and the s-th of S equal runs of 128-item tiles; S is chosen by the
//   wrapper so that one wave fills every SM. Per tile, 256 threads compute
//   the 128 x 128 scores as an f32 register-tiled product (8 x 8 per thread,
//   operands staged through shared memory 8 deep, double-buffered), each
//   score's sum in ascending depth; meanwhile each row's 4 bitmap words of
//   the tile arrive by `cp.async`. On a block's first tile every thread
//   sorts its 8 scores of each row (seen items dropped) and one thread per
//   row takes the k best of the row's 16 sorted runs: the same k steps in
//   every lane of a warp, where inserting the 128 scores one by one would
//   make each warp wait on the union of its lanes' inserts. On later tiles
//   each thread marks the scores above its row's k-th best so far, and the
//   row's thread offers only those, unseen, to the row's min-heap in shared
//   memory. After the first tiles almost no score passes. No `[B, I]`
//   matrix is written: a block leaves each row's k best, sorted
//   (heapsort).
// - `merge_kernel` (launch 3): one warp per user merges its S sorted lists,
//   a warp-wide arg-max over the lists' heads per slot.
//
// Every step has a fixed order (the product's depth order, the scan's
// column order, the merge's total order: higher score first, then lower
// item), so a call gives the same lists bit for bit, run after run. Items
// of equal score may be listed in another order than `torch.topk`'s.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;               // users of a block
constexpr int kBN = 128;               // items of a tile
constexpr int kKC = 8;                 // depth staged at a time
constexpr int kThreads = 256;
constexpr int kKMax = 128;             // the largest k (`topk.K_MAX`)
constexpr int kOpStride = kBM + 4;     // staged operand row (kBM == kBN)
constexpr int kStStride = kBN + 4;     // score tile row, 16-byte aligned
constexpr int kMaxDevices = 64;

constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// `select_kernel`'s dynamic shared memory: the staged operands, whose room
// the score tile reuses; a byte of pass bits for each row and each of the
// 16 threads that computed it; each row's threshold; each row's 4 bitmap
// words of the tile; the tile's column of each score of the first tile,
// as sorted; each row's heap of k entries, scores then items
constexpr size_t kOpsBytes = 2 * 2 * kKC * kOpStride * sizeof(float);
constexpr size_t kTileBytes = (size_t)kBM * kStStride * sizeof(float);
constexpr size_t kUnionBytes = kOpsBytes > kTileBytes ? kOpsBytes : kTileBytes;
constexpr size_t kPassBytes = (size_t)kBM * 16;
constexpr size_t kThrOffset = kUnionBytes + kPassBytes;
constexpr size_t kWordsOffset = kThrOffset + kBM * sizeof(float);
constexpr size_t kColsOffset = kWordsOffset + (size_t)kBM * 4 * sizeof(unsigned);
constexpr size_t kHeapOffset = kColsOffset + (size_t)kBM * kBN;
constexpr size_t select_smem_bytes(int k) {
  return kHeapOffset + (size_t)k * kBM * (sizeof(float) + sizeof(int));
}

constexpr int kOpRows = 32;            // operand rows of a block

// The operand rows of one block: 32 rows of `i_mat` (and their `ib`) or of
// `u_mat`. The feature product (x_if @ [v_if | w_if] for items, x_uf @ v_uf
// for users) is a small tiled product: 32 features at a time staged in
// shared memory, each output column by a lane, each warp 4 rows, every sum
// in ascending feature order. Rows past I or B are zero; a user index
// outside [0, U) makes its row NaN, so that no score of it passes.
__global__ void __launch_bounds__(kThreads)
operands_kernel(const float* __restrict__ v_u, const float* __restrict__ v_i,
                const float* __restrict__ w_i, const float* __restrict__ v_uf,
                const float* __restrict__ v_if, const float* __restrict__ w_if,
                const float* __restrict__ x_uf, const float* __restrict__ x_if,
                const long long* __restrict__ u_idx, int U, int I, int F,
                int P, int Q, int B, int Kp, int Ip, float* __restrict__ i_mat,
                float* __restrict__ ib, float* __restrict__ u_mat) {
  __shared__ float xs[kOpRows][33];
  __shared__ float vs[32][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool items = (int)blockIdx.x < Ip / kOpRows;
  const int r0 = ((int)blockIdx.x - (items ? 0 : Ip / kOpRows)) * kOpRows;
  const float* X = items ? x_if : x_uf;
  const float* V = items ? v_if : v_uf;
  const int XQ = items ? Q : P;
  const int Fo = items ? F + 1 : F;          // items: ib's column last
  float* out = (items ? i_mat : u_mat) + (size_t)r0 * Kp;
  const float nan = nanf("");
  // the source row of block row r: >= 0, or -1 (padding), -2 (bad user)
  auto src = [&](int r) -> long long {
    const int g = r0 + r;
    if (items) return g < I ? g : -1;
    if (g >= B) return -1;
    const long long u = u_idx[g];
    return (u < 0 || u >= U) ? -2 : u;
  };

  // the copied columns: items [0, F) from v_i, users [F, 2F) from v_u;
  // zero past 2F
  for (int it = 0; it < kOpRows / 8; ++it) {
    const int r = warp + 8 * it;
    const long long sr = src(r);
    for (int k = lane; k < Kp; k += 32) {
      if (k >= 2 * F) {
        out[(size_t)r * Kp + k] = 0.f;
      } else if (items && k < F) {
        out[(size_t)r * Kp + k] = sr >= 0 ? v_i[(size_t)sr * F + k] : 0.f;
      } else if (!items && k >= F) {
        out[(size_t)r * Kp + k] =
            sr >= 0 ? v_u[(size_t)sr * F + (k - F)] : (sr == -2 ? nan : 0.f);
      }
    }
  }

  // the product's columns
  for (int f0 = 0; f0 < Fo; f0 += 32) {
    float acc[kOpRows / 8] = {};
    for (int q0 = 0; q0 < XQ; q0 += 32) {
      const int qn = min(32, XQ - q0);
      __syncthreads();
      {
        const int r = tid >> 3, c = (tid & 7) * 4;
        const long long sr = src(r);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xs[r][c + e] = (sr >= 0 && c + e < qn)
                             ? X[(size_t)sr * XQ + q0 + c + e] : 0.f;
        const int qq = tid >> 3;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = f0 + c + e;
          float v = 0.f;
          if (qq < qn) {
            if (f < F)
              v = V[(size_t)(q0 + qq) * F + f];
            else if (f == F && items)
              v = w_if[q0 + qq];
          }
          vs[qq][c + e] = v;
        }
      }
      __syncthreads();
      for (int qq = 0; qq < qn; ++qq) {
        const float v = vs[qq][lane];
#pragma unroll
        for (int it = 0; it < kOpRows / 8; ++it)
          acc[it] = fmaf(xs[warp + 8 * it][qq], v, acc[it]);
      }
    }
    const int f = f0 + lane;
#pragma unroll
    for (int it = 0; it < kOpRows / 8; ++it) {
      const int r = warp + 8 * it;
      const long long sr = src(r);
      if (items && f < F) {
        out[(size_t)r * Kp + F + f] = sr >= 0 ? acc[it] : 0.f;
      } else if (items && f == F) {
        ib[r0 + r] = sr >= 0 ? w_i[sr] + acc[it] : 0.f;
      } else if (!items && f < F) {
        out[(size_t)r * Kp + f] = sr >= 0
            ? v_u[(size_t)sr * F + f] + acc[it] : (sr == -2 ? nan : 0.f);
      }
    }
  }
}

// A row's k entries live at hv[j * kBM], hi[j * kBM] (j < k), a min-heap
// with its root at j = 0.

// put (val, id) at node j of a heap of n and sift it down
__device__ __forceinline__ void sift_down(float* hv, int* hi, int n, int j,
                                          float val, int id) {
  while (true) {
    const int l = 2 * j + 1;
    if (l >= n) break;
    int m = l;
    float vm = hv[l * kBM];
    if (l + 1 < n) {
      const float vr = hv[(l + 1) * kBM];
      if (vr < vm) {
        vm = vr;
        m = l + 1;
      }
    }
    if (!(vm < val)) break;
    hv[j * kBM] = vm;
    hi[j * kBM] = hi[m * kBM];
    j = m;
  }
  hv[j * kBM] = val;
  hi[j * kBM] = id;
}

__device__ __forceinline__ void heapify(float* hv, int* hi, int n) {
  for (int j = n / 2 - 1; j >= 0; --j)
    sift_down(hv, hi, n, j, hv[j * kBM], hi[j * kBM]);
}

// the heap's step for one unseen score of its row: past the threshold, in
// (filling, then replacing the root)
__device__ __forceinline__ void offer(float v, int item, float* hv, int* hi,
                                      int k, int& cnt, float& thr) {
  if (!(v > thr)) return;
  if (cnt < k) {
    hv[cnt * kBM] = v;
    hi[cnt * kBM] = item;
    if (++cnt == k) {
      heapify(hv, hi, k);
      thr = hv[0];
    }
  } else {
    sift_down(hv, hi, k, 0, v, item);
    thr = hv[0];
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// one comparator of the sorting network: the pair (v, c) in order, higher
// score first, then the lower column
__device__ __forceinline__ void order2(float* v, int* c, int a, int b) {
  if (v[b] > v[a] || (v[b] == v[a] && c[b] < c[a])) {
    const float tv = v[a];
    v[a] = v[b];
    v[b] = tv;
    const int tc = c[a];
    c[a] = c[b];
    c[b] = tc;
  }
}

// the 19-comparator network that sorts 8 entries
__device__ __forceinline__ void sort8(float* v, int* c) {
  order2(v, c, 0, 1); order2(v, c, 2, 3); order2(v, c, 4, 5);
  order2(v, c, 6, 7); order2(v, c, 0, 2); order2(v, c, 1, 3);
  order2(v, c, 4, 6); order2(v, c, 5, 7); order2(v, c, 1, 2);
  order2(v, c, 5, 6); order2(v, c, 0, 4); order2(v, c, 3, 7);
  order2(v, c, 1, 5); order2(v, c, 2, 6); order2(v, c, 1, 4);
  order2(v, c, 3, 6); order2(v, c, 2, 4); order2(v, c, 3, 5);
  order2(v, c, 3, 4);
}

// where slot s (0..7) of thread g's 8 columns of a row lies in the tile
__device__ __forceinline__ int slot_col(int g, int s) {
  return (s < 4 ? 0 : 64) + g * 4 + (s & 3);
}

// the 16 bits x (4 nibbles) spread to the low nibbles of 4 bytes
__device__ __forceinline__ unsigned spread_nibbles(unsigned x) {
  return (x & 0xfu) | (x & 0xf0u) << 4 | (x & 0xf00u) << 8 |
         (x & 0xf000u) << 12;
}

__global__ void __launch_bounds__(kThreads, 2)
select_kernel(const float* __restrict__ u_mat, const float* __restrict__ i_mat,
              const float* __restrict__ ib, const long long* __restrict__ u_idx,
              const int* __restrict__ bitmap, int W, int U, int I, int B,
              int Kp, int nT, int S, int k, float* __restrict__ cand_s,
              int* __restrict__ cand_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ops = reinterpret_cast<float*>(smem);   // 2 x (A [kKC][kOpStride],
                                                 //      B [kKC][kOpStride])
  float* st = ops;                               // score tile, after them
  unsigned char* pass = smem + kUnionBytes;      // [kBM][16]
  float* thr_s = reinterpret_cast<float*>(smem + kThrOffset);
  unsigned* bmw = reinterpret_cast<unsigned*>(smem + kWordsOffset);  // [kBM][4]
  unsigned char* cols = smem + kColsOffset;      // [kBM][kBN]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int s = blockIdx.x, ub = blockIdx.y;
  const int t0 = (int)((long long)s * nT / S);
  const int t1 = (int)((long long)(s + 1) * nT / S);
  const int nC = Kp / kKC;
  // staging: thread tid copies 4 floats of row tid / 2 of each operand
  const int lr = tid >> 1, lc = (tid & 1) * 4;
  const float* a_src = u_mat + (size_t)(ub * kBM + lr) * Kp + lc;

  // the scan: thread tid < kBM owns user row ub * kBM + tid and its entries
  const int row = ub * kBM + tid;
  const bool scans = tid < kBM && row < B;
  const int* bm_row = nullptr;
  if (scans && bitmap != nullptr) {
    const long long u = u_idx[row];
    if (u >= 0 && u < U) bm_row = bitmap + (size_t)u * W;
  }
  float* hv = reinterpret_cast<float*>(smem + kHeapOffset) + tid;
  int* hi = reinterpret_cast<int*>(smem + kHeapOffset +
                                   (size_t)k * kBM * sizeof(float)) + tid;
  float thr = -INFINITY;
  int cnt = 0;
  // a row past B lets no score pass; the first barrier below publishes it
  if (tid < kBM) thr_s[tid] = scans ? -INFINITY : INFINITY;

  for (int t = t0; t < t1; ++t) {
    const int i0 = t * kBN;
    const float* b_src = i_mat + (size_t)(i0 + lr) * Kp + lc;
    // the row's 4 bitmap words of the tile arrive while the scores are
    // computed (all-seen past the bitmap: those columns are past I)
    if (scans) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int wdx = (i0 >> 5) + e;
        if (bm_row != nullptr && wdx < W)
          cp_async4(bmw + tid * 4 + e, bm_row + wdx);
        else
          bmw[tid * 4 + e] = bm_row != nullptr ? ~0u : 0u;
      }
    }
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    float4 pa = *reinterpret_cast<const float4*>(a_src);
    float4 pb = *reinterpret_cast<const float4*>(b_src);
    {
      float* As = ops;
      float* Bs = ops + kKC * kOpStride;
      As[(lc + 0) * kOpStride + lr] = pa.x;
      As[(lc + 1) * kOpStride + lr] = pa.y;
      As[(lc + 2) * kOpStride + lr] = pa.z;
      As[(lc + 3) * kOpStride + lr] = pa.w;
      Bs[(lc + 0) * kOpStride + lr] = pb.x;
      Bs[(lc + 1) * kOpStride + lr] = pb.y;
      Bs[(lc + 2) * kOpStride + lr] = pb.z;
      Bs[(lc + 3) * kOpStride + lr] = pb.w;
    }
    __syncthreads();
    for (int c = 0; c < nC; ++c) {
      const int buf = c & 1;
      if (c + 1 < nC) {
        pa = *reinterpret_cast<const float4*>(a_src + (c + 1) * kKC);
        pb = *reinterpret_cast<const float4*>(b_src + (c + 1) * kKC);
      }
      const float* As = ops + buf * 2 * kKC * kOpStride;
      const float* Bs = As + kKC * kOpStride;
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(As + kk * kOpStride + ty * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(
            As + kk * kOpStride + 64 + ty * 4);
        const float4 b0 =
            *reinterpret_cast<const float4*>(Bs + kk * kOpStride + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(
            Bs + kk * kOpStride + 64 + tx * 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (c + 1 < nC) {
        float* As2 = ops + (buf ^ 1) * 2 * kKC * kOpStride;
        float* Bs2 = As2 + kKC * kOpStride;
        As2[(lc + 0) * kOpStride + lr] = pa.x;
        As2[(lc + 1) * kOpStride + lr] = pa.y;
        As2[(lc + 2) * kOpStride + lr] = pa.z;
        As2[(lc + 3) * kOpStride + lr] = pa.w;
        Bs2[(lc + 0) * kOpStride + lr] = pb.x;
        Bs2[(lc + 1) * kOpStride + lr] = pb.y;
        Bs2[(lc + 2) * kOpStride + lr] = pb.z;
        Bs2[(lc + 3) * kOpStride + lr] = pb.w;
      }
      // the last one also ends every read of the staged operands, which
      // the score tile overwrites, and publishes the bitmap words
      if (c + 1 == nC) cp_async_wait_all();
      __syncthreads();
    }

    const float4 ib0 = *reinterpret_cast<const float4*>(ib + i0 + tx * 4);
    const float4 ib1 = *reinterpret_cast<const float4*>(ib + i0 + 64 + tx * 4);
    const float bias[8] = {ib0.x, ib0.y, ib0.z, ib0.w,
                           ib1.x, ib1.y, ib1.z, ib1.w};
    if (t == t0) {
      // the first tile: each thread sorts its 8 scores of each row (seen
      // items, columns past I and NaN as -inf) into its slots, with their
      // columns, for the scan to merge
      const int n = min(kBN, I - i0);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
        const int sh = (tx & 7) * 4;
        const unsigned seen = (bmw[r * 4 + (tx >> 3)] >> sh & 0xfu) |
                              (bmw[r * 4 + 2 + (tx >> 3)] >> sh & 0xfu) << 4;
        float v[8];
        int c[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          c[j] = slot_col(tx, j);
          v[j] = acc[i][j] + bias[j];
          if (c[j] >= n || ((seen >> j) & 1u) || v[j] != v[j])
            v[j] = -INFINITY;
        }
        sort8(v, c);
        *reinterpret_cast<float4*>(st + r * kStStride + tx * 4) =
            make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(st + r * kStStride + 64 + tx * 4) =
            make_float4(v[4], v[5], v[6], v[7]);
        *reinterpret_cast<unsigned*>(cols + r * kBN + tx * 4) =
            c[0] | c[1] << 8 | c[2] << 16 | (unsigned)c[3] << 24;
        *reinterpret_cast<unsigned*>(cols + r * kBN + 64 + tx * 4) =
            c[4] | c[5] << 8 | c[6] << 16 | (unsigned)c[7] << 24;
      }
    } else {
      // later tiles: park the scores in the tile with a bit for each score
      // above its row's threshold; rows none of whose scores pass are not
      // written
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
        const float th = thr_s[r];
        const float4 v0 = make_float4(acc[i][0] + bias[0], acc[i][1] + bias[1],
                                      acc[i][2] + bias[2], acc[i][3] + bias[3]);
        const float4 v1 = make_float4(acc[i][4] + bias[4], acc[i][5] + bias[5],
                                      acc[i][6] + bias[6], acc[i][7] + bias[7]);
        const unsigned bits =
            (v0.x > th) | (v0.y > th) << 1 | (v0.z > th) << 2 |
            (v0.w > th) << 3 | (v1.x > th) << 4 | (v1.y > th) << 5 |
            (v1.z > th) << 6 | (v1.w > th) << 7;
        pass[r * 16 + tx] = (unsigned char)bits;
        if (bits) {
          *reinterpret_cast<float4*>(st + r * kStStride + tx * 4) = v0;
          *reinterpret_cast<float4*>(st + r * kStStride + 64 + tx * 4) = v1;
        }
      }
    }
    __syncthreads();

    if (scans && t == t0) {
      // the first tile: the row's k best of its 16 sorted runs, best first,
      // the same k steps in every lane
      const float* srow = st + tid * kStStride;
      float head[16];
#pragma unroll
      for (int g = 0; g < 16; ++g) head[g] = srow[slot_col(g, 0)];
      unsigned long long taken = 0ull;            // 4 bits a run
      for (int step = 0; step < k; ++step) {
        float bv = head[0];
        int bg = 0;
#pragma unroll
        for (int g = 1; g < 16; ++g) {
          if (head[g] > bv) {
            bv = head[g];
            bg = g;
          }
        }
        if (!(bv > -INFINITY)) break;
        const int sl = (int)(taken >> (4 * bg)) & 0xf;
        hv[cnt * kBM] = bv;
        hi[cnt * kBM] = i0 + cols[tid * kBN + slot_col(bg, sl)];
        ++cnt;
        taken += 1ull << (4 * bg);
        const float nv = sl + 1 < 8 ? srow[slot_col(bg, sl + 1)] : -INFINITY;
#pragma unroll
        for (int g = 0; g < 16; ++g) head[g] = g == bg ? nv : head[g];
      }
      if (cnt == k) {
        // the heap: the list reversed, worst first
        for (int j = 0; j < k / 2; ++j) {
          const float tv = hv[j * kBM];
          hv[j * kBM] = hv[(k - 1 - j) * kBM];
          hv[(k - 1 - j) * kBM] = tv;
          const int ti = hi[j * kBM];
          hi[j * kBM] = hi[(k - 1 - j) * kBM];
          hi[(k - 1 - j) * kBM] = ti;
        }
        thr = hv[0];
      }
      thr_s[tid] = thr;
    } else if (scans) {
      // the row's passing scores: byte g of the 16 holds the bits of the
      // columns g*4 .. g*4+3, then 64+g*4 .. 64+g*4+3 (thread g's)
      const uint4 pw = *reinterpret_cast<const uint4*>(pass + tid * 16);
      unsigned words[4] = {pw.x, pw.y, pw.z, pw.w};
      const bool any = (words[0] | words[1] | words[2] | words[3]) != 0u;
      if (any) {
        // drop the seen items and the columns past the catalog, the bitmap
        // words laid out as the pass bits
        const int n = min(kBN, I - i0);
        unsigned drop[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lo = n - 32 * e;
          drop[e] = (lo >= 32 ? 0u : (lo <= 0 ? ~0u : ~((1u << lo) - 1u))) |
                    bmw[tid * 4 + e];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int sh = (q & 1) * 16;
          words[q] &= ~(spread_nibbles((drop[q >> 1] >> sh) & 0xffffu) |
                        spread_nibbles((drop[2 + (q >> 1)] >> sh) & 0xffffu)
                            << 4);
        }
      }
      const float* srow = st + tid * kStStride;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        unsigned bits = words[q];
        while (bits) {
          const int bt = __ffs(bits) - 1;
          bits &= bits - 1;
          const int col = slot_col(q * 4 + (bt >> 3), bt & 7);
          offer(srow[col], i0 + col, hv, hi, k, cnt, thr);
        }
      }
      thr_s[tid] = thr;
    }
    // the next tile stages its operands where the scores are
    __syncthreads();
  }

  if (scans) {
    // the row's entries best first: a heap of what it holds, then heapsort
    // (each minimum to the end); then padded
    if (cnt < k) heapify(hv, hi, cnt);
    for (int n = cnt - 1; n > 0; --n) {
      const float v = hv[n * kBM];
      const int id = hi[n * kBM];
      hv[n * kBM] = hv[0];
      hi[n * kBM] = hi[0];
      sift_down(hv, hi, n, 0, v, id);
    }
    for (int j = cnt; j < k; ++j) {
      hv[j * kBM] = -INFINITY;
      hi[j * kBM] = -1;
    }
    const size_t base = ((size_t)row * S + s) * k;
    for (int j = 0; j < k; ++j) {
      cand_s[base + j] = hv[j * kBM];
      cand_i[base + j] = hi[j * kBM];
    }
  }
}

// (s, i) before (t, j): higher score first, then the lower item
__device__ __forceinline__ bool before(float s, int i, float t, int j) {
  return s > t || (s == t && i < j);
}

// one warp per user: the k best of the user's S lists (each sorted, best
// first), a list's next entry at a time; each warp stages its user's lists
// and their positions in shared memory (`merge_warps` warps a block)
__global__ void merge_kernel(const float* __restrict__ cand_s,
                             const int* __restrict__ cand_i, int B, int S,
                             int k, int* __restrict__ out_i,
                             float* __restrict__ out_s) {
  extern __shared__ __align__(16) unsigned char mem[];
  const int wb = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int user = blockIdx.x * (blockDim.x >> 5) + wb;
  if (user >= B) return;                         // the whole warp
  const int n = S * k;
  float* cs = reinterpret_cast<float*>(mem) + (size_t)wb * (2 * n + S);
  int* ci = reinterpret_cast<int*>(cs + n);
  int* pos = ci + n;                             // each list's next entry
  for (int j = lane; j < n; j += 32) {
    cs[j] = cand_s[(size_t)user * n + j];
    ci[j] = cand_i[(size_t)user * n + j];
  }
  for (int l = lane; l < S; l += 32) pos[l] = 0;
  __syncwarp();
  int* oi = out_i + (size_t)user * k;
  float* os = out_s + (size_t)user * k;

  // the best next entry of the lane's lists l = lane, lane + 32, ...
  float bs;
  int bi, bl;
  auto lane_best = [&]() {
    bs = -INFINITY;
    bi = -1;
    bl = -1;
    for (int l = lane; l < S; l += 32) {
      if (pos[l] < k) {
        const int j = l * k + pos[l];
        if (before(cs[j], ci[j], bs, bi)) {
          bs = cs[j];
          bi = ci[j];
          bl = l;
        }
      }
    }
  };
  lane_best();
  for (int r = 0; r < k; ++r) {
    float ms = bs;
    int mi = bi;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float s2 = __shfl_xor_sync(0xffffffffu, ms, off);
      const int i2 = __shfl_xor_sync(0xffffffffu, mi, off);
      if (before(s2, i2, ms, mi)) {
        ms = s2;
        mi = i2;
      }
    }
    if (ms == -INFINITY) {                       // nothing left: -1 slots
      for (int j = r + lane; j < k; j += 32) {
        oi[j] = -1;
        os[j] = -INFINITY;
      }
      return;
    }
    if (lane == 0) {
      oi[r] = mi;
      os[r] = ms;
    }
    if (bs == ms && bi == mi) {                  // the lane that held it
      ++pos[bl];
      lane_best();
    }
  }
}

// warps of a merge block: as many as 48 KiB of staged lists hold
int merge_warps(int S, int k) {
  const int w = (int)(48 * 1024 / ((size_t)S * (8 * k + 4)));
  return w < 1 ? 1 : (w > 8 ? 8 : w);
}

bool g_smem_set[kMaxDevices];

}  // namespace

// u_idx [B] int64; bitmap [U, W] int32 or null; scratch: the float words of
// `topk.launch_plan` (i_mat, u_mat, ib, cand_s, cand_i in that order);
// out_i [B, k] int32, out_s [B, k] f32. Returns a CUDA error code (0: the
// three kernels were enqueued on `stream`).
extern "C" int rfm_topk_select(
    const float* v_u, const float* v_i, const float* w_i, const float* v_uf,
    const float* v_if, const float* w_if, const float* x_uf,
    const float* x_if, const long long* u_idx, const int* bitmap, int W,
    int U, int I, int F, int P, int Q, int B, int k, int S, float* scratch,
    int* out_i, float* out_s, void* stream) {
  if (k < 1 || k > kKMax || B < 1 || I < 1 || F < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Kp = round_up(2 * F, kKC);
  const int Ip = round_up(I, kBN);
  const int Bp = round_up(B, kBM);
  const int nT = Ip / kBN;
  if (S > nT || (size_t)S * (8 * k + 4) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  float* i_mat = scratch;
  float* u_mat = i_mat + (size_t)Ip * Kp;
  float* ib = u_mat + (size_t)Bp * Kp;
  float* cand_s = ib + Ip;
  int* cand_i = reinterpret_cast<int*>(cand_s + (size_t)B * S * k);

  operands_kernel<<<(Ip + Bp) / kOpRows, kThreads, 0, st>>>(
      v_u, v_i, w_i, v_uf, v_if, w_if, x_uf, x_if, u_idx, U, I, F, P, Q, B,
      Kp, Ip, i_mat, ib, u_mat);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices || !g_smem_set[dev]) {
    err = cudaFuncSetAttribute(select_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)select_smem_bytes(kKMax));
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < kMaxDevices) g_smem_set[dev] = true;
  }
  select_kernel<<<dim3(S, Bp / kBM), kThreads, select_smem_bytes(k), st>>>(
      u_mat, i_mat, ib, u_idx, bitmap, W, U, I, B, Kp, nT, S, k, cand_s,
      cand_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int mw = merge_warps(S, k);
  merge_kernel<<<(B + mw - 1) / mw, mw * 32, (size_t)mw * S * (8 * k + 4),
                 st>>>(cand_s, cand_i, B, S, k, out_i, out_s);
  return (int)cudaGetLastError();
}

extern "C" const char* rfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
