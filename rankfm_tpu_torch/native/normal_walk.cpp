// The exact walk behind the card's normal draws (`ops/init.py`): the stream
// positions whose ziggurat attempt one word does not decide, resolved in
// stream order with numpy's own arithmetic, so that the card's tables equal
// `np.random.default_rng(seed).normal(0, sigma, n).astype(np.float32)` bit
// for bit (the stream, the tables and one attempt: `csrc/ziggurat.h`).
//
// numpy's `random_standard_normal`, from the position q where a word r is
// not decided at once (rabs >= ki[idx]):
//   idx 0, the tail: xx = -inv_r * log1p(-u1), yy = -log1p(-u2) from the
//     next two words, round after round, until yy + yy > xx * xx; returns
//     r + xx, negated when bit 8 of rabs is set;
//   any other idx, the wedge: from the next word u, returns x when
//     (fi[idx - 1] - fi[idx]) * u + fi[idx] < exp((-0.5 * x) * x), else the
//     next attempt starts at the word after u.
// Words read this way start no attempt. `exp` and `log1p` are the libm
// calls numpy makes, and the build keeps every multiply and add apart
// (-ffp-contract=off; `native/__init__.py`).

#include <math.h>
#include <stdint.h>

#include "../csrc/ziggurat.h"

namespace {

const uint64_t kKi[256] = RFM_ZIG_KI;
const double kWi[256] = RFM_ZIG_WI;
const double kFi[256] = RFM_ZIG_FI;

inline void set_bit(uint32_t* mask, int64_t p, bool on) {
  const uint32_t b = 1u << (p & 31);
  mask[p >> 5] = on ? (mask[p >> 5] | b) : (mask[p >> 5] & ~b);
}

}  // namespace

extern "C" {

// numpy's tables, for the checks of the plain stage in numpy
void rfm_ziggurat_tables(uint64_t* ki, double* wi, double* fi) {
  for (int i = 0; i < 256; ++i) {
    ki[i] = kKi[i];
    wi[i] = kWi[i];
    fi[i] = kFi[i];
  }
}

// Draw T normals from N positions of the stream whose state and increment
// are (s_hi:s_lo, i_hi:i_lo), word p being the output after p + 1 steps.
//
// rec [m, 4]: {q, word q, word q + 1, word q + 2} for each position q < N
// that one word does not decide, ascending. mask [ceil(N / 32)]: bit q & 31
// of word q >> 5 set when q < N is decided by one word; on return, set when
// q starts an attempt that is accepted (the emit mask). base [segments]:
// the emits before each segment of `seg_words` mask words. out_idx,
// out_val [m]: the rank and float(0.0 + sigma * x) of each emit the walk
// resolved, by rank. stats: {emits resolved here, emits in the N positions
// (at most T), the words consumed when those reach T, else the first
// position no attempt has read, wedge attempts, tail attempts, 1 when T
// emits were reached}.
void rfm_normal_walk(const int64_t* rec, int64_t m, uint32_t* mask, int64_t N,
                     int64_t T, double sigma, uint64_t s_hi, uint64_t s_lo,
                     uint64_t i_hi, uint64_t i_lo, int64_t seg_words,
                     int64_t* base, int64_t* out_idx, float* out_val,
                     int64_t* stats) {
  const rfm_u128 s0 = ((rfm_u128)s_hi << 64) | s_lo;
  const rfm_u128 inc = ((rfm_u128)i_hi << 64) | i_lo;
  int64_t emitted = 0, cur = 0, end = -1, n_out = 0, wedge = 0, tail = 0;
  for (int64_t j = 0; j < m; ++j) {
    const int64_t q = rec[4 * j];
    const uint64_t* w = reinterpret_cast<const uint64_t*>(rec + 4 * j + 1);
    if (q < cur) continue;                   // read as a uniform before
    // every position in [cur, q) is decided by one word and emits
    if (emitted + (q - cur) >= T) {
      end = cur + (T - emitted);
      emitted = T;
      break;
    }
    emitted += q - cur;
    const uint64_t r = w[0];
    const int idx = (int)(r & 0xff);
    const uint64_t rabs = (r >> 9) & RFM_ZIG_MASK52;
    double x = (double)rabs * kWi[idx];
    if ((r >> 8) & 1) x = -x;
    int64_t k = 1;                           // the attempt's next word: q + k
    auto next = [&]() {
      const uint64_t v = k <= 2 ? w[k]
          : rfm_pcg_output(rfm_pcg_advance(s0, inc, (uint64_t)(q + k) + 1));
      ++k;
      return rfm_next_double(v);
    };
    bool ok;
    if (idx == 0) {
      ++tail;
      for (;;) {
        const double xx = -RFM_ZIG_INV_R * log1p(-next());
        const double yy = -log1p(-next());
        if (yy + yy > xx * xx) {
          x = ((rabs >> 8) & 0x1) ? -(RFM_ZIG_R + xx) : RFM_ZIG_R + xx;
          break;
        }
      }
      ok = true;
    } else {
      ++wedge;
      const double u = next();
      ok = (kFi[idx - 1] - kFi[idx]) * u + kFi[idx] < exp(-0.5 * x * x);
    }
    for (int64_t p = q + 1; p < q + k && p < N; ++p) set_bit(mask, p, false);
    cur = q + k;
    if (ok) {
      set_bit(mask, q, true);
      out_idx[n_out] = emitted;
      out_val[n_out] = (float)(0.0 + sigma * x);
      ++n_out;
      if (++emitted == T) {
        end = cur;
        break;
      }
    }
  }
  if (end < 0) {                             // after the last such position
    const int64_t rest = cur < N ? N - cur : 0;
    if (emitted + rest >= T) {
      end = cur + (T - emitted);
      emitted = T;
    } else {
      emitted += rest;
      if (cur < N) cur = N;
    }
  }
  const int64_t nw = (N + 31) / 32;
  int64_t seen = 0;
  for (int64_t s = 0; s * seg_words < nw; ++s) {
    base[s] = seen;
    const int64_t stop = (s + 1) * seg_words < nw ? (s + 1) * seg_words : nw;
    for (int64_t v = s * seg_words; v < stop; ++v)
      seen += __builtin_popcount(mask[v]);
  }
  stats[0] = n_out;
  stats[1] = emitted;
  stats[2] = end >= 0 ? end : cur;
  stats[3] = wedge;
  stats[4] = tail;
  stats[5] = end >= 0;
}

}  // extern "C"
