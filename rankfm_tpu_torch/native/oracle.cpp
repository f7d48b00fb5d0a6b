// Sequential reference-semantics SGD oracle (CPU, C++).
//
// The port's copy of `rankfm_tpu/native/oracle.cpp`: the same code, built by
// `rankfm_tpu_torch/native/__init__.py` with the same flags, so both
// packages' oracles give bit-equal weights on the same inputs.
//
// An independent reimplementation of the reference's per-sample training
// loop semantics (etlundquist/rankfm, rankfm/_rankfm.pyx:122-342) used ONLY
// as a parity oracle for tests and `chip_smoke.py`: the batched epochs of
// the GPU build are validated against this oracle at the METRIC level
// (hit-rate/recall@k), per SURVEY.md §2.4 ("parity target is metric parity,
// not bitwise weight parity").
//
// Semantics mirrored exactly (with file:line citations to the reference):
//   * per-epoch shuffle of the interaction order        (_rankfm.pyx:227)
//   * WARP loop: up to max_samples rejection-sampled negatives, tracking the
//     minimum pairwise utility, early stop at the first margin violation
//     (MARGIN = 1.0)                                    (_rankfm.pyx:244-268)
//   * multiplier = log((I-1) / sampled) / log(I) with C INTEGER division
//     (the .pyx compiles with cdivision)                (_rankfm.pyx:269)
//   * d_outer = 1 / (exp(pairwise) + 1)                 (_rankfm.pyx:276)
//   * per-touch updates w += eta*(sw*mult*d_outer*d_w - 2*reg*w), including
//     the within-sample ordering where v_uf reads the ALREADY-updated v_i
//     and v_if reads the ALREADY-updated v_u            (_rankfm.pyx:279-326)
//   * feature terms skipped for zero feature values     (_rankfm.pyx:297-326)
//   * per-epoch log-likelihood sum of log sigmoid(pairwise) (_rankfm.pyx:270)
//
// RNG: the reference seeds MT19937 with 1492 for negative draws and uses the
// (caller-seeded) numpy global RNG for shuffles. Bitwise RNG parity is not a
// goal; this oracle uses std::mt19937 with a caller seed for both, keeping
// the reference's modulo draw (genrand_int32() % I, _rankfm.pyx:251).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <random>
#include <vector>

namespace {

// membership test on the user's sorted item row (the reference uses a linear
// scan, _rankfm.pyx:20-27; binary search is equivalent on sorted rows)
inline bool is_member(const int32_t* items, int32_t lo, int32_t hi, int32_t j) {
    const int32_t* first = items + lo;
    const int32_t* last = items + hi;
    const int32_t* it = std::lower_bound(first, last, j);
    return it != last && *it == j;
}

// FM utility of one (u, i) pair (_rankfm.pyx:48-89)
inline float ui_utility(int F, int P, int Q,
                        const float* x_uf_u, const float* x_if_i,
                        float w_i_i, const float* w_if,
                        const float* v_u_u, const float* v_i_i,
                        const float* v_uf, const float* v_if,
                        bool x_uf_any, bool x_if_any) {
    float res = w_i_i;
    for (int f = 0; f < F; ++f) res += v_u_u[f] * v_i_i[f];
    if (x_uf_any) {
        for (int p = 0; p < P; ++p) {
            if (x_uf_u[p] == 0.0f) continue;
            const float* vup = v_uf + (size_t)p * F;
            for (int f = 0; f < F; ++f) res += x_uf_u[p] * (vup[f] * v_i_i[f]);
        }
    }
    if (x_if_any) {
        for (int q = 0; q < Q; ++q) {
            if (x_if_i[q] == 0.0f) continue;
            res += x_if_i[q] * w_if[q];
            const float* viq = v_if + (size_t)q * F;
            for (int f = 0; f < F; ++f) res += x_if_i[q] * (viq[f] * v_u_u[f]);
        }
    }
    return res;
}

}  // namespace

extern "C" {

// Returns 0 on success, -1 when weights went non-finite (the reference
// asserts per epoch, _rankfm.pyx:328-329). ll_out[epoch] receives the raw
// (unpenalized) per-epoch log-likelihood.
int32_t rfm_oracle_fit(
    const int32_t* inter, const float* sample_weight, int64_t n,
    const int32_t* offsets, const int32_t* items,   // CSR user history
    const float* x_uf, const float* x_if,           // [U,P] / [I,Q]
    float* w_i, float* w_if,                        // [I] / [Q]
    float* v_u, float* v_i,                         // [U,F] / [I,F]
    float* v_uf, float* v_if,                       // [P,F] / [Q,F]
    int32_t U, int32_t I, int32_t P, int32_t Q, int32_t F,
    float alpha, float beta,
    float learning_rate, int32_t invscaling, float learning_exponent,
    int32_t max_samples, int32_t epochs, uint64_t seed,
    float* ll_out) {

    const float MARGIN = 1.0f;
    const float d_reg_a = 2.0f * alpha;
    const float d_reg_b = 2.0f * beta;
    const double log_I = std::log((double)I);

    bool x_uf_any = false, x_if_any = false;
    for (int64_t k = 0; k < (int64_t)U * P && !x_uf_any; ++k)
        x_uf_any = x_uf[k] != 0.0f;
    for (int64_t k = 0; k < (int64_t)I * Q && !x_if_any; ++k)
        x_if_any = x_if[k] != 0.0f;

    std::mt19937 mt((uint32_t)seed);
    std::mt19937_64 shuf(seed ^ 0x9e3779b97f4a7c15ULL);
    std::vector<int64_t> order(n);
    for (int64_t r = 0; r < n; ++r) order[r] = r;

    for (int32_t epoch = 0; epoch < epochs; ++epoch) {
        float eta = invscaling
            ? learning_rate / std::pow((float)(epoch + 1), learning_exponent)
            : learning_rate;
        std::shuffle(order.begin(), order.end(), shuf);
        double ll = 0.0;

        for (int64_t r = 0; r < n; ++r) {
            int64_t row = order[r];
            int32_t u = inter[2 * row];
            int32_t i = inter[2 * row + 1];
            float sw = sample_weight[row];
            const float* xu = x_uf + (size_t)u * P;
            const float* xi = x_if + (size_t)i * Q;
            float* vuu = v_u + (size_t)u * F;

            float ut_ui = ui_utility(F, P, Q, xu, xi, w_i[i], w_if, vuu,
                                     v_i + (size_t)i * F, v_uf, v_if,
                                     x_uf_any, x_if_any);

            // WARP loop (_rankfm.pyx:244-268)
            int32_t min_index = -1, sampled = 0;
            float min_pw = 1e6f;
            for (sampled = 1; sampled <= max_samples; ++sampled) {
                int32_t j;
                do {
                    j = (int32_t)(mt() % (uint32_t)I);
                } while (is_member(items, offsets[u], offsets[u + 1], j));
                float ut_uj = ui_utility(
                    F, P, Q, xu, x_if + (size_t)j * Q, w_i[j], w_if, vuu,
                    v_i + (size_t)j * F, v_uf, v_if, x_uf_any, x_if_any);
                float pw = ut_ui - ut_uj;
                if (pw < min_pw) { min_index = j; min_pw = pw; }
                if (pw < MARGIN) break;
            }
            if (sampled > max_samples) sampled = max_samples;  // loop ran out
            int32_t j = min_index;
            float pw = min_pw;
            float multiplier =
                (float)(std::log((double)((I - 1) / sampled)) / log_I);
            ll += std::log(1.0 / (1.0 + std::exp(-(double)pw)));

            // gradient step (_rankfm.pyx:272-326)
            float d_outer = 1.0f / (std::exp(pw) + 1.0f);
            float base = eta * sw * multiplier * d_outer;

            w_i[i] += base * 1.0f - eta * d_reg_a * w_i[i];
            w_i[j] += base * -1.0f - eta * d_reg_a * w_i[j];

            const float* xj = x_if + (size_t)j * Q;
            if (x_if_any) {
                for (int q = 0; q < Q; ++q) {
                    float d_w_if = xi[q] - xj[q];
                    w_if[q] += base * d_w_if - eta * d_reg_b * w_if[q];
                }
            }

            float* vii = v_i + (size_t)i * F;
            float* vij = v_i + (size_t)j * F;
            for (int f = 0; f < F; ++f) {
                float d_v_u = vii[f] - vij[f];
                float d_v_i = vuu[f];
                float d_v_j = -vuu[f];
                if (x_uf_any) {
                    for (int p = 0; p < P; ++p) {
                        float vupf = v_uf[(size_t)p * F + f];
                        d_v_i += vupf * xu[p];
                        d_v_j -= vupf * xu[p];
                    }
                }
                if (x_if_any) {
                    for (int q = 0; q < Q; ++q)
                        d_v_u += v_if[(size_t)q * F + f] * (xi[q] - xj[q]);
                }
                vuu[f] += base * d_v_u - eta * d_reg_a * vuu[f];
                vii[f] += base * d_v_i - eta * d_reg_a * vii[f];
                vij[f] += base * d_v_j - eta * d_reg_a * vij[f];

                // NOTE: reads the freshly-updated vii/vij/vuu — the
                // reference's within-sample ordering (_rankfm.pyx:308-326)
                if (x_uf_any) {
                    for (int p = 0; p < P; ++p) {
                        if (xu[p] == 0.0f) continue;
                        float d_v_uf = xu[p] * (vii[f] - vij[f]);
                        float& w = v_uf[(size_t)p * F + f];
                        w += base * d_v_uf - eta * d_reg_b * w;
                    }
                }
                if (x_if_any) {
                    for (int q = 0; q < Q; ++q) {
                        if (xi[q] - xj[q] == 0.0f) continue;
                        float d_v_if = (xi[q] - xj[q]) * vuu[f];
                        float& w = v_if[(size_t)q * F + f];
                        w += base * d_v_if - eta * d_reg_b * w;
                    }
                }
            }
        }

        // per-epoch finite check over the WEIGHT tables, exactly like the
        // reference (`_rankfm.pyx:328-329` / assert_finite at :95-103).
        // The log-likelihood itself may legitimately hit -inf (one sample
        // with pairwise < ~-745 overflows exp) while every weight stays
        // finite — the reference keeps training in that case (ll is
        // print-only there).
        double s = 0.0;
        for (int64_t k = 0; k < (int64_t)I; ++k) s += w_i[k];
        for (int64_t k = 0; k < (int64_t)Q; ++k) s += w_if[k];
        for (int64_t k = 0; k < (int64_t)U * F; ++k) s += v_u[k];
        for (int64_t k = 0; k < (int64_t)I * F; ++k) s += v_i[k];
        for (int64_t k = 0; k < (int64_t)P * F; ++k) s += v_uf[k];
        for (int64_t k = 0; k < (int64_t)Q * F; ++k) s += v_if[k];
        if (!std::isfinite(s)) return -1;
        ll_out[epoch] = (float)ll;
    }
    return 0;
}

}  // extern "C"
