// Native host-side data pipeline for rankfm_tpu_torch (a copy of
// rankfm_tpu/native/ingest.cpp with a byte cap on rfm_map_ids' range table).
//
// Training runs on the GPU; this layer accelerates the *host* stage that
// feeds it: mapping raw int64 id pairs to dense int32 indices and building
// the CSR user-history structure. pandas Series.map + groupby cost minutes
// at 10^8 rows; this does one sort.
//
// Exposed as a C ABI consumed via ctypes (rankfm_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <iterator>
#include <vector>

extern "C" {

// Sorted-unique of an int64 id column. Caller passes an output buffer of
// size n; returns the number of unique values written.
int64_t rfm_unique_sorted(const int64_t* ids, int64_t n, int64_t* out) {
    std::vector<int64_t> v(ids, ids + n);
    std::sort(v.begin(), v.end());
    auto end = std::unique(v.begin(), v.end());
    int64_t m = end - v.begin();
    std::memcpy(out, v.data(), m * sizeof(int64_t));
    return m;
}

// Open-addressing int64 -> dense-index hash (power-of-two capacity at
// <= 50% load). The ONE hash in this file: rfm_map_ids and rfm_ingest
// both use it. The empty-slot marker is vals[h] == -1 — NOT a key
// sentinel: marking empty slots with keys[h] == INT64_MIN would silently
// corrupt any vocabulary that actually CONTAINS the id INT64_MIN (its
// insert leaves the slot "empty", a later id can overwrite it, and lookups
// misattribute rows with no error).
struct IdHash {
    std::vector<int64_t> keys;
    std::vector<int32_t> vals;
    uint64_t mask;
    explicit IdHash(const int64_t* ids, int64_t m) {
        uint64_t cap = 16;
        while (cap < static_cast<uint64_t>(2 * m)) cap <<= 1;
        mask = cap - 1;
        keys.assign(cap, 0);
        vals.assign(cap, -1);  // -1 == empty (valid indices are >= 0)
        for (int64_t r = 0; r < m; ++r) {
            uint64_t h = mix(ids[r]);
            while (vals[h &= mask] != -1) ++h;
            keys[h] = ids[r];
            vals[h] = static_cast<int32_t>(r);
        }
    }
    static uint64_t mix(int64_t x) {
        uint64_t z = static_cast<uint64_t>(x) + 0x9e3779b97f4a7c15ull;
        z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
        z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
        return z ^ (z >> 31);
    }
    int32_t find(int64_t id) const {
        uint64_t h = mix(id);
        while (true) {
            h &= mask;
            if (vals[h] == -1) return -1;
            if (keys[h] == id) return vals[h];
            ++h;
        }
    }
};

// The range table of rfm_map_ids holds one int32 per value of the
// vocabulary's range. Beside the relative rule (span <= 8x the id count) it
// has this absolute cap: a larger table no longer stays in cache, and a call
// must not allocate hundreds of MB that grow with the ids' range. Beyond the
// cap the hash runs, whose size depends on the id count alone.
static const uint64_t kRangeTableMaxBytes = 64ull << 20;

// Which lookup rfm_map_ids takes for n raw ids against a sorted-unique
// vocabulary of m ids in [lo_v, hi_v]: 0 binary search, 1 range table,
// 2 hash.
int32_t rfm_map_ids_regime(int64_t n, int64_t m, int64_t lo_v, int64_t hi_v) {
    if (n * 8 < m) return 0;  // build cost ~m inserts vs n * log2(m) probes
    // unsigned subtraction: hi_v - lo_v overflows SIGNED int64 (UB) when
    // the vocabulary spans more than half the int64 range (e.g. a
    // negative sentinel beside snowflake ids) — the wrap is well-defined
    // in uint64 and the regime comparison below stays correct
    const uint64_t span =
        static_cast<uint64_t>(hi_v) - static_cast<uint64_t>(lo_v) + 1;
    // span == 0 means the range wrapped the full uint64 (lo = INT64_MIN,
    // hi = INT64_MAX) — that is the sparsest possible vocabulary, not a
    // 0-slot table
    if (span != 0 &&
        span <= static_cast<uint64_t>(std::max<int64_t>(8 * m, 1024)) &&
        span <= kRangeTableMaxBytes / sizeof(int32_t))
        return 1;
    return 2;
}

// Map raw ids to dense indices; unknown ids map to -1. Three regimes
// (a per-row binary search costs ~100 ns/id on 33k-item vocabularies and
// would dominate predict()'s host time):
//  * tiny queries against big vocabularies (n << m): keep the binary
//    search — building ANY O(m) structure would dwarf the n lookups
//    (an interactive recommend([one_user]) against a 10M-id vocabulary
//    must not allocate a 240 MB hash per call);
//  * near-contiguous vocabularies (span <= 8x the id count, and a table
//    of at most kRangeTableMaxBytes): one direct int32 lookup table over
//    the value range (~2 ns/row, cache-resident);
//  * arbitrary (snowflake-scale) ids: the IdHash above (~10-15 ns/row).
// Output contract is unchanged: the index into the sorted-unique array.
void rfm_map_ids(const int64_t* raw, int64_t n,
                 const int64_t* sorted_unique, int64_t m,
                 int32_t* out_idx) {
    if (m == 0) {
        std::fill(out_idx, out_idx + n, -1);
        return;
    }
    const int64_t lo_v = sorted_unique[0], hi_v = sorted_unique[m - 1];
    const int32_t regime = rfm_map_ids_regime(n, m, lo_v, hi_v);
    if (regime == 0) {
        const int64_t* lo = sorted_unique;
        const int64_t* hi = sorted_unique + m;
        for (int64_t r = 0; r < n; ++r) {
            const int64_t* it = std::lower_bound(lo, hi, raw[r]);
            out_idx[r] = (it != hi && *it == raw[r])
                             ? static_cast<int32_t>(it - lo)
                             : -1;
        }
        return;
    }
    if (regime == 1) {
        const uint64_t span =
            static_cast<uint64_t>(hi_v) - static_cast<uint64_t>(lo_v) + 1;
        std::vector<int32_t> table(span, -1);
        for (int64_t k = 0; k < m; ++k)
            table[static_cast<uint64_t>(sorted_unique[k] - lo_v)] =
                static_cast<int32_t>(k);
        for (int64_t r = 0; r < n; ++r) {
            const int64_t v = raw[r];
            out_idx[r] = (v >= lo_v && v <= hi_v)
                             ? table[static_cast<uint64_t>(v - lo_v)]
                             : -1;
        }
        return;
    }
    IdHash h(sorted_unique, m);
    for (int64_t r = 0; r < n; ++r) out_idx[r] = h.find(raw[r]);
}

// Build the CSR user-history structure from mapped (user_idx, item_idx)
// pairs, deduplicating repeated pairs and sorting each row ascending (the
// device-side membership test binary-searches rows).
//
// offsets_out: int32[num_users + 1]; items_out: int32[n] (only the first
// `return value` entries are meaningful). Pairs with either index < 0 are
// skipped. Returns nnz.
int64_t rfm_build_csr(const int32_t* users, const int32_t* items, int64_t n,
                      int32_t num_users,
                      int32_t* offsets_out, int32_t* items_out) {
    std::vector<std::pair<int32_t, int32_t>> p;
    p.reserve(n);
    for (int64_t r = 0; r < n; ++r) {
        if (users[r] >= 0 && items[r] >= 0) p.emplace_back(users[r], items[r]);
    }
    std::sort(p.begin(), p.end());
    p.erase(std::unique(p.begin(), p.end()), p.end());

    std::memset(offsets_out, 0, (num_users + 1) * sizeof(int32_t));
    for (auto& pr : p) offsets_out[pr.first + 1]++;
    for (int32_t u = 0; u < num_users; ++u) offsets_out[u + 1] += offsets_out[u];
    int64_t nnz = static_cast<int64_t>(p.size());
    for (int64_t r = 0; r < nnz; ++r) items_out[r] = p[r].second;
    return nnz;
}

// Order-sensitive 64-bit content hash of an id-pair column pair; used to
// detect `fit_partial` calls that re-present identical interactions so the
// CSR/bit-pack rebuild can be skipped entirely.
uint64_t rfm_hash_pairs(const int64_t* a, const int64_t* b, int64_t n) {
    uint64_t h = 1469598103934665603ull ^ static_cast<uint64_t>(n);
    for (int64_t r = 0; r < n; ++r) {
        uint64_t x = static_cast<uint64_t>(a[r]) * 0x9e3779b97f4a7c15ull
                   ^ static_cast<uint64_t>(b[r]) + 0x517cc1b727220a95ull;
        x ^= x >> 29;
        h = (h ^ x) * 0x2545f4914f6cdd1dull;
        h ^= h >> 31;
    }
    return h;
}

// One-pass ingest: map raw int64 (user, item) id pairs to dense indices,
// filter unknowns, and build the deduplicated sorted CSR user history —
// optionally unioned with a previous CSR (`fit_partial` semantics).
// Replaces four numpy passes and their intermediate copies with one
// cache-friendly sweep.
//
// pairs_out:   int32[2 * n]   (row-major [N_kept, 2], only kept rows written)
// keep_out:    uint8[n]
// offsets_out: int32[nu + 1]
// items_out:   int32[n_kept + prev_nnz] capacity
// Returns nnz of the merged CSR; writes number of kept rows to *n_kept_out.
int64_t rfm_ingest(const int64_t* u_raw, const int64_t* i_raw, int64_t n,
                   const int64_t* uids, int64_t nu,
                   const int64_t* iids, int64_t ni,
                   const int32_t* prev_offsets, const int32_t* prev_items,
                   int64_t prev_nnz,
                   int32_t* pairs_out, uint8_t* keep_out,
                   int32_t* offsets_out, int32_t* items_out,
                   int64_t* n_kept_out) {
    // 1) map + filter + emit pairs
    IdHash uh(uids, nu), ih(iids, ni);
    int64_t kept = 0;
    std::vector<int32_t> counts(nu + 1, 0);
    for (int64_t r = 0; r < n; ++r) {
        int32_t ui = uh.find(u_raw[r]);
        int32_t ii = ih.find(i_raw[r]);
        bool ok = ui >= 0 && ii >= 0;
        keep_out[r] = ok;
        if (ok) {
            pairs_out[2 * kept] = ui;
            pairs_out[2 * kept + 1] = ii;
            counts[ui + 1]++;
            ++kept;
        }
    }
    *n_kept_out = kept;

    // 2) counting-sort kept pairs by user into a scratch CSR
    std::vector<int32_t> off(nu + 1, 0);
    for (int64_t u = 0; u < nu; ++u) off[u + 1] = off[u] + counts[u + 1];
    std::vector<int32_t> scratch(kept);
    {
        std::vector<int32_t> cur(off.begin(), off.end() - 1);
        for (int64_t r = 0; r < kept; ++r)
            scratch[cur[pairs_out[2 * r]]++] = pairs_out[2 * r + 1];
    }

    // 3) per-row sort + dedup, union with the previous row if given
    int64_t nnz = 0;
    offsets_out[0] = 0;
    std::vector<int32_t> row;
    for (int64_t u = 0; u < nu; ++u) {
        int32_t* lo = scratch.data() + off[u];
        int32_t* hi = scratch.data() + off[u + 1];
        std::sort(lo, hi);
        int32_t* uniq_end = std::unique(lo, hi);
        if (prev_offsets) {
            const int32_t* plo = prev_items + prev_offsets[u];
            const int32_t* phi = prev_items + prev_offsets[u + 1];
            row.clear();
            std::set_union(lo, uniq_end, plo, phi, std::back_inserter(row));
            std::memcpy(items_out + nnz, row.data(),
                        row.size() * sizeof(int32_t));
            nnz += static_cast<int64_t>(row.size());
        } else {
            int64_t m = uniq_end - lo;
            std::memcpy(items_out + nnz, lo, m * sizeof(int32_t));
            nnz += m;
        }
        offsets_out[u + 1] = static_cast<int32_t>(nnz);
    }
    return nnz;
}

}  // extern "C"
