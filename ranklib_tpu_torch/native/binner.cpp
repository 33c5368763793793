// Native feature binner: bin = searchsorted(thresholds[f], value, 'left').
//
// The numpy loop in gbdt/binning.py costs ~100 ns/element (per-call
// overhead + branchy binary search); at MSLR-30K scale (3.6M docs x 136
// features) that is ~40 s of one-time setup. This kernel does the same
// search branchlessly over doc-row blocks on all cores.
//
// Exact numpy parity: searchsorted(a, v, 'left') = count of a[j] < v.
// Thresholds rows are sorted ascending and +inf-padded (so every finite
// value lands inside); ties and infinities follow IEEE < exactly like
// numpy's. (Reference behavior being reproduced: the one-time threshold
// grid of learning/tree/FeatureHistogram.java:~60.)

#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

#include "common.h"

// One shared search + thread-dealing implementation serves every entry
// point (review finding, round 5: the i32 and transposed variants had
// drifted into two parity-pinned copies of the same binary search).
// bin_features_i32 is bin_features_impl<int32_t, row-major> with
// clamp = B — a no-op for finite values (bins are <= B by construction)
// that preserves the NaN -> B rule exactly.

namespace {
// bins rows [lo_row, hi_row) of feats; a transposed out has rows of
// n_out ids. Returns the largest bin before the clamp (0 for no rows).
// Tiles of kTile rows are walked feature by feature, kLanes rows of a
// feature searched together: the feature's threshold row stays in L1,
// the lanes' searches overlap, and a transposed out takes kTile
// contiguous ids a feature.
constexpr int64_t kTile = 64;
constexpr int kLanes = 8;

template <typename T, bool TRANSPOSED>
int64_t bin_rows(const float* feats, const float* thr, T* out,
                 int64_t n_out, int64_t F, int64_t B, int64_t clamp,
                 int64_t lo_row, int64_t hi_row) {
    int64_t top = 0;
    for (int64_t i0 = lo_row; i0 < hi_row; i0 += kTile) {
        const int64_t i1 = i0 + kTile < hi_row ? i0 + kTile : hi_row;
        for (int64_t f = 0; f < F; ++f) {
            const float* t = thr + f * B;
            for (int64_t i = i0; i < i1; i += kLanes) {
                const int64_t n = i1 - i < kLanes ? i1 - i : kLanes;
                float v[kLanes] = {};
                int64_t bins[kLanes];
                for (int64_t k = 0; k < n; ++k) v[k] = feats[(i + k) * F + f];
                // shared parity-defining search (common.h): NaN -> B,
                // then the caller clamp
                ranklib_native::bin_of_k<kLanes>(t, B, v, bins);
                for (int64_t k = 0; k < n; ++k) {
                    int64_t bin = bins[k];
                    if (bin > top) top = bin;
                    if (bin > clamp) bin = clamp;
                    (TRANSPOSED ? out[f * n_out + i + k]
                                : out[(i + k) * F + f]) = static_cast<T>(bin);
                }
            }
        }
    }
    return top;
}

// Rows [N, n_out) of a transposed out are pad docs: each feature's bin of
// 0.0, as if the features had been padded with zero rows before binning.
// *max_bin (when given) receives the largest bin before the clamp.
template <typename T, bool TRANSPOSED>
int bin_features_impl(const float* feats, const float* thr, T* out,
                      int64_t N, int64_t n_out, int64_t F, int64_t B,
                      int64_t clamp, int64_t n_threads, int64_t* max_bin) {
    if (N < 0 || n_out < N || (!TRANSPOSED && n_out != N) || F <= 0 ||
        B <= 0 || clamp < 0)
        return 1;
    int64_t top = 0;
    int64_t nt = n_threads;
    if (nt <= 0) {
        nt = static_cast<int64_t>(std::thread::hardware_concurrency());
        if (nt <= 0) nt = 1;
    }
    if (nt > N) nt = N;
    if (nt == 1) {
        top = bin_rows<T, TRANSPOSED>(feats, thr, out, n_out, F, B, clamp,
                                      0, N);
    } else if (nt > 1) {
        std::vector<std::thread> threads;
        std::vector<int64_t> tops(static_cast<size_t>(nt), 0);
        threads.reserve(static_cast<size_t>(nt));
        const int64_t step = (N + nt - 1) / nt;
        for (int64_t b = 0; b < nt; ++b) {
            const int64_t lo = b * step;
            const int64_t hi = lo + step < N ? lo + step : N;
            if (lo >= hi) break;
            threads.emplace_back([=, &tops] {
                tops[b] = bin_rows<T, TRANSPOSED>(feats, thr, out, n_out, F,
                                                  B, clamp, lo, hi);
            });
        }
        for (auto& th : threads) th.join();
        for (int64_t t : tops) top = t > top ? t : top;
    }
    for (int64_t f = 0; f < F && n_out > N; ++f) {
        int64_t bin = ranklib_native::bin_of(thr + f * B, B, 0.0f);
        if (bin > top) top = bin;
        if (bin > clamp) bin = clamp;
        for (int64_t i = N; i < n_out; ++i)
            out[f * n_out + i] = static_cast<T>(bin);
    }
    if (max_bin != nullptr) *max_bin = top;
    return 0;
}
}  // namespace

extern "C" int bin_features_i32(const float* feats,   // [N, F] row-major
                                const float* thr,     // [F, B] row-major
                                int32_t* out,         // [N, F]
                                int64_t N, int64_t F, int64_t B,
                                int64_t n_threads) {
    return bin_features_impl<int32_t, false>(feats, thr, out, N, N, F, B,
                                             /*clamp=*/B, n_threads,
                                             nullptr);
}

// Upload variant: bin + clamp + narrow + TRANSPOSE in one pass.
//
// The host-binned serving path (gbdt/ensemble._eval_matrix_hostbin) used
// to run four full-matrix passes per chunk: int32 binning, an np.isnan
// mask + fancy assignment, astype(uint8/int16), and an [N,F]->[F,N]
// transpose copy — together the dominant serial term once uploads were
// pipelined (bin_ms 442 of 828 ms wall at 262K docs,
// tools/exp_serving_pipeline.py 2026-08-21). This entry fuses all four:
// values bin against the model grid, clamp to `clamp` (= n_grid; exact —
// node bins are < n_grid and every id >= n_grid routes right like NaN,
// which IEEE-compares to bin B >= clamp), and write the narrowed id
// straight into the transposed [F, n_out] layout the kernel uploads. Row
// blocks per thread, written a tile of rows a feature (bin_rows) — a
// tiled transpose by construction.
//
// The Random Forests fit (models/gbdt.bin_pad_T) takes the same pass for
// its training matrix: n_out > N appends the pad docs (bin of 0.0), and
// *max_bin reports the largest id before the clamp, so the caller knows
// whether the narrow width held every id (clamp = the width's maximum).

extern "C" int bin_features_u8_T(const float* feats, const float* thr,
                                 uint8_t* out, int64_t N, int64_t n_out,
                                 int64_t F, int64_t B, int64_t clamp,
                                 int64_t n_threads, int64_t* max_bin) {
    if (clamp > 255) return 1;
    return bin_features_impl<uint8_t, true>(feats, thr, out, N, n_out, F, B,
                                            clamp, n_threads, max_bin);
}

extern "C" int bin_features_i16_T(const float* feats, const float* thr,
                                  int16_t* out, int64_t N, int64_t n_out,
                                  int64_t F, int64_t B, int64_t clamp,
                                  int64_t n_threads, int64_t* max_bin) {
    if (clamp > 32767) return 1;
    return bin_features_impl<int16_t, true>(feats, thr, out, N, n_out, F, B,
                                            clamp, n_threads, max_bin);
}

// Capped per-feature unique collection for threshold building
// (gbdt/binning.py compute_thresholds). One row-major pass maintaining a
// small linear-probing set per feature (cap+1 entries decide "more than
// cap uniques", which is all the caller needs: <=tc uniques -> use them
// all, else an evenly spaced grid from min/max). -0.0 normalizes to +0.0
// like np.unique's ordering treats them equal.
//
// out_vals: [F, cap] (unsorted uniques; valid for features whose
// out_counts[f] <= cap), out_counts: [F] (= cap+1 when over cap),
// out_minmax: [F, 2].

#include <cstring>

using ranklib_native::CappedSet;
using ranklib_native::capped_insert;

extern "C" int feature_uniques(const float* feats,     // [N, F] row-major
                               int64_t N, int64_t F, int64_t cap,
                               float* out_vals,        // [F, cap]
                               int64_t* out_counts,    // [F]
                               float* out_minmax) {    // [F, 2]
    if (N <= 0 || F <= 0 || cap <= 0 || cap > 400) return 1;
    std::vector<CappedSet> sets(static_cast<size_t>(F));
    for (auto& s : sets) {
        std::memset(s.used, 0, sizeof(s.used));
        s.count = 0;
        s.dead = false;
    }
    // +/-inf seeds: NaN never wins a < / > compare, so NaN can never
    // poison the minmax (a row-0 seed let a leading NaN stick,
    // diverging from the numpy fallback's finite-only rule)
    std::vector<float> mn(static_cast<size_t>(F), INFINITY);
    std::vector<float> mx(static_cast<size_t>(F), -INFINITY);
    for (int64_t i = 0; i < N; ++i) {
        const float* row = feats + i * F;
        for (int64_t f = 0; f < F; ++f) {
            const float v = row[f];
            if (v < mn[f]) mn[f] = v;
            if (v > mx[f]) mx[f] = v;
            capped_insert(sets[f], v, out_vals + f * cap, cap);
        }
    }
    for (int64_t f = 0; f < F; ++f) {
        out_counts[f] = sets[f].dead ? cap + 1 : sets[f].count;
        if (mn[f] > mx[f]) {  // no finite value seen (all NaN)
            mn[f] = 0.0f;
            mx[f] = 0.0f;
        }
        out_minmax[f * 2] = mn[f];
        out_minmax[f * 2 + 1] = mx[f];
    }
    return 0;
}
