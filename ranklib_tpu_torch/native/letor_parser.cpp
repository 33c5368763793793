// Native LETOR/SVMLight parser — the data-loading hot path.
//
// The reference parses with java.lang.String splits per line
// (ref: learning/DataPoint.java:~120 via FeatureManager.readInput,
// features/FeatureManager.java:~60); at MSLR scale (723K lines x 136
// features) an interpreted per-token loop costs minutes. This two-pass
// C parser fills caller-allocated dense numpy buffers directly:
//
//   pass 1 (letor_stat): doc count, query count (consecutive-qid
//     grouping, exactly like FeatureManager), global max fid;
//   pass 2 (letor_fill): labels, dense feature matrix (missing fids
//     stay 0 — "missing zero" semantics), query offsets, qid strings,
//     optional '#' descriptions. Tokens that exceed the fixed buffer
//     widths are NEVER truncated — the pass reports capacity (-4) and
//     the loader re-parses in Python.
//
// C ABI only — loaded from Python via ctypes (no pybind11 in this image).
// Gzip inputs and malformed files fall back to the Python parser.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "common.h"

namespace {

constexpr int64_t QID_MAX = 63;

struct LineView {
  char* p;
  char* end;
};

inline char* skip_ws(char* p, char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

// Parse one line. Returns: 1 = data line, 0 = skip (blank/comment),
// -1 = malformed, -2 = capacity exceeded (qid longer than QID_MAX or a
// wanted '#' description longer than desc_stride-1 — NEVER silently
// truncated: the caller surfaces -2 so the loader re-parses the file in
// Python, which handles arbitrary lengths). On success: *label_out, qid
// copied into qid_out (NUL-terminated), features forwarded to the
// callback, desc_out (may be null) gets the '#...' remainder.
template <bool kParseVals, typename FeatFn>
int parse_line(char* p, char* end, float* label_out, char* qid_out,
               FeatFn&& on_feat, char* desc_out, int64_t desc_stride) {
  p = skip_ws(p, end);
  if (p >= end || *p == '#') return 0;
  char* q;
  *label_out = strtof(p, &q);
  if (q == p || *label_out < 0.0f) return -1;
  p = skip_ws(q, end);
  if (end - p < 4 || strncmp(p, "qid:", 4) != 0) return -1;
  p += 4;
  int64_t n = 0;
  bool qid_over = false;
  while (p < end && *p != ' ' && *p != '\t' && *p != '\r') {
    if (n < QID_MAX) qid_out[n++] = *p;
    else qid_over = true;
    ++p;
  }
  if (n == 0) return -1;
  qid_out[n] = '\0';
  if (qid_over) return -2;
  for (;;) {
    p = skip_ws(p, end);
    if (p >= end) break;
    if (*p == '#') {
      if (desc_out != nullptr && desc_stride > 0) {
        int64_t m = end - p;
        // trim trailing whitespace
        while (m > 0 && (p[m - 1] == ' ' || p[m - 1] == '\t' ||
                         p[m - 1] == '\r'))
          --m;
        if (m > desc_stride - 1) return -2;
        memcpy(desc_out, p, static_cast<size_t>(m));
        desc_out[m] = '\0';
      }
      break;
    }
    long fid = strtol(p, &q, 10);
    if (q == p || *q != ':' || fid <= 0) return -1;
    p = q + 1;
    if (kParseVals) {
      float val = strtof(p, &q);
      if (q == p) return -1;
      p = q;
      on_feat(static_cast<int64_t>(fid), val);
    } else {
      // stat pass: only fids matter — skip the value token
      char* v = p;
      while (p < end && *p != ' ' && *p != '\t' && *p != '\r') ++p;
      if (p == v) return -1;
      on_feat(static_cast<int64_t>(fid), 0.0f);
    }
  }
  return 1;
}

// Read a whole file into memory. Returns nullptr on failure.
char* read_file(const char* path, int64_t* size_out) {
  FILE* f = fopen(path, "rb");
  if (f == nullptr) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (size < 0) {
    fclose(f);
    return nullptr;
  }
  char* buf = static_cast<char*>(malloc(static_cast<size_t>(size) + 1));
  if (buf == nullptr) {
    fclose(f);
    return nullptr;
  }
  size_t got = fread(buf, 1, static_cast<size_t>(size), f);
  fclose(f);
  if (got != static_cast<size_t>(size)) {
    free(buf);
    return nullptr;
  }
  buf[size] = '\0';
  *size_out = size;
  return buf;
}

}  // namespace

extern "C" {

// Pass 1. Returns 0 ok, -1 io error, -2 malformed line, -4 capacity
// (oversized qid — caller falls back to the Python parser).
int letor_stat(const char* path, int64_t* n_docs, int64_t* n_queries,
               int64_t* max_fid) {
  int64_t size = 0;
  char* buf = read_file(path, &size);
  if (buf == nullptr) return -1;
  int64_t docs = 0, queries = 0, maxf = 0;
  char prev_qid[QID_MAX + 1] = {0};
  char qid[QID_MAX + 1];
  char* p = buf;
  char* fend = buf + size;
  int rc = 0;
  while (p < fend) {
    char* nl = static_cast<char*>(memchr(p, '\n', fend - p));
    char* lend = (nl != nullptr) ? nl : fend;
    float label;
    int r = parse_line<false>(
        p, lend, &label, qid,
        [&](int64_t fid, float) {
          if (fid > maxf) maxf = fid;
        },
        nullptr, 0);
    if (r < 0) {
      rc = (r == -2) ? -4 : -2;
      break;
    }
    if (r == 1) {
      if (docs == 0 || strcmp(qid, prev_qid) != 0) {
        ++queries;
        strcpy(prev_qid, qid);
      }
      ++docs;
    }
    p = lend + 1;
  }
  free(buf);
  if (rc != 0) return rc;
  *n_docs = docs;
  *n_queries = queries;
  *max_fid = maxf;
  return 0;
}

// Pass 2: fill caller-allocated buffers (feats pre-zeroed [n_docs, n_feat]).
// qidbuf: n_queries * qid_stride chars; descbuf: optional, n_docs *
// desc_stride; counts: optional [n_docs] int32 — number of fid:val pairs
// per line, for the strict missing-feature check (the reference errors on
// an unspecified fid unless -missingZero: learning/DataPoint.java:~120).
// Returns 0 ok, -1 io, -2 malformed, -3 overflow vs stat,
// -4 capacity (oversized qid/desc — caller falls back to Python).
int letor_fill(const char* path, float* labels, float* feats, int64_t n_docs,
               int64_t n_feat, int64_t* qptr, int64_t n_queries, char* qidbuf,
               int64_t qid_stride, char* descbuf, int64_t desc_stride,
               int32_t* counts) {
  int64_t size = 0;
  char* buf = read_file(path, &size);
  if (buf == nullptr) return -1;
  int64_t doc = 0, query = 0;
  char prev_qid[QID_MAX + 1] = {0};
  char qid[QID_MAX + 1];
  char* p = buf;
  char* fend = buf + size;
  int rc = 0;
  while (p < fend) {
    char* nl = static_cast<char*>(memchr(p, '\n', fend - p));
    char* lend = (nl != nullptr) ? nl : fend;
    float label;
    if (doc > n_docs) {
      rc = -3;
      break;
    }
    float* row = feats + doc * n_feat;
    char* desc = (descbuf != nullptr && doc < n_docs)
                     ? descbuf + doc * desc_stride
                     : nullptr;
    int64_t npairs = 0;
    int r = parse_line<true>(
        p, lend, &label, qid,
        [&](int64_t fid, float val) {
          if (fid >= 1 && fid <= n_feat && doc < n_docs) row[fid - 1] = val;
          ++npairs;
        },
        desc, desc_stride);
    if (r < 0) {
      rc = (r == -2) ? -4 : -2;
      break;
    }
    if (r == 1) {
      if (doc >= n_docs) {
        rc = -3;
        break;
      }
      if (counts != nullptr) counts[doc] = static_cast<int32_t>(npairs);
      labels[doc] = label;
      if (doc == 0 || strcmp(qid, prev_qid) != 0) {
        if (query >= n_queries) {
          rc = -3;
          break;
        }
        qptr[query] = doc;
        strncpy(qidbuf + query * qid_stride, qid,
                static_cast<size_t>(qid_stride - 1));
        qidbuf[query * qid_stride + qid_stride - 1] = '\0';
        ++query;
        strcpy(prev_qid, qid);
      }
      ++doc;
    }
    p = lend + 1;
  }
  free(buf);
  if (rc != 0) return rc;
  if (doc != n_docs || query != n_queries) return -3;
  qptr[n_queries] = n_docs;
  return 0;
}

// Description-only pass: fill descbuf (n_docs * desc_stride) with each
// data line's '#...' remainder ('' when absent). Lets the sparse loaders
// (CSR / streamed-bin) carry docids for -qrel / -indri without re-running
// a full parse (ref: learning/SparseDataPoint.java:~15 keeps the
// description alongside the sparse fid/val arrays). Returns 0 ok, -1 io,
// -2 malformed, -3 overflow vs stat, -4 capacity (oversized qid/desc —
// caller falls back to a Python desc pass).
int letor_descs(const char* path, char* descbuf, int64_t desc_stride,
                int64_t n_docs) {
  int64_t size = 0;
  char* buf = read_file(path, &size);
  if (buf == nullptr) return -1;
  memset(descbuf, 0, static_cast<size_t>(n_docs * desc_stride));
  int64_t doc = 0;
  char qid[QID_MAX + 1];
  char* p = buf;
  char* fend = buf + size;
  int rc = 0;
  while (p < fend) {
    char* nl = static_cast<char*>(memchr(p, '\n', fend - p));
    char* lend = (nl != nullptr) ? nl : fend;
    float label;
    char* desc = (doc < n_docs) ? descbuf + doc * desc_stride : nullptr;
    int r = parse_line<false>(
        p, lend, &label, qid, [](int64_t, float) {}, desc, desc_stride);
    if (r < 0) {
      rc = (r == -2) ? -4 : -2;
      break;
    }
    if (r == 1) {
      if (doc >= n_docs) {
        rc = -3;
        break;
      }
      ++doc;
    }
    p = lend + 1;
  }
  free(buf);
  if (rc != 0) return rc;
  return (doc == n_docs) ? 0 : -3;
}

}  // extern "C"

// ---- streaming parse→bin path (wide/sparse inputs) --------------------------
//
// The dense pipeline materializes [N, F] float32 before binning — fine for
// MSLR (136 features) but the host-RAM wall for wide sparse data
// (ref: learning/SparseDataPoint.java:~15 is the reference's storage-level
// answer). These two passes keep the raw values OUT of memory entirely:
//
//   letor_value_stats: per-feature capped unique sets + min/max (the exact
//     inputs compute_thresholds needs), streamed off the file. Implicit
//     zeros of unspecified fids are folded in afterward, so decisions are
//     bit-identical to running the capped-hash pass on the dense matrix.
//   letor_fill_binned: second stream, binning each value straight to an
//     int16 bin id (same branchless lower_bound as binner.cpp) — the only
//     [N, F] array that ever exists is the 2-byte bin matrix the GBDT
//     engine uploads anyway.

namespace {

using ranklib_native::CappedSet;
using ranklib_native::bin_of;
using ranklib_native::capped_insert;

}  // namespace

extern "C" {

// Streaming per-feature value statistics. Caller sizes buffers from a
// prior letor_stat pass: out_vals [n_feat, cap], out_counts [n_feat]
// (cap+1 = over cap), out_minmax [n_feat, 2]. Returns 0 ok, -1 io,
// -2 malformed, -4 capacity (fall back to the dense Python pipeline).
int letor_value_stats(const char* path, int64_t n_feat, int64_t cap,
                      float* out_vals, int64_t* out_counts,
                      float* out_minmax) {
  if (n_feat <= 0 || cap <= 0 || cap > 400) return -2;
  int64_t size = 0;
  char* buf = read_file(path, &size);
  if (buf == nullptr) return -1;
  CappedSet* sets = static_cast<CappedSet*>(
      calloc(static_cast<size_t>(n_feat), sizeof(CappedSet)));
  int64_t* specified = static_cast<int64_t*>(
      calloc(static_cast<size_t>(n_feat), sizeof(int64_t)));
  // min/max over SPECIFIED values; implicit zeros folded in at the end
  float* mn = static_cast<float*>(malloc(sizeof(float) * n_feat));
  float* mx = static_cast<float*>(malloc(sizeof(float) * n_feat));
  if (sets == nullptr || specified == nullptr || mn == nullptr ||
      mx == nullptr) {
    free(buf); free(sets); free(specified); free(mn); free(mx);
    return -1;
  }
  for (int64_t f = 0; f < n_feat; ++f) {
    // +/-inf seeds: NaN values never win a < / > compare, so NaN can
    // never poison the minmax (the old first-value seed let a leading
    // NaN stick, diverging from the numpy fallback's finite-only rule)
    mn[f] = INFINITY;
    mx[f] = -INFINITY;
  }
  // Per-line LAST-WINS before any statistic is taken: the dense parser
  // overwrites duplicate fid:val pairs on one line, so an overwritten
  // value must not enter the unique set / min-max, and coverage must
  // count each (line, fid) once or the implicit-zero fold is skipped
  // (review finding, round 5: '1:5.0 1:7.0' put 5.0 into the grid and
  // overcounted specified — streamed grids diverged from dense).
  float* last_val = static_cast<float*>(malloc(sizeof(float) * n_feat));
  int64_t* last_line = static_cast<int64_t*>(
      calloc(static_cast<size_t>(n_feat), sizeof(int64_t)));
  std::vector<int64_t> line_fids;
  line_fids.reserve(256);
  if (last_val == nullptr || last_line == nullptr) {
    free(buf); free(sets); free(specified); free(mn); free(mx);
    free(last_val); free(last_line);
    return -1;
  }
  int64_t docs = 0;
  int64_t line_no = 0;
  char qid[QID_MAX + 1];
  char* p = buf;
  char* fend = buf + size;
  int rc = 0;
  while (p < fend) {
    char* nl = static_cast<char*>(memchr(p, '\n', fend - p));
    char* lend = (nl != nullptr) ? nl : fend;
    float label;
    ++line_no;
    line_fids.clear();
    int r = parse_line<true>(
        p, lend, &label, qid,
        [&](int64_t fid, float val) {
          if (fid >= 1 && fid <= n_feat) {
            const int64_t f = fid - 1;
            if (last_line[f] != line_no) {
              last_line[f] = line_no;
              line_fids.push_back(f);
            }
            last_val[f] = val;            // last occurrence wins
          }
        },
        nullptr, 0);
    if (r < 0) {
      rc = (r == -2) ? -4 : -2;
      break;
    }
    if (r == 1) {
      ++docs;
      for (int64_t f : line_fids) {
        const float val = last_val[f];
        if (val < mn[f]) mn[f] = val;
        if (val > mx[f]) mx[f] = val;
        ++specified[f];
        capped_insert(sets[f], val, out_vals + f * cap, cap);
      }
    }
    p = lend + 1;
  }
  free(buf);
  if (rc == 0) {
    for (int64_t f = 0; f < n_feat; ++f) {
      if (specified[f] < docs) {  // at least one implicit 0.0
        capped_insert(sets[f], 0.0f, out_vals + f * cap, cap);
        if (0.0f < mn[f]) mn[f] = 0.0f;   // valid from the +/-inf seeds
        if (0.0f > mx[f]) mx[f] = 0.0f;
      }
      if (mn[f] > mx[f]) {  // no finite value seen (all NaN / none)
        mn[f] = 0.0f;
        mx[f] = 0.0f;
      }
      out_counts[f] = sets[f].dead ? cap + 1 : sets[f].count;
      out_minmax[f * 2] = mn[f];
      out_minmax[f * 2 + 1] = mx[f];
    }
  }
  free(sets); free(specified); free(mn); free(mx);
  free(last_val); free(last_line);
  return rc;
}

// Second stream: parse + bin in one pass. thr: [n_feat, n_bins] sorted
// ascending, +inf padded. bins: [n_docs, n_feat] int16 (unspecified fids
// get the feature's bin of 0.0). Other buffers as letor_fill. Returns 0 ok,
// -1 io, -2 malformed, -3 overflow vs stat, -4 capacity, -5 bin id does
// not fit int16.
int letor_fill_binned(const char* path, const float* thr, int64_t n_bins,
                      float* labels, int16_t* bins, int64_t n_docs,
                      int64_t n_feat, int64_t* qptr, int64_t n_queries,
                      char* qidbuf, int64_t qid_stride, int32_t* counts) {
  if (n_bins <= 0 || n_bins >= 32767) return -5;
  int64_t size = 0;
  char* buf = read_file(path, &size);
  if (buf == nullptr) return -1;
  // per-feature bin of the implicit 0.0 — the row template
  int16_t* tmpl = static_cast<int16_t*>(malloc(sizeof(int16_t) * n_feat));
  if (tmpl == nullptr) {
    free(buf);
    return -1;
  }
  for (int64_t f = 0; f < n_feat; ++f)
    tmpl[f] = static_cast<int16_t>(bin_of(thr + f * n_bins, n_bins, 0.0f));
  int64_t doc = 0, query = 0;
  char prev_qid[QID_MAX + 1] = {0};
  char qid[QID_MAX + 1];
  char* p = buf;
  char* fend = buf + size;
  int rc = 0;
  while (p < fend) {
    char* nl = static_cast<char*>(memchr(p, '\n', fend - p));
    char* lend = (nl != nullptr) ? nl : fend;
    float label;
    if (doc > n_docs) {
      rc = -3;
      break;
    }
    int16_t* row = bins + doc * n_feat;
    if (doc < n_docs) memcpy(row, tmpl, sizeof(int16_t) * n_feat);
    int64_t npairs = 0;
    int r = parse_line<true>(
        p, lend, &label, qid,
        [&](int64_t fid, float val) {
          if (fid >= 1 && fid <= n_feat && doc < n_docs)
            row[fid - 1] = static_cast<int16_t>(
                bin_of(thr + (fid - 1) * n_bins, n_bins, val));
          ++npairs;
        },
        nullptr, 0);
    if (r < 0) {
      rc = (r == -2) ? -4 : -2;
      break;
    }
    if (r == 1) {
      if (doc >= n_docs) {
        rc = -3;
        break;
      }
      if (counts != nullptr) counts[doc] = static_cast<int32_t>(npairs);
      labels[doc] = label;
      if (doc == 0 || strcmp(qid, prev_qid) != 0) {
        if (query >= n_queries) {
          rc = -3;
          break;
        }
        qptr[query] = doc;
        strncpy(qidbuf + query * qid_stride, qid,
                static_cast<size_t>(qid_stride - 1));
        qidbuf[query * qid_stride + qid_stride - 1] = '\0';
        ++query;
        strcpy(prev_qid, qid);
      }
      ++doc;
    }
    p = lend + 1;
  }
  free(buf);
  free(tmpl);
  if (rc != 0) return rc;
  if (doc != n_docs || query != n_queries) return -3;
  qptr[n_queries] = n_docs;
  return 0;
}

}  // extern "C"

// ---- CSR path (raw values for wide/sparse inputs) ---------------------------
//
// The raw-value rankers (neural, linear, CoorAscent, AdaRank) need actual
// feature VALUES, which the binned stream above deliberately discards.
// These two passes land the file in host CSR — memory ~ nnz instead of
// N*F — and the Python side materializes bounded dense chunks on demand
// (ref: learning/SparseDataPoint.java:~15 fid[]/val[] storage).

extern "C" {

// Pair count pass (letor_stat does not count fid:val pairs). Returns 0 ok,
// -1 io error, -2 malformed, -4 capacity (oversized qid).
int letor_nnz(const char* path, int64_t* nnz_out) {
  int64_t size = 0;
  char* buf = read_file(path, &size);
  if (buf == nullptr) return -1;
  int64_t nnz = 0;
  char qid[QID_MAX + 1];
  char* p = buf;
  char* fend = buf + size;
  int rc = 0;
  while (p < fend) {
    char* nl = static_cast<char*>(memchr(p, '\n', fend - p));
    char* lend = (nl != nullptr) ? nl : fend;
    float label;
    int r = parse_line<false>(
        p, lend, &label, qid, [&](int64_t, float) { ++nnz; }, nullptr, 0);
    if (r < 0) {
      rc = (r == -2) ? -4 : -2;
      break;
    }
    p = lend + 1;
  }
  free(buf);
  if (rc != 0) return rc;
  *nnz_out = nnz;
  return 0;
}

// CSR fill: labels[n_docs], qptr[n_queries+1], qids, counts[n_docs]
// (fid:val pairs per line — doubles as the CSR indptr diffs AND feeds the
// strict missing-feature check), fids[nnz] int32 0-BASED, vals[nnz] f32.
// Pair order is file order; duplicate fids on one line are kept as-is so
// last-wins materialization matches letor_fill's overwrite semantics.
// Returns 0 ok, -1 io, -2 malformed, -3 overflow vs the stat/nnz passes,
// -4 capacity (oversized qid — caller falls back to Python).
int letor_fill_csr(const char* path, float* labels, int64_t n_docs,
                   int64_t* qptr, int64_t n_queries, char* qidbuf,
                   int64_t qid_stride, int32_t* fids, float* vals,
                   int64_t nnz, int32_t* counts) {
  int64_t size = 0;
  char* buf = read_file(path, &size);
  if (buf == nullptr) return -1;
  int64_t doc = 0, query = 0, pos = 0;
  char prev_qid[QID_MAX + 1] = {0};
  char qid[QID_MAX + 1];
  char* p = buf;
  char* fend = buf + size;
  int rc = 0;
  while (p < fend) {
    char* nl = static_cast<char*>(memchr(p, '\n', fend - p));
    char* lend = (nl != nullptr) ? nl : fend;
    float label;
    int64_t npairs = 0;
    bool over = false;
    int r = parse_line<true>(
        p, lend, &label, qid,
        [&](int64_t fid, float val) {
          if (pos >= nnz) {
            over = true;
            return;
          }
          fids[pos] = static_cast<int32_t>(fid - 1);
          vals[pos] = val;
          ++pos;
          ++npairs;
        },
        nullptr, 0);
    if (r < 0) {
      rc = (r == -2) ? -4 : -2;
      break;
    }
    if (over) {
      rc = -3;
      break;
    }
    if (r == 1) {
      if (doc >= n_docs) {
        rc = -3;
        break;
      }
      counts[doc] = static_cast<int32_t>(npairs);
      labels[doc] = label;
      if (doc == 0 || strcmp(qid, prev_qid) != 0) {
        if (query >= n_queries) {
          rc = -3;
          break;
        }
        qptr[query] = doc;
        strncpy(qidbuf + query * qid_stride, qid,
                static_cast<size_t>(qid_stride - 1));
        qidbuf[query * qid_stride + qid_stride - 1] = '\0';
        ++query;
        strcpy(prev_qid, qid);
      }
      ++doc;
    }
    p = lend + 1;
  }
  free(buf);
  if (rc != 0) return rc;
  if (doc != n_docs || query != n_queries || pos != nnz) return -3;
  qptr[n_queries] = n_docs;
  return 0;
}

}  // extern "C"
