// Shared parity-critical primitives for the native helpers.
//
// binner.cpp and letor_parser.cpp both need (a) the capped per-feature
// unique set over canonicalized float bit patterns (-0.0 -> +0.0, all
// NaNs -> one key) and (b) the branchless lower_bound that DEFINES bin
// identity (count of t[j] < v; NaN -> B, numpy sort order). These used
// to live as hand-synced copies in each translation unit — and drifted
// once (review findings, round 5) — so the one definition now lives
// here. The ctypes loader treats this header as a build input: editing
// it triggers a rebuild of BOTH .so files (mtime check in loader.py).

#pragma once

#include <cstdint>
#include <cstring>

namespace ranklib_native {

struct CappedSet {
  // open addressing over float bit patterns; TABLE > 2*cap for cap <= 400
  static const int64_t TABLE = 1024;
  uint32_t keys[TABLE];
  uint8_t used[TABLE];
  int64_t count;
  bool dead;
};

inline uint32_t fbits(float v) {
  if (v == 0.0f) v = 0.0f;  // -0.0 -> +0.0
  if (v != v) return 0x7FC00000u;  // all NaNs -> one canonical key
  uint32_t b;
  memcpy(&b, &v, sizeof(b));
  return b;
}

inline void capped_insert(CappedSet& s, float v, float* vals, int64_t cap) {
  if (s.dead) return;
  const uint32_t b = fbits(v);
  uint64_t h = (static_cast<uint64_t>(b) * 0x9E3779B97F4A7C15ull) >> 54;
  while (true) {
    if (!s.used[h]) {
      if (s.count >= cap) {
        s.dead = true;
        return;
      }
      s.used[h] = 1;
      s.keys[h] = b;
      vals[s.count] = (b == 0 ? 0.0f : v);
      ++s.count;
      return;
    }
    if (s.keys[h] == b) return;
    h = (h + 1) & (CappedSet::TABLE - 1);
  }
}

// branchless lower_bound over a sorted +inf-padded row: count of
// t[j] < v for a non-NaN v — exact np.searchsorted(side='left') parity
inline int64_t lower_bound_count(const float* t, int64_t B, float v) {
  int64_t lo = 0, len = B;
  while (len > 1) {
    const int64_t half = len >> 1;
    lo += (t[lo + half - 1] < v) ? half : 0;
    len -= half;
  }
  return lo + (t[lo] < v ? 1 : 0);
}

// NaN -> B (numpy sort order puts NaN after +inf)
inline int64_t bin_of(const float* t, int64_t B, float v) {
  if (v != v) return B;
  return lower_bound_count(t, B, v);
}

}  // namespace ranklib_native
