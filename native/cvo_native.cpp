// Native runtime components for unified_cvo_tpu.
//
// The reference keeps its measurement-processing hot path in native code
// (vendored libelas stereo matcher, thirdparty/libelas/, ~11k LoC C++/SSE;
// reference src/utils/StaticStereo.cpp:22-63 drives it). This library is the
// framework's equivalent: a from-scratch census/semi-global stereo matcher
// plus a hash-grid voxel downsampler, exported with a plain C ABI consumed
// via ctypes (unified_cvo_tpu/native/__init__.py).
//
// Build: make -C native   (produces libcvo_native.so)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <unordered_map>
#include <vector>

#ifdef __AVX2__
#include <immintrin.h>
#endif

namespace {

// One SGM recurrence step over the disparity axis, vectorized (scalar
// aggregation passes were 20x slower than cv2's SGBM).
// Lp is the PADDED previous path-cost row: Lp[0] and Lp[D+1] hold 0xFFFF
// sentinels so Lp[d +- 1] needs no branches; Lc is likewise padded.
// Computes Lc[1..D] = clamp(c + min(Lp[d], Lp[d+-1]+P1, minprev+P2)
//                           - minprev, 60000) and returns min(Lc).
inline uint16_t sgm_step_row(const uint16_t* c, const uint16_t* Lp,
                             uint16_t minprev, int D, int P1, int P2,
                             bool has_prev, uint16_t* Lc) {
  if (!has_prev) {
    uint16_t m = 0xFFFF;
    for (int d = 0; d < D; ++d) {
      uint16_t vv = std::min<uint16_t>(c[d], 60000);
      Lc[d + 1] = vv;
      if (vv < m) m = vv;
    }
    return m;
  }
#ifdef __AVX2__
  const __m256i vP1 = _mm256_set1_epi16(static_cast<short>(P1));
  const __m256i cap = _mm256_set1_epi16(static_cast<short>(60000));
  const __m256i vmp = _mm256_set1_epi16(static_cast<short>(minprev));
  const __m256i vmp2 = _mm256_set1_epi16(
      static_cast<short>(std::min<uint32_t>(minprev + P2, 0xFFFF)));
  __m256i vmin = _mm256_set1_epi16(-1);  // 0xFFFF in every lane (unsigned)
  int d = 0;
  for (; d + 16 <= D; d += 16) {
    __m256i lp = _mm256_loadu_si256(
        reinterpret_cast<const __m256i*>(Lp + 1 + d));
    __m256i lm = _mm256_loadu_si256(
        reinterpret_cast<const __m256i*>(Lp + d));
    __m256i lpx = _mm256_loadu_si256(
        reinterpret_cast<const __m256i*>(Lp + 2 + d));
    __m256i best = _mm256_min_epu16(
        lp, _mm256_min_epu16(_mm256_adds_epu16(lm, vP1),
                             _mm256_adds_epu16(lpx, vP1)));
    best = _mm256_min_epu16(best, vmp2);
    __m256i cv = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(c + d));
    // best >= minprev (minprev = min over Lp), so the subtract is exact
    __m256i v = _mm256_adds_epu16(cv, _mm256_subs_epu16(best, vmp));
    v = _mm256_min_epu16(v, cap);
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(Lc + 1 + d), v);
    vmin = _mm256_min_epu16(vmin, v);
  }
  alignas(32) uint16_t mv[16];
  _mm256_store_si256(reinterpret_cast<__m256i*>(mv), vmin);
  uint16_t mincur = 0xFFFF;
  for (int k = 0; k < 16; ++k) mincur = std::min(mincur, mv[k]);
  for (; d < D; ++d) {
    uint32_t best = Lp[1 + d];
    best = std::min<uint32_t>(best, static_cast<uint32_t>(Lp[d]) + P1);
    best = std::min<uint32_t>(best, static_cast<uint32_t>(Lp[2 + d]) + P1);
    best = std::min<uint32_t>(best, static_cast<uint32_t>(minprev) + P2);
    uint16_t vv = static_cast<uint16_t>(
        std::min<uint32_t>(c[d] + best - minprev, 60000));
    Lc[1 + d] = vv;
    if (vv < mincur) mincur = vv;
  }
  return mincur;
#else
  uint16_t mincur = 0xFFFF;
  for (int d = 0; d < D; ++d) {
    uint32_t best = Lp[1 + d];
    best = std::min<uint32_t>(best, static_cast<uint32_t>(Lp[d]) + P1);
    best = std::min<uint32_t>(best, static_cast<uint32_t>(Lp[2 + d]) + P1);
    best = std::min<uint32_t>(best, static_cast<uint32_t>(minprev) + P2);
    uint16_t vv = static_cast<uint16_t>(
        std::min<uint32_t>(c[d] + best - minprev, 60000));
    Lc[1 + d] = vv;
    if (vv < mincur) mincur = vv;
  }
  return mincur;
#endif
}

constexpr int kCensusR = 2;  // 5x5 census window

inline int popcount32(uint32_t v) { return __builtin_popcount(v); }

// 5x5 census transform (24-bit signature per pixel).
void census_transform(const uint8_t* img, int h, int w, uint32_t* out) {
  const int R = kCensusR;
  auto worker = [&](int y0, int y1) {
    for (int y = y0; y < y1; ++y) {
      for (int x = 0; x < w; ++x) {
        uint32_t sig = 0;
        const uint8_t c = img[y * w + x];
        for (int dy = -R; dy <= R; ++dy) {
          for (int dx = -R; dx <= R; ++dx) {
            if (dy == 0 && dx == 0) continue;
            int yy = std::min(std::max(y + dy, 0), h - 1);
            int xx = std::min(std::max(x + dx, 0), w - 1);
            sig = (sig << 1) | (img[yy * w + xx] < c ? 1u : 0u);
          }
        }
        out[y * w + x] = sig;
      }
    }
  };
  int nt = std::max(1u, std::thread::hardware_concurrency());
  std::vector<std::thread> ts;
  int rows = (h + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int y0 = t * rows, y1 = std::min(h, y0 + rows);
    if (y0 < y1) ts.emplace_back(worker, y0, y1);
  }
  for (auto& t : ts) t.join();
}

// agg[d] += Lc[1 + d] (u16 -> u32 widen-accumulate).
inline void accumulate_row(uint32_t* a, const uint16_t* Lc1, int D) {
#ifdef __AVX2__
  int d = 0;
  for (; d + 8 <= D; d += 8) {
    __m128i v16 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(Lc1 + d));
    __m256i v32 = _mm256_cvtepu16_epi32(v16);
    __m256i acc = _mm256_loadu_si256(reinterpret_cast<__m256i*>(a + d));
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(a + d),
                        _mm256_add_epi32(acc, v32));
  }
  for (; d < D; ++d) a[d] += Lc1[d];
#else
  for (int d = 0; d < D; ++d) a[d] += Lc1[d];
#endif
}

// One SGM aggregation pass along direction (dx, dy), accumulating into
// agg. Every direction's scanlines are mutually independent, so each pass
// threads over ITS OWN scanlines and accumulates in place — the round-3
// design materialized four private [h*w*D] u16 volumes for the
// non-horizontal passes and reduced them afterwards, ~330 MB of pure
// traffic this removes.
void aggregate_pass(const uint16_t* cost, int h, int w, int D, int dx,
                    int dy, int P1, int P2, uint32_t* agg) {
  if (dx == 0) {
    // pure vertical: every column is independent — walk ROW-MAJOR over a
    // column band per thread (contiguous cost/agg reads per row, one
    // padded L row per column) instead of column-at-a-time strided walks
    auto worker = [&](int xb0, int xb1) {
      const int Dp = D + 2;
      std::vector<uint16_t> Lband(static_cast<size_t>(xb1 - xb0) * Dp,
                                  0xFFFF);
      std::vector<uint16_t> Lc(Dp, 0xFFFF);
      std::vector<uint16_t> minprev(xb1 - xb0, 0);
      int ys = dy > 0 ? 0 : h - 1, ye = dy > 0 ? h : -1;
      bool first = true;
      for (int y = ys; y != ye; y += dy) {
        for (int x = xb0; x < xb1; ++x) {
          const uint16_t* c = cost + (static_cast<size_t>(y) * w + x) * D;
          uint32_t* a = agg + (static_cast<size_t>(y) * w + x) * D;
          uint16_t* Lp = Lband.data() + static_cast<size_t>(x - xb0) * Dp;
          uint16_t m = sgm_step_row(c, Lp, minprev[x - xb0], D, P1, P2,
                                    !first, Lc.data());
          accumulate_row(a, Lc.data() + 1, D);
          std::memcpy(Lp + 1, Lc.data() + 1,
                      static_cast<size_t>(D) * sizeof(uint16_t));
          minprev[x - xb0] = m;
        }
        first = false;
      }
    };
    int nt = std::max(1u, std::thread::hardware_concurrency());
    std::vector<std::thread> ts;
    int cols = (w + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
      int x0 = t * cols, x1 = std::min(w, x0 + cols);
      if (x0 < x1) ts.emplace_back(worker, x0, x1);
    }
    for (auto& t : ts) t.join();
    return;
  }
  // scanline start pixels
  std::vector<std::pair<int, int>> starts;
  if (dy == 0) {
    int x0 = dx > 0 ? 0 : w - 1;
    for (int y = 0; y < h; ++y) starts.emplace_back(x0, y);
  } else if (dx == 0) {
    int y0 = dy > 0 ? 0 : h - 1;
    for (int x = 0; x < w; ++x) starts.emplace_back(x, y0);
  } else {
    int x0 = dx > 0 ? 0 : w - 1;
    int y0 = dy > 0 ? 0 : h - 1;
    for (int x = 0; x < w; ++x) starts.emplace_back(x, y0);
    for (int y = (dy > 0 ? 1 : h - 2); y >= 0 && y < h; y += (dy > 0 ? 1 : -1))
      starts.emplace_back(x0, y);
  }
  auto worker = [&](size_t s0, size_t s1) {
    std::vector<uint16_t> Lp(D + 2, 0xFFFF), Lc(D + 2, 0xFFFF);
    for (size_t s = s0; s < s1; ++s) {
      int x = starts[s].first, y = starts[s].second;
      uint16_t minprev = 0;
      bool first = true;
      while (x >= 0 && x < w && y >= 0 && y < h) {
        const uint16_t* c = cost + (static_cast<size_t>(y) * w + x) * D;
        uint32_t* a = agg + (static_cast<size_t>(y) * w + x) * D;
        uint16_t mincur = sgm_step_row(c, Lp.data(), minprev, D, P1, P2,
                                       !first, Lc.data());
        accumulate_row(a, Lc.data() + 1, D);
        std::swap(Lp, Lc);
        minprev = mincur;
        first = false;
        x += dx;
        y += dy;
      }
    }
  };
  int nt = std::max(1u, std::thread::hardware_concurrency());
  std::vector<std::thread> ts;
  size_t chunk = (starts.size() + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    size_t s0 = t * chunk, s1 = std::min(starts.size(), s0 + chunk);
    if (s0 < s1) ts.emplace_back(worker, s0, s1);
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Semi-global stereo matching. left/right: [h*w] uint8 grayscale.
// disparity_out: [h*w] float32, <= 0 where invalid.
// Returns 0 on success.
int cvo_sgm_disparity(const uint8_t* left, const uint8_t* right, int h, int w,
                      int max_disp, int p1, int p2, float uniqueness,
                      float* disparity_out) {
  if (h <= 0 || w <= 0 || max_disp <= 0 || max_disp > 256) return -1;
  const int D = max_disp;
  std::vector<uint32_t> cl(static_cast<size_t>(h) * w), cr(static_cast<size_t>(h) * w);
  census_transform(left, h, w, cl.data());
  census_transform(right, h, w, cr.data());

  // matching cost: census hamming distance (AVX2: byte-nibble LUT popcount
  // over 8 disparities per vector; the right signatures for d = 0..D-1 are
  // cr[x], cr[x-1], ... — a contiguous reversed read)
  std::vector<uint16_t> cost(static_cast<size_t>(h) * w * D);
  {
    auto worker = [&](int y0, int y1) {
#ifdef __AVX2__
      const __m256i lut = _mm256_setr_epi8(
          0, 1, 1, 2, 1, 2, 2, 3, 1, 2, 2, 3, 2, 3, 3, 4,
          0, 1, 1, 2, 1, 2, 2, 3, 1, 2, 2, 3, 2, 3, 3, 4);
      const __m256i nib = _mm256_set1_epi8(0x0F);
      const __m256i rev = _mm256_setr_epi32(7, 6, 5, 4, 3, 2, 1, 0);
#endif
      for (int y = y0; y < y1; ++y) {
        for (int x = 0; x < w; ++x) {
          uint16_t* c = cost.data() + (static_cast<size_t>(y) * w + x) * D;
          uint32_t sig = cl[y * w + x];
          int dmax = std::min(D, x + 1);  // valid disparities: xr >= 0
          int d = 0;
#ifdef __AVX2__
          const __m256i vsig = _mm256_set1_epi32(static_cast<int>(sig));
          for (; d + 8 <= dmax; d += 8) {
            // cr[y*w + x - d - 7 .. x - d], reversed into disparity order
            __m256i r = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(
                cr.data() + static_cast<size_t>(y) * w + x - d - 7));
            r = _mm256_permutevar8x32_epi32(r, rev);
            __m256i v = _mm256_xor_si256(vsig, r);
            __m256i lo = _mm256_shuffle_epi8(lut, _mm256_and_si256(v, nib));
            __m256i hi = _mm256_shuffle_epi8(
                lut, _mm256_and_si256(_mm256_srli_epi16(v, 4), nib));
            __m256i cnt8 = _mm256_add_epi8(lo, hi);       // per-byte popcount
            // horizontal add of the 4 bytes of each epi32 lane
            __m256i cnt = _mm256_madd_epi16(
                _mm256_maddubs_epi16(cnt8, _mm256_set1_epi8(1)),
                _mm256_set1_epi16(1));
            // pack 8 epi32 counts to 8 epi16 and store
            __m128i c16 = _mm_packus_epi32(
                _mm256_castsi256_si128(cnt), _mm256_extracti128_si256(cnt, 1));
            _mm_storeu_si128(reinterpret_cast<__m128i*>(c + d), c16);
          }
#endif
          for (; d < dmax; ++d)
            c[d] = static_cast<uint16_t>(popcount32(sig ^ cr[y * w + x - d]));
          for (; d < D; ++d) c[d] = 24;
        }
      }
    };
    int nt = std::max(1u, std::thread::hardware_concurrency());
    std::vector<std::thread> ts;
    int rows = (h + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
      int y0 = t * rows, y1 = std::min(h, y0 + rows);
      if (y0 < y1) ts.emplace_back(worker, y0, y1);
    }
    for (auto& t : ts) t.join();
  }

  // 6-path aggregation: each pass threads over its own (independent)
  // scanlines — rows, columns, or diagonals — with an AVX2 recurrence and
  // widen-accumulates straight into agg.
  std::vector<uint32_t> agg(static_cast<size_t>(h) * w * D, 0);
  const int dirs[6][2] = {{1, 0}, {-1, 0}, {0, 1}, {0, -1}, {1, 1}, {-1, -1}};
  for (const auto& dir : dirs)
    aggregate_pass(cost.data(), h, w, D, dir[0], dir[1], p1, p2, agg.data());

  // WTA + uniqueness + subpixel, then left-right consistency
  std::vector<float> disp_l(static_cast<size_t>(h) * w, -1.0f);
  std::vector<float> disp_r(static_cast<size_t>(h) * w, -1.0f);
  {
    auto worker = [&](int y0, int y1) {
      for (int y = y0; y < y1; ++y) {
        // left disparity
        for (int x = 0; x < w; ++x) {
          const uint32_t* a = agg.data() + (static_cast<size_t>(y) * w + x) * D;
          int best = 0;
          uint32_t bc = a[0];
          uint32_t second = std::numeric_limits<uint32_t>::max();
#ifdef __AVX2__
          {
            __m256i vmin = _mm256_set1_epi32(0x7FFFFFFF);
            __m256i vidx = _mm256_setzero_si256();
            __m256i idx = _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7);
            const __m256i inc = _mm256_set1_epi32(8);
            int d = 0;
            for (; d + 8 <= D; d += 8) {
              __m256i v = _mm256_loadu_si256(
                  reinterpret_cast<const __m256i*>(a + d));
              __m256i lt = _mm256_cmpgt_epi32(vmin, v);
              vmin = _mm256_blendv_epi8(vmin, v, lt);
              vidx = _mm256_blendv_epi8(vidx, idx, lt);
              idx = _mm256_add_epi32(idx, inc);
            }
            alignas(32) uint32_t mv[8], mi[8];
            _mm256_store_si256(reinterpret_cast<__m256i*>(mv), vmin);
            _mm256_store_si256(reinterpret_cast<__m256i*>(mi), vidx);
            bc = 0xFFFFFFFF;
            for (int k = 0; k < 8; ++k)
              if (mv[k] < bc ||
                  (mv[k] == bc && static_cast<int>(mi[k]) < best)) {
                bc = mv[k];
                best = static_cast<int>(mi[k]);
              }
            for (; d < D; ++d)
              if (a[d] < bc) { bc = a[d]; best = d; }
            // second-best excluding the winner's +-1 neighborhood
            __m256i big = _mm256_set1_epi32(0x7FFFFFFF);
            __m256i vlo = _mm256_set1_epi32(best - 2);
            __m256i vhi = _mm256_set1_epi32(best + 2);
            __m256i vsec = big;
            idx = _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7);
            d = 0;
            for (; d + 8 <= D; d += 8) {
              __m256i v = _mm256_loadu_si256(
                  reinterpret_cast<const __m256i*>(a + d));
              // near = (idx > best-2) & (idx < best+2)  <=> |idx-best|<=1
              __m256i near = _mm256_and_si256(
                  _mm256_cmpgt_epi32(idx, vlo), _mm256_cmpgt_epi32(vhi, idx));
              v = _mm256_blendv_epi8(v, big, near);
              vsec = _mm256_min_epi32(vsec, v);
              idx = _mm256_add_epi32(idx, inc);
            }
            alignas(32) uint32_t sv[8];
            _mm256_store_si256(reinterpret_cast<__m256i*>(sv), vsec);
            second = 0xFFFFFFFF;
            for (int k = 0; k < 8; ++k)
              if (sv[k] < second) second = sv[k];
            for (; d < D; ++d)
              if (std::abs(d - best) > 1 && a[d] < second) second = a[d];
          }
#else
          for (int d = 1; d < D; ++d)
            if (a[d] < bc) { bc = a[d]; best = d; }
          for (int d = 0; d < D; ++d)
            if (std::abs(d - best) > 1 && a[d] < second) second = a[d];
#endif
          if (second != std::numeric_limits<uint32_t>::max() &&
              bc * (1.0f + uniqueness) > second)
            continue;  // ambiguous
          float d = static_cast<float>(best);
          if (best > 0 && best < D - 1) {
            float c0 = a[best - 1], c1 = a[best], c2 = a[best + 1];
            float denom = c0 - 2 * c1 + c2;
            if (denom > 1e-6f) d += 0.5f * (c0 - c2) / denom;
          }
          disp_l[y * w + x] = d;
        }
        // right disparity from the same aggregated volume:
        // cost_r(xr, d) = cost_l(xr + d, d). An O(w) winner-projection
        // substitute was tried in round 4 and REVERTED: a left pixel whose
        // wrong match lands on an uncontested right pixel would compare
        // against itself and trivially pass the LR check (half-occluded
        // background pixels at occlusion edges), and the projection saved
        // no measurable wall time.
        for (int x = 0; x < w; ++x) {
          uint32_t bc2 = std::numeric_limits<uint32_t>::max();
          int best2 = -1;
          for (int d = 0; d < D; ++d) {
            int xl = x + d;
            if (xl >= w) break;
            uint32_t v = agg[(static_cast<size_t>(y) * w + xl) * D + d];
            if (v < bc2) { bc2 = v; best2 = d; }
          }
          if (best2 >= 0) disp_r[y * w + x] = static_cast<float>(best2);
        }
      }
    };
    int nt = std::max(1u, std::thread::hardware_concurrency());
    std::vector<std::thread> ts;
    int rows = (h + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
      int y0 = t * rows, y1 = std::min(h, y0 + rows);
      if (y0 < y1) ts.emplace_back(worker, y0, y1);
    }
    for (auto& t : ts) t.join();
  }

  // LR check
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      float d = disp_l[y * w + x];
      float out = -1.0f;
      if (d >= 0.5f) {
        int xr = x - static_cast<int>(d + 0.5f);
        if (xr >= 0) {
          float dr = disp_r[y * w + xr];
          if (dr >= 0 && std::abs(dr - d) <= 1.5f) out = d;
        }
      }
      disparity_out[y * w + x] = out;
    }
  }

  // 3x3 median over valid disparities (standard post-SGM salt removal;
  // cv2's SGBM applies the same class of filter internally)
  {
    std::vector<float> med(static_cast<size_t>(h) * w);
    for (int y = 0; y < h; ++y) {
      for (int x = 0; x < w; ++x) {
        float vals[9];
        int n = 0;
        for (int dy2 = -1; dy2 <= 1; ++dy2) {
          for (int dx2 = -1; dx2 <= 1; ++dx2) {
            int yy = y + dy2, xx = x + dx2;
            if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
            float v = disparity_out[yy * w + xx];
            if (v > 0) vals[n++] = v;
          }
        }
        float self = disparity_out[y * w + x];
        if (self > 0 && n >= 5) {
          std::nth_element(vals, vals + n / 2, vals + n);
          med[y * w + x] = vals[n / 2];
        } else {
          med[y * w + x] = self;
        }
      }
    }
    std::copy(med.begin(), med.end(), disparity_out);
  }

  // speckle removal: invalidate connected regions (4-neighborhood,
  // |d_i - d_j| <= 1) smaller than kSpeckleMin pixels — the cv2 SGBM
  // speckleWindowSize analogue; kills isolated LR-check survivors
  {
    constexpr int kSpeckleMin = 120;
    std::vector<int32_t> label(static_cast<size_t>(h) * w, -1);
    std::vector<int32_t> stack;
    std::vector<int32_t> region;
    for (int start = 0; start < h * w; ++start) {
      if (label[start] >= 0 || disparity_out[start] <= 0) continue;
      stack.assign(1, start);
      region.clear();
      label[start] = start;
      while (!stack.empty()) {
        int i = stack.back();
        stack.pop_back();
        region.push_back(i);
        int y = i / w, x = i - y * w;
        const int ny[4] = {y - 1, y + 1, y, y};
        const int nx[4] = {x, x, x - 1, x + 1};
        for (int k = 0; k < 4; ++k) {
          if (ny[k] < 0 || ny[k] >= h || nx[k] < 0 || nx[k] >= w) continue;
          int j = ny[k] * w + nx[k];
          if (label[j] >= 0 || disparity_out[j] <= 0) continue;
          if (std::abs(disparity_out[j] - disparity_out[i]) <= 1.0f) {
            label[j] = start;
            stack.push_back(j);
          }
        }
      }
      if (static_cast<int>(region.size()) < kSpeckleMin) {
        for (int i : region) disparity_out[i] = -1.0f;
      }
    }
  }
  return 0;
}

// Hash-grid voxel downsampling: writes up to n indices of representative
// points (first point per voxel, stable order); returns the count.
// (reference VoxelMap sample_points, utils/VoxelMap.hpp:80-157)
int cvo_voxel_downsample(const float* xyz, int n, float voxel,
                         int32_t* indices_out) {
  if (voxel <= 0) {
    for (int i = 0; i < n; ++i) indices_out[i] = i;
    return n;
  }
  std::unordered_map<uint64_t, int32_t> seen;
  seen.reserve(static_cast<size_t>(n) * 2);
  int count = 0;
  const double inv = 1.0 / voxel;
  for (int i = 0; i < n; ++i) {
    int64_t qx = static_cast<int64_t>(std::floor(xyz[3 * i] * inv));
    int64_t qy = static_cast<int64_t>(std::floor(xyz[3 * i + 1] * inv));
    int64_t qz = static_cast<int64_t>(std::floor(xyz[3 * i + 2] * inv));
    uint64_t key = (static_cast<uint64_t>(qx & 0x1FFFFF) << 42) |
                   (static_cast<uint64_t>(qy & 0x1FFFFF) << 21) |
                   static_cast<uint64_t>(qz & 0x1FFFFF);
    if (seen.emplace(key, i).second) indices_out[count++] = i;
  }
  return count;
}

}  // extern "C"
