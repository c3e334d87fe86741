// The two halves of the bitstream's "nbr" prediction mode, exact and fast.
//
// smoe_causal_nbr(m, k, d, nbr): for k kernels at integer positions m
// (row-major k x d int64), nbr[0] = 0 and, for i >= 1,
//     nbr[i] = argmin_{j < i} |m_j - m_i|^2
// in exact int64 arithmetic, ties to the lowest j: the indices of
// codec/bitstream.py:_causal_nbr, its loop's O(K^2) replaced by a uniform
// grid of about k cells over the positions' bounding box.  Kernels enter
// the grid in index order, each after its own query.  A query scans
// Chebyshev rings of cells outward from its own and stops once every
// unscanned cell lies strictly farther than the best distance found (">",
// not ">=": a tie in a farther cell can still win on its lower index).
// The caller guarantees every axis's span is under 2^30, so no squared
// distance over d <= 4 axes overflows.  Returns 0, or -1 for d outside
// 1..4 (nbr untouched).
//
// smoe_nbr_decode(res, k, f, nbr, out): the inverse of the residuals
// against the neighbours, out[i] = res[i] + out[nbr[i]] row by row over
// k rows of f int64 components (wrapping as numpy's int64 does); the
// caller guarantees 0 <= nbr[i] < i for i >= 1.

#include <cstddef>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

constexpr int64_t kInf = std::numeric_limits<int64_t>::max();

// Number of grid cells when the cell's side is s, stopping early once it
// passes `cap` (a product over four 2^30 spans would overflow).
template <int D>
int64_t cells_at(const int64_t* span, int64_t s, int64_t cap) {
  int64_t n = 1;
  for (int a = 0; a < D; ++a) {
    n *= span[a] / s + 1;
    if (n > cap) return cap + 1;
  }
  return n;
}

template <int D>
void causal_nbr(const int64_t* m, int64_t k, int64_t* nbr) {
  if (k <= 0) return;
  nbr[0] = 0;
  if (k == 1) return;

  int64_t lo[D], span[D];
  for (int a = 0; a < D; ++a) {
    int64_t mn = m[a], mx = m[a];
    for (int64_t i = 1; i < k; ++i) {
      const int64_t v = m[i * D + a];
      mn = v < mn ? v : mn;
      mx = v > mx ? v : mx;
    }
    lo[a] = mn;
    span[a] = mx - mn;
  }
  // the least cell side whose grid has at most k cells
  int64_t s_lo = 1, s_hi = 1;
  for (int a = 0; a < D; ++a) s_hi = span[a] + 1 > s_hi ? span[a] + 1 : s_hi;
  while (s_lo < s_hi) {
    const int64_t mid = s_lo + (s_hi - s_lo) / 2;
    if (cells_at<D>(span, mid, k) <= k) s_hi = mid;
    else s_lo = mid + 1;
  }
  const int64_t s = s_lo;
  int64_t n[D], stride[D];
  int64_t ncell = 1;
  for (int a = D - 1; a >= 0; --a) {
    n[a] = span[a] / s + 1;
    stride[a] = ncell;
    ncell *= n[a];
  }

  // positions relative to the box, each kernel's cell, and the kernels
  // of each cell in index order (a stable counting sort)
  std::vector<int64_t> u(static_cast<std::size_t>(k) * D);
  std::vector<int64_t> cell(k);
  std::vector<int64_t> start(ncell + 1, 0);
  for (int64_t i = 0; i < k; ++i) {
    int64_t c = 0;
    for (int a = 0; a < D; ++a) {
      const int64_t v = m[i * D + a] - lo[a];
      u[i * D + a] = v;
      c += (v / s) * stride[a];
    }
    cell[i] = c;
    ++start[c + 1];
  }
  for (int64_t c = 0; c < ncell; ++c) start[c + 1] += start[c];
  std::vector<int64_t> order(k);
  {
    std::vector<int64_t> fill(start.begin(), start.end() - 1);
    for (int64_t i = 0; i < k; ++i) order[fill[cell[i]]++] = i;
  }
  // kernels of a cell already in the grid: the first `filled` of its list
  std::vector<int64_t> filled(ncell, 0);
  filled[cell[0]] = 1;

  for (int64_t i = 1; i < k; ++i) {
    const int64_t* q = &u[i * D];
    int64_t c[D];
    for (int a = 0; a < D; ++a) c[a] = q[a] / s;
    int64_t best = kInf, best_j = -1;

    auto scan = [&](int64_t id, const int64_t* b) {
      const int64_t cnt = filled[id];
      if (cnt == 0) return;
      // the cell's least squared distance to the query
      int64_t lb = 0;
      for (int a = 0; a < D; ++a) {
        const int64_t c0 = b[a] * s, c1 = c0 + s - 1;
        const int64_t g = q[a] < c0 ? c0 - q[a] : (q[a] > c1 ? q[a] - c1 : 0);
        lb += g * g;
      }
      if (lb > best) return;
      const int64_t* list = &order[start[id]];
      for (int64_t t = 0; t < cnt; ++t) {
        const int64_t j = list[t];
        const int64_t* p = &u[j * D];
        int64_t d2 = 0;
        for (int a = 0; a < D; ++a) {
          const int64_t g = p[a] - q[a];
          d2 += g * g;
        }
        if (d2 < best || (d2 == best && j < best_j)) {   // ties: lowest j
          best = d2;
          best_j = j;
          // a copy of the query's position sits in its own cell, whose
          // later entries all have higher indices
          if (best == 0) return;
        }
      }
    };

    for (int64_t r = 0;; ++r) {
      if (r > 0) {
        // every cell of ring >= r lies beyond the box of rings < r on
        // some axis: its gap to the query bounds the distance below
        int64_t gap = kInf;
        for (int a = 0; a < D; ++a) {
          if (c[a] - r >= 0) {
            const int64_t g = q[a] - (c[a] - r + 1) * s + 1;
            gap = g < gap ? g : gap;
          }
          if (c[a] + r <= n[a] - 1) {
            const int64_t g = (c[a] + r) * s - q[a];
            gap = g < gap ? g : gap;
          }
        }
        if (gap == kInf || gap * gap > best) break;
      }
      int64_t rlo[D], rhi[D], b[D];
      for (int a = 0; a < D; ++a) {
        rlo[a] = c[a] - r < 0 ? 0 : c[a] - r;
        rhi[a] = c[a] + r > n[a] - 1 ? n[a] - 1 : c[a] + r;
        b[a] = rlo[a];
      }
      // an odometer over the first D-1 axes; the last axis visits its
      // whole range where the others sit on the ring, else its two ends
      constexpr int L = D - 1;
      while (true) {
        bool shell = false;
        int64_t base = 0;
        for (int a = 0; a < L; ++a) {
          const int64_t o = b[a] - c[a];
          shell = shell || o == r || o == -r;
          base += b[a] * stride[a];
        }
        if (shell) {
          for (b[L] = rlo[L]; b[L] <= rhi[L]; ++b[L]) scan(base + b[L], b);
        } else {
          if (c[L] - r >= 0) {
            b[L] = c[L] - r;
            scan(base + b[L], b);
          }
          if (r > 0 && c[L] + r <= n[L] - 1) {
            b[L] = c[L] + r;
            scan(base + b[L], b);
          }
        }
        int a = L - 1;
        while (a >= 0) {
          if (++b[a] <= rhi[a]) break;
          b[a] = rlo[a];
          --a;
        }
        if (a < 0) break;
      }
    }
    nbr[i] = best_j;
    ++filled[cell[i]];
  }
}

}  // namespace

extern "C" int smoe_causal_nbr(const int64_t* m, int64_t k, int32_t d,
                               int64_t* nbr) {
  switch (d) {
    case 1: causal_nbr<1>(m, k, nbr); return 0;
    case 2: causal_nbr<2>(m, k, nbr); return 0;
    case 3: causal_nbr<3>(m, k, nbr); return 0;
    case 4: causal_nbr<4>(m, k, nbr); return 0;
    default: return -1;
  }
}

extern "C" void smoe_nbr_decode(const int64_t* res, int64_t k, int64_t f,
                                const int64_t* nbr, int64_t* out) {
  if (k <= 0) return;
  for (int64_t c = 0; c < f; ++c) out[c] = res[c];
  for (int64_t i = 1; i < k; ++i) {
    const int64_t* src = out + nbr[i] * f;
    for (int64_t c = 0; c < f; ++c)
      out[i * f + c] = static_cast<int64_t>(
          static_cast<uint64_t>(res[i * f + c]) +
          static_cast<uint64_t>(src[c]));
  }
}
