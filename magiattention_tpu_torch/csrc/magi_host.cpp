// Host-side native backend of magiattention_tpu_torch: the planning hot
// loops that dominate key-init time for long sequences (range algebra over
// (n,2) int32 buffers, closed-form band areas, per-chunk workloads, the
// greedy dispatch solve, the FFA work-list builder and the binary-greedy
// dynamic solve). A copy of the JAX package's csrc/magi_host.cpp, but for
// one line: the binary-greedy solve orders its tiles with a stable sort, so
// it places them as the Python path does. Exposed through a plain C ABI consumed
// via ctypes (magiattention_tpu_torch/csrc_backend/ops.py); buffers are
// caller-allocated numpy arrays. Built with g++ at first use
// (csrc_backend/build.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// band geometry
// ---------------------------------------------------------------------------

// Number of unmasked (i, j) pairs with i in [i0,i1), j in [j0,j1),
// lo <= j - i <= hi. Closed form via segment decomposition: the per-row
// count f(i) = min(j1-1, i+hi) - max(j0, i+lo) + 1 (clamped at 0) is
// piecewise linear with breakpoints where each min/max switches branch.
int64_t magi_band_area(int64_t i0, int64_t i1, int64_t j0, int64_t j1,
                       int64_t lo, int64_t hi) {
  if (i0 >= i1 || j0 >= j1 || lo > hi) return 0;
  // segment boundaries (sorted, clipped to [i0, i1))
  int64_t bps[6] = {i0, i1, j1 - hi, j0 - lo, j1 - lo, j0 - hi};
  std::sort(bps, bps + 6);
  int64_t total = 0;
  for (int s = 0; s < 5; ++s) {
    int64_t a = std::max(bps[s], i0);
    int64_t b = std::min(bps[s + 1], i1);
    if (a >= b) continue;
    // f is linear on [a, b): evaluate at both ends
    auto f = [&](int64_t i) -> int64_t {
      int64_t top = std::min(j1 - 1, i + hi);
      int64_t bot = std::max(j0, i + lo);
      return top - bot + 1;
    };
    int64_t fa = f(a), fb = f(b - 1);
    if (fa <= 0 && fb <= 0) continue;
    if (fa > 0 && fb > 0) {
      total += (fa + fb) * (b - a) / 2;  // arithmetic series
      continue;
    }
    // f is linear with slope in {-1, 0, +1} and crosses zero inside the
    // segment: the positive part is a triangular series at one end
    if (fa > 0) {
      total += fa * (fa + 1) / 2;  // decreasing: fa, fa-1, ..., 1
    } else {
      total += fb * (fb + 1) / 2;  // increasing tail: 1, ..., fb
    }
  }
  return total;
}

// Per-chunk attention areas: for chunk c in [0, num_chunks), sum over slices
// of the band area restricted to q rows [c*chunk, (c+1)*chunk).
// slices: (n, 6) int64 rows (qs, qe, ks, ke, lo, hi).
void magi_chunk_areas(const int64_t* slices, int64_t n_slices,
                      int64_t chunk_size, int64_t num_chunks,
                      int64_t* out_areas) {
  std::memset(out_areas, 0, sizeof(int64_t) * num_chunks);
  for (int64_t s = 0; s < n_slices; ++s) {
    const int64_t* r = slices + s * 6;
    int64_t qs = r[0], qe = r[1], ks = r[2], ke = r[3], lo = r[4], hi = r[5];
    if (qs >= qe || ks >= ke || lo > hi) continue;
    int64_t c0 = qs / chunk_size;
    int64_t c1 = (qe + chunk_size - 1) / chunk_size;
    if (c1 > num_chunks) c1 = num_chunks;
    for (int64_t c = c0; c < c1; ++c) {
      int64_t i0 = std::max(qs, c * chunk_size);
      int64_t i1 = std::min(qe, (c + 1) * chunk_size);
      out_areas[c] += magi_band_area(i0, i1, ks, ke, lo, hi);
    }
  }
}

// ---------------------------------------------------------------------------
// range algebra over (n, 2) int32 buffers
// ---------------------------------------------------------------------------

// Sort by (start, end), drop empties, coalesce overlapping/adjacent.
// Returns the number of merged ranges written to `out` (capacity >= n).
int64_t magi_ranges_merge(const int32_t* ranges, int64_t n, int32_t* out) {
  std::vector<std::pair<int32_t, int32_t>> rs;
  rs.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    int32_t s = ranges[2 * i], e = ranges[2 * i + 1];
    if (s < e) rs.emplace_back(s, e);
  }
  std::sort(rs.begin(), rs.end());
  int64_t m = 0;
  for (auto& [s, e] : rs) {
    if (m > 0 && s <= out[2 * (m - 1) + 1]) {
      out[2 * (m - 1) + 1] = std::max(out[2 * (m - 1) + 1], e);
    } else {
      out[2 * m] = s;
      out[2 * m + 1] = e;
      ++m;
    }
  }
  return m;
}

// Coverage of `a` (merged) not covered by `b` (merged). Capacity of out:
// na + nb ranges. Returns count.
int64_t magi_ranges_holes(const int32_t* a, int64_t na, const int32_t* b,
                          int64_t nb, int32_t* out) {
  int64_t m = 0, j = 0;
  for (int64_t i = 0; i < na; ++i) {
    int32_t cur = a[2 * i], end = a[2 * i + 1];
    while (j < nb && b[2 * j + 1] <= cur) ++j;
    int64_t k = j;
    while (k < nb && b[2 * k] < end) {
      if (b[2 * k] > cur) {
        out[2 * m] = cur;
        out[2 * m + 1] = b[2 * k];
        ++m;
      }
      cur = std::max(cur, b[2 * k + 1]);
      if (cur >= end) break;
      ++k;
    }
    if (cur < end) {
      out[2 * m] = cur;
      out[2 * m + 1] = end;
      ++m;
    }
  }
  return m;
}

// Coverage intersection of two merged range lists. Capacity na + nb.
int64_t magi_ranges_overlap(const int32_t* a, int64_t na, const int32_t* b,
                            int64_t nb, int32_t* out) {
  int64_t m = 0, i = 0, j = 0;
  while (i < na && j < nb) {
    int32_t s = std::max(a[2 * i], b[2 * j]);
    int32_t e = std::min(a[2 * i + 1], b[2 * j + 1]);
    if (s < e) {
      out[2 * m] = s;
      out[2 * m + 1] = e;
      ++m;
    }
    if (a[2 * i + 1] < b[2 * j + 1]) ++i; else ++j;
  }
  return m;
}

// Map global sub-ranges into the local (concatenated) coordinates of `host`
// (merged), splitting at host-piece boundaries. Returns count, or -1 if some
// input range is not fully covered. Capacity: n + n_host per input range.
int64_t magi_ranges_make_local(const int32_t* host, int64_t nh,
                               const int32_t* ranges, int64_t n,
                               int32_t* out) {
  std::vector<int64_t> offsets(nh);
  int64_t off = 0;
  for (int64_t i = 0; i < nh; ++i) {
    offsets[i] = off;
    off += host[2 * i + 1] - host[2 * i];
  }
  int64_t m = 0;
  for (int64_t r = 0; r < n; ++r) {
    int32_t s = ranges[2 * r], e = ranges[2 * r + 1];
    if (s >= e) continue;
    int64_t covered = 0;
    for (int64_t h = 0; h < nh; ++h) {
      int32_t hs = host[2 * h], he = host[2 * h + 1];
      int32_t is = std::max(s, hs), ie = std::min(e, he);
      if (is >= ie) continue;
      out[2 * m] = static_cast<int32_t>(offsets[h] + (is - hs));
      out[2 * m + 1] = static_cast<int32_t>(offsets[h] + (ie - hs));
      ++m;
      covered += ie - is;
    }
    if (covered != e - s) return -1;
  }
  return m;
}

// ---------------------------------------------------------------------------
// dispatch solver hot loop (min-heap greedy, equal chunk counts)
// ---------------------------------------------------------------------------

// areas: (n,) int64; out_assign: (n,) int32 rank per chunk.
void magi_minheap_solve(const int64_t* areas, int64_t n, int64_t cp,
                        int64_t per_rank, int32_t* out_assign) {
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::sort(order.begin(), order.end(),
            [&](int64_t x, int64_t y) { return areas[x] > areas[y]; });
  using Item = std::pair<int64_t, int64_t>;  // (load, rank)
  std::priority_queue<Item, std::vector<Item>, std::greater<Item>> heap;
  std::vector<int64_t> count(cp, 0);
  for (int64_t r = 0; r < cp; ++r) heap.emplace(0, r);
  std::vector<Item> overflow;
  for (int64_t idx : order) {
    while (true) {
      auto [load, r] = heap.top();
      heap.pop();
      if (count[r] < per_rank) {
        out_assign[idx] = static_cast<int32_t>(r);
        ++count[r];
        heap.emplace(load + areas[idx], r);
        break;
      }
      overflow.emplace_back(load, r);
    }
    for (auto& it : overflow) heap.push(it);
    overflow.clear();
  }
}


// ---------------------------------------------------------------------------
// FFA tile-plan builder (kernels/ffa_plan.py build_ffa_plan)
// ---------------------------------------------------------------------------
// The host-side replacement of the reference's device tile schedulers
// (csrc/flexible_flash_attention/{fwd,bwd}_tile_scheduler.hpp): enumerate
// the non-empty (q_tile, k_tile, slice) work items of a band-slice list.
// Two-pass C ABI: count items per tile, then fill the flattened q-major and
// k-major work lists (per-tile cursors preserve the slice-order bucketing
// of the Python builder; is_first/is_last mark run boundaries).

static inline void magi_tile_interact(
    int64_t i0, int64_t i1, int64_t j0, int64_t j1, int64_t lo, int64_t hi,
    int* nonempty, int* full) {
  if (i0 >= i1 || j0 >= j1) { *nonempty = 0; *full = 0; return; }
  int64_t d_min = j0 - (i1 - 1);
  int64_t d_max = (j1 - 1) - i0;
  *nonempty = (d_min <= hi && d_max >= lo) ? 1 : 0;
  *full = (*nonempty && d_max <= hi && d_min >= lo) ? 1 : 0;
}

int32_t magi_ffa_plan_count(const int32_t* qr, const int32_t* kr,
                            const int32_t* lo, const int32_t* hi, int64_t n,
                            int64_t bq, int64_t bk, int64_t nqt, int64_t nkt,
                            int64_t* q_counts, int64_t* k_counts) {
  for (int64_t s = 0; s < n; ++s) {
    int64_t qs = qr[2 * s], qe = qr[2 * s + 1];
    int64_t ks = kr[2 * s], ke = kr[2 * s + 1];
    int64_t l = lo[s], h = hi[s];
    if (qs >= qe || ks >= ke || l > h) continue;
    // slices must fit the tile grids (the Python builder raises on the
    // same input; silent clamping would corrupt the caller's buffers)
    if (qs < 0 || ks < 0 || (qe + bq - 1) / bq > nqt ||
        (ke + bk - 1) / bk > nkt)
      return -1;
    for (int64_t qt = qs / bq; qt < (qe + bq - 1) / bq; ++qt) {
      int64_t i0 = std::max(qs, qt * bq), i1 = std::min(qe, (qt + 1) * bq);
      for (int64_t kt = ks / bk; kt < (ke + bk - 1) / bk; ++kt) {
        int64_t j0 = std::max(ks, kt * bk), j1 = std::min(ke, (kt + 1) * bk);
        int ne, fl;
        magi_tile_interact(i0, i1, j0, j1, l, h, &ne, &fl);
        if (ne) { q_counts[qt]++; k_counts[kt]++; }
      }
    }
  }
  return 0;
}

void magi_ffa_plan_fill(const int32_t* qr, const int32_t* kr,
                        const int32_t* lo, const int32_t* hi, int64_t n,
                        int64_t bq, int64_t bk, int64_t nqt, int64_t nkt,
                        const int64_t* q_off, const int64_t* q_cnt,
                        const int64_t* k_off, const int64_t* k_cnt,
                        int32_t* work_qt, int32_t* work_kt, int32_t* meta,
                        int32_t* work_qt_t, int32_t* work_kt_t,
                        int32_t* meta_t) {
  // meta columns: QS QE KS KE DLO DHI IS_FIRST IS_LAST IS_FULL
  std::vector<int64_t> qc(nqt, 0), kc(nkt, 0);
  for (int64_t s = 0; s < n; ++s) {
    int64_t qs = qr[2 * s], qe = qr[2 * s + 1];
    int64_t ks = kr[2 * s], ke = kr[2 * s + 1];
    int64_t l = lo[s], h = hi[s];
    if (qs >= qe || ks >= ke || l > h) continue;
    for (int64_t qt = qs / bq; qt < (qe + bq - 1) / bq; ++qt) {
      int64_t i0 = std::max(qs, qt * bq), i1 = std::min(qe, (qt + 1) * bq);
      for (int64_t kt = ks / bk; kt < (ke + bk - 1) / bk; ++kt) {
        int64_t j0 = std::max(ks, kt * bk), j1 = std::min(ke, (kt + 1) * bk);
        int ne, fl;
        magi_tile_interact(i0, i1, j0, j1, l, h, &ne, &fl);
        if (!ne) continue;
        int tile_full =
            (fl && i0 == qt * bq && i1 == (qt + 1) * bq && j0 == kt * bk &&
             j1 == (kt + 1) * bk)
                ? 1
                : 0;
        int64_t p = q_off[qt] + qc[qt];
        work_qt[p] = (int32_t)qt;
        work_kt[p] = (int32_t)kt;
        int32_t* m = meta + p * 9;
        m[0] = (int32_t)qs; m[1] = (int32_t)qe;
        m[2] = (int32_t)ks; m[3] = (int32_t)ke;
        m[4] = (int32_t)l;  m[5] = (int32_t)h;
        m[6] = qc[qt] == 0 ? 1 : 0;
        m[7] = qc[qt] == q_cnt[qt] - 1 ? 1 : 0;
        m[8] = tile_full;
        qc[qt]++;
        int64_t pt = k_off[kt] + kc[kt];
        work_qt_t[pt] = (int32_t)qt;
        work_kt_t[pt] = (int32_t)kt;
        int32_t* mt = meta_t + pt * 9;
        std::memcpy(mt, m, 6 * sizeof(int32_t));
        mt[6] = kc[kt] == 0 ? 1 : 0;
        mt[7] = kc[kt] == k_cnt[kt] - 1 ? 1 : 0;
        mt[8] = tile_full;
        kc[kt]++;
      }
    }
  }
}

}  // extern "C"


// ---------------------------------------------------------------------------
// dynamic-solver hot loop (ref: csrc/extensions/dyn_solver_alg.cpp:644
// binary_greedy_parallel_solve)
// ---------------------------------------------------------------------------

namespace {

// Sorted disjoint interval set with merge-on-insert and intersection size.
struct IntervalSet {
  // start -> end, disjoint, sorted
  std::vector<std::pair<int64_t, int64_t>> ivs;

  int64_t intersect_len(int64_t s, int64_t e) const {
    int64_t total = 0;
    // binary search for first interval with end > s
    auto it = std::lower_bound(
        ivs.begin(), ivs.end(), s,
        [](const std::pair<int64_t, int64_t>& iv, int64_t v) {
          return iv.second <= v;
        });
    for (; it != ivs.end() && it->first < e; ++it) {
      total += std::min(e, it->second) - std::max(s, it->first);
    }
    return total;
  }

  void insert(int64_t s, int64_t e) {
    if (s >= e) return;
    auto it = std::lower_bound(
        ivs.begin(), ivs.end(), s,
        [](const std::pair<int64_t, int64_t>& iv, int64_t v) {
          return iv.second < v;
        });
    auto first = it;
    while (it != ivs.end() && it->first <= e) {
      s = std::min(s, it->first);
      e = std::max(e, it->second);
      ++it;
    }
    it = ivs.erase(first, it);
    ivs.insert(it, {s, e});
  }
};

struct BgState {
  std::vector<IntervalSet> fq, fk;  // fetched q/k rows per rank
  std::vector<int64_t> load;
};

constexpr int64_t kWQO = 2;
constexpr int64_t kWKV = 2;

bool bg_greedy(const int64_t* qs, const int64_t* qe, const int64_t* ks,
               const int64_t* ke, const int64_t* area, const int32_t* qo,
               const int32_t* ko, const std::vector<int64_t>& order,
               int64_t n, int64_t cp, int64_t cap, int32_t* out) {
  BgState st;
  st.fq.resize(cp);
  st.fk.resize(cp);
  st.load.assign(cp, 0);
  for (int64_t idx : order) {
    int64_t best = -1;
    int64_t best_comm = 0, best_load = 0;
    for (int64_t r = 0; r < cp; ++r) {
      if (st.load[r] + area[idx] > cap) continue;
      int64_t comm = 0;
      if (qo[idx] != r) {
        comm += kWQO * (qe[idx] - qs[idx] -
                        st.fq[r].intersect_len(qs[idx], qe[idx]));
      }
      if (ko[idx] != r) {
        comm += kWKV * (ke[idx] - ks[idx] -
                        st.fk[r].intersect_len(ks[idx], ke[idx]));
      }
      if (best < 0 || comm < best_comm ||
          (comm == best_comm && st.load[r] < best_load)) {
        best = r;
        best_comm = comm;
        best_load = st.load[r];
      }
    }
    if (best < 0) return false;
    out[idx] = static_cast<int32_t>(best);
    st.load[best] += area[idx];
    if (qo[idx] != best) st.fq[best].insert(qs[idx], qe[idx]);
    if (ko[idx] != best) st.fk[best].insert(ks[idx], ke[idx]);
  }
  return true;
}

}  // namespace

// LPT greedy under a per-rank area cap, binary-searched to the smallest
// feasible cap. Tiles are (q,k)-owner-uniform; marginal comm cost is
// dedup-aware via per-rank fetched interval sets. Returns 0 on success.
extern "C" int32_t magi_binary_greedy_solve(const int64_t* qs, const int64_t* qe,
                                 const int64_t* ks, const int64_t* ke,
                                 const int64_t* area, const int32_t* q_owner,
                                 const int32_t* k_owner, int64_t n,
                                 int64_t cp, double slack, int64_t max_iters,
                                 int32_t* out_assign) {
  if (n == 0) return 0;
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  // stable, as Python's sorted() in BinaryGreedyParallelAlg._solve_numpy:
  // equal-area tiles keep their order, so both paths place them alike
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t x, int64_t y) { return area[x] > area[y]; });
  int64_t total = 0, amax = 0;
  for (int64_t i = 0; i < n; ++i) {
    total += area[i];
    amax = std::max(amax, area[i]);
  }
  int64_t lo = std::max((total + cp - 1) / cp, amax);
  int64_t hi = total;
  std::vector<int32_t> best(n, -1);
  std::vector<int32_t> trial(n);
  for (int64_t it = 0; it < max_iters && lo <= hi; ++it) {
    int64_t mid = (lo + hi) / 2;
    if (bg_greedy(qs, qe, ks, ke, area, q_owner, k_owner, order, n, cp, mid,
                  trial.data())) {
      best = trial;
      hi = static_cast<int64_t>(mid * (1.0 - slack)) - 1;
    } else {
      lo = mid + 1;
    }
  }
  if (best[0] < 0) {
    if (!bg_greedy(qs, qe, ks, ke, area, q_owner, k_owner, order, n, cp,
                   total, best.data())) {
      return -1;
    }
  }
  std::memcpy(out_assign, best.data(), sizeof(int32_t) * n);
  return 0;
}
