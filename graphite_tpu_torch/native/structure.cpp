// Host structure discovery of the Hessian and Schur builders (freeze time).
//
// The sort, unique and pair-enumeration passes of build_hessian_structure
// and build_schur_structure (graphite_tpu_torch/{hessian,schur}.py) and of
// the reduction plans (ops/cuda/segsum.host_plan): radix and counting
// sorts, a bounded unique by flag array and prefix rank, and the fused
// Schur pair plan, which histograms the pose pairs of every landmark
// without materialising them and scatters them straight into
// destination-sorted order. Every output equals its plain NumPy version in
// graphite_tpu_torch/hostops.py bit for bit (tests/test_torch_native_
// structure.py), whatever the thread count.
//
// Plain C interface, loaded with ctypes (native/structure.py). The entry
// points that run on several threads take the thread count `nt` as their
// last argument; below a size (about 2^20 elements) they run serially,
// whatever `nt` says, so small problems pay no thread start-up.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <thread>
#include <utility>
#include <vector>

namespace {

// Run fn(t) on nt threads (t = 0..nt-1); serial when nt <= 1.
template <typename F>
void parallel_for_threads(int nt, F fn) {
  if (nt <= 1) {
    fn(0);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(static_cast<size_t>(nt) - 1);
  for (int t = 1; t < nt; ++t) ts.emplace_back(fn, t);
  fn(0);
  for (auto &th : ts) th.join();
}

// The thread count of a pass over n elements: nt, or 1 below min_n.
int threads_for(int64_t nt, int64_t n, int64_t min_n) {
  if (nt < 1 || n < min_n) return 1;
  return static_cast<int>(nt);
}

// LSD radix sort on non-negative int64 keys (11-bit digits), sorting only
// the digits needed for the maximum key. Payload-free.
void radix_sort(int64_t *keys, int64_t n, std::vector<int64_t> &tmp) {
  if (n <= 1) return;
  int64_t mx = 0;
  for (int64_t i = 0; i < n; ++i)
    if (keys[i] > mx) mx = keys[i];
  tmp.resize(static_cast<size_t>(n));
  int64_t *src = keys;
  int64_t *dst = tmp.data();
  constexpr int kBits = 11;
  constexpr int kBuckets = 1 << kBits;
  int64_t count[kBuckets];
  for (int shift = 0; shift < 63 && (mx >> shift) != 0; shift += kBits) {
    std::memset(count, 0, sizeof(count));
    for (int64_t i = 0; i < n; ++i)
      ++count[(src[i] >> shift) & (kBuckets - 1)];
    int64_t sum = 0;
    for (int b = 0; b < kBuckets; ++b) {
      int64_t c = count[b];
      count[b] = sum;
      sum += c;
    }
    for (int64_t i = 0; i < n; ++i)
      dst[count[(src[i] >> shift) & (kBuckets - 1)]++] = src[i];
    std::swap(src, dst);
  }
  if (src != keys) std::memcpy(keys, src, static_cast<size_t>(n) * 8);
}

// Parallel sort of non-negative int64 keys: per-chunk radix sorts on the
// threads, then log2(chunks) rounds of pairwise merges (each round merges
// disjoint run pairs in parallel). Serial for one thread or small n.
void parallel_radix_sort(int64_t *keys, int64_t n, int64_t nt_arg) {
  constexpr int64_t kMinChunk = int64_t(1) << 19;
  int nt = threads_for(nt_arg, n, 2 * kMinChunk);
  if (nt > 1 && n / nt < kMinChunk) nt = static_cast<int>(n / kMinChunk);
  if (nt <= 1) {
    std::vector<int64_t> tmp;
    radix_sort(keys, n, tmp);
    return;
  }
  const int64_t chunk = (n + nt - 1) / nt;
  std::vector<std::pair<int64_t, int64_t>> runs;
  for (int64_t lo = 0; lo < n; lo += chunk)
    runs.emplace_back(lo, std::min(lo + chunk, n));
  parallel_for_threads(static_cast<int>(runs.size()), [&](int t) {
    std::vector<int64_t> tmp;
    radix_sort(keys + runs[t].first, runs[t].second - runs[t].first, tmp);
  });
  std::vector<int64_t> buf(static_cast<size_t>(n));
  int64_t *src = keys;
  int64_t *dst = buf.data();
  while (runs.size() > 1) {
    std::vector<std::pair<int64_t, int64_t>> next;
    for (size_t i = 0; i < runs.size(); i += 2) {
      if (i + 1 < runs.size())
        next.emplace_back(runs[i].first, runs[i + 1].second);
      else
        next.emplace_back(runs[i]);
    }
    parallel_for_threads(static_cast<int>(next.size()), [&](int t) {
      const size_t i = static_cast<size_t>(t) * 2;
      if (i + 1 < runs.size()) {
        std::merge(src + runs[i].first, src + runs[i].second,
                   src + runs[i + 1].first, src + runs[i + 1].second,
                   dst + runs[i].first);
      } else {
        std::memcpy(dst + runs[i].first, src + runs[i].first,
                    static_cast<size_t>(runs[i].second - runs[i].first) * 8);
      }
    });
    runs.swap(next);
    std::swap(src, dst);
  }
  if (src != keys) std::memcpy(keys, src, static_cast<size_t>(n) * 8);
}

// LSD radix argsort of (key, origin) pairs by key; a and b hold n entries.
struct KV {
  int64_t k;
  int64_t v;
};

void radix_argsort(std::vector<KV> &a, std::vector<KV> &b) {
  const int64_t n = static_cast<int64_t>(a.size());
  if (n <= 1) return;
  int64_t mx = 0;
  for (const KV &e : a)
    if (e.k > mx) mx = e.k;
  KV *src = a.data();
  KV *dst = b.data();
  constexpr int kBits = 11;
  constexpr int kBuckets = 1 << kBits;
  int64_t count[kBuckets];
  bool swapped = false;
  for (int shift = 0; shift < 63 && (mx >> shift) != 0; shift += kBits) {
    std::memset(count, 0, sizeof(count));
    for (int64_t i = 0; i < n; ++i)
      ++count[(src[i].k >> shift) & (kBuckets - 1)];
    int64_t sum = 0;
    for (int b2 = 0; b2 < kBuckets; ++b2) {
      int64_t c = count[b2];
      count[b2] = sum;
      sum += c;
    }
    for (int64_t i = 0; i < n; ++i)
      dst[count[(src[i].k >> shift) & (kBuckets - 1)]++] = src[i];
    std::swap(src, dst);
    swapped = !swapped;
  }
  if (swapped) a.swap(b);
}

// The pose pairs (a <= b) of every landmark, in the order of the NumPy
// triangular decode: landmark by landmark, jj = 0..c-1, ii = 0..jj. The
// attach list is sorted by (landmark, pose); counts[l] is landmark l's
// run. pair(l, seg, jj, ii, p) is called once for each pair, p its place
// in that order. The landmarks are split into ranges of about equal pair
// counts, one per thread (serially below 2^20 pairs).
template <typename F>
void for_each_pair(const int64_t *counts, int64_t n_lm, int64_t nt_arg,
                   F pair) {
  std::vector<int64_t> seg_off(static_cast<size_t>(n_lm) + 1, 0);
  std::vector<int64_t> pair_off(static_cast<size_t>(n_lm) + 1, 0);
  for (int64_t l = 0; l < n_lm; ++l) {
    seg_off[l + 1] = seg_off[l] + counts[l];
    pair_off[l + 1] = pair_off[l] + counts[l] * (counts[l] + 1) / 2;
  }
  const int64_t total = pair_off[n_lm];
  const int nt = threads_for(nt_arg, total, int64_t(1) << 20);
  parallel_for_threads(nt, [&](int t) {
    const int64_t lo_l = std::lower_bound(pair_off.begin(), pair_off.end(),
                                          total * t / nt)
                         - pair_off.begin();
    const int64_t hi_l =
        std::lower_bound(pair_off.begin(), pair_off.end(),
                         total * (t + 1) / nt)
        - pair_off.begin();
    for (int64_t l = lo_l; l < hi_l && l < n_lm; ++l) {
      const int64_t c = counts[l];
      const int64_t seg = seg_off[l];
      int64_t p = pair_off[l];
      for (int64_t jj = 0; jj < c; ++jj)
        for (int64_t ii = 0; ii <= jj; ++ii, ++p) pair(l, seg, jj, ii, p);
    }
  });
}

}  // namespace

extern "C" {

// Sorted unique of `codes` (non-negative) into `out` (capacity n).
// Returns the number of unique values.
int64_t gx_sort_unique(const int64_t *codes, int64_t n, int64_t *out,
                       int64_t nt) {
  if (n == 0) return 0;
  std::memcpy(out, codes, static_cast<size_t>(n) * 8);
  parallel_radix_sort(out, n, nt);
  int64_t ns = 1;
  for (int64_t i = 1; i < n; ++i)
    if (out[i] != out[ns - 1]) out[ns++] = out[i];
  return ns;
}

// np.searchsorted(sorted, q, side='left') for each query.
void gx_searchsorted(const int64_t *sorted, int64_t n, const int64_t *q,
                     int64_t m, int64_t *pos, int64_t nt_arg) {
  const int nt = threads_for(nt_arg, m, int64_t(1) << 20);
  const int64_t chunk = (m + nt - 1) / nt;
  parallel_for_threads(nt, [&](int t) {
    const int64_t lo = t * chunk, hi = std::min(lo + chunk, m);
    for (int64_t i = lo; i < hi; ++i)
      pos[i] = std::lower_bound(sorted, sorted + n, q[i]) - sorted;
  });
}

// Stable sort of the Hpl attach list by (lm, pose): a counting sort over
// the landmarks, then a stable sort by pose within each landmark (equal
// poses keep their input order, as np.lexsort((pose, lm))). Writes order
// (K, indices into the inputs) and counts (n_lm); returns the pair total
// sum c*(c+1)/2.
int64_t gx_attach_sort(const int64_t *att_lm, const int64_t *att_pose,
                       int64_t K, int64_t n_lm, int64_t *order,
                       int64_t *counts, int64_t nt_arg) {
  std::memset(counts, 0, static_cast<size_t>(n_lm) * 8);
  for (int64_t i = 0; i < K; ++i) ++counts[att_lm[i]];
  std::vector<int64_t> off(static_cast<size_t>(n_lm) + 1, 0);
  for (int64_t l = 0; l < n_lm; ++l) off[l + 1] = off[l] + counts[l];
  std::vector<int64_t> cursor(off.begin(), off.end() - 1);
  for (int64_t i = 0; i < K; ++i) order[cursor[att_lm[i]]++] = i;
  // the per-landmark sorts are independent: landmark ranges of about
  // equal element counts, one per thread
  const int nt = threads_for(nt_arg, K, int64_t(1) << 20);
  std::vector<int64_t> bounds(static_cast<size_t>(nt) + 1, n_lm);
  bounds[0] = 0;
  for (int t = 1; t < nt; ++t)
    bounds[t] = std::lower_bound(off.begin(), off.end(), K * t / nt)
                - off.begin();
  std::vector<int64_t> pair_counts(static_cast<size_t>(nt), 0);
  parallel_for_threads(nt, [&](int t) {
    int64_t local = 0;
    for (int64_t l = bounds[t]; l < bounds[t + 1]; ++l) {
      const int64_t s = off[l], c = counts[l];
      std::stable_sort(order + s, order + s + c,
                       [att_pose](int64_t a, int64_t b) {
                         return att_pose[a] < att_pose[b];
                       });
      local += c * (c + 1) / 2;
    }
    pair_counts[t] = local;
  });
  int64_t total_pairs = 0;
  for (int t = 0; t < nt; ++t) total_pairs += pair_counts[t];
  return total_pairs;
}

// Every pose pair (a <= b) of every landmark (for_each_pair's order) from
// the sorted attach poses: ai / bi index the sorted attach list,
// pair_codes = pose_b * n_pose + pose_a.
void gx_pair_fill(const int64_t *counts, int64_t n_lm,
                  const int64_t *att_pose_s, int64_t n_pose, int64_t *ai,
                  int64_t *bi, int64_t *pair_lm, int64_t *pair_codes,
                  int64_t nt) {
  for_each_pair(counts, n_lm, nt,
                [&](int64_t l, int64_t seg, int64_t jj, int64_t ii,
                    int64_t p) {
                  ai[p] = seg + ii;
                  bi[p] = seg + jj;
                  pair_lm[p] = l;
                  pair_codes[p] = att_pose_s[seg + jj] * n_pose
                                  + att_pose_s[seg + ii];
                });
}

// gx_pair_fill with int32 indices, plus each pair's two pose ids.
void gx_pair_fill2(const int64_t *counts, int64_t n_lm,
                   const int64_t *att_pose_s, int64_t n_pose, int32_t *ai,
                   int32_t *bi, int32_t *pair_lm, int64_t *pair_codes,
                   int32_t *pose_a, int32_t *pose_b, int64_t nt) {
  for_each_pair(counts, n_lm, nt,
                [&](int64_t l, int64_t seg, int64_t jj, int64_t ii,
                    int64_t p) {
                  const int64_t pa = att_pose_s[seg + ii];
                  const int64_t pb = att_pose_s[seg + jj];
                  ai[p] = static_cast<int32_t>(seg + ii);
                  bi[p] = static_cast<int32_t>(seg + jj);
                  pair_lm[p] = static_cast<int32_t>(l);
                  pose_a[p] = static_cast<int32_t>(pa);
                  pose_b[p] = static_cast<int32_t>(pb);
                  pair_codes[p] = pb * n_pose + pa;
                });
}

// gx_pair_fill for one (dp, dl) group: writes each pair's left / right
// attach values (att_vals[seg + ii], att_vals[seg + jj]) directly, in
// place of ai / bi and two gathers through them.
void gx_pair_fill_vals(const int64_t *counts, int64_t n_lm,
                       const int64_t *att_pose_s, int64_t n_pose,
                       const int32_t *att_vals, int32_t *left,
                       int32_t *right, int32_t *pair_lm,
                       int64_t *pair_codes, int64_t nt) {
  for_each_pair(counts, n_lm, nt,
                [&](int64_t l, int64_t seg, int64_t jj, int64_t ii,
                    int64_t p) {
                  left[p] = att_vals[seg + ii];
                  right[p] = att_vals[seg + jj];
                  pair_lm[p] = static_cast<int32_t>(l);
                  pair_codes[p] = att_pose_s[seg + jj] * n_pose
                                  + att_pose_s[seg + ii];
                });
}

// Sorted unique + inverse (np.unique(codes, return_inverse=True)) in one
// radix pass with payload; uniq has capacity n. Returns the unique count.
// When bits(max code) + bits(n) <= 63 the key and its origin pack into one
// int64 (key << ob | origin): half the sort traffic. Wider keys sort in
// chunks that still pack, whose unique lists are merged and whose local
// ranks are remapped; the widest sort (key, origin) structs.
int64_t gx_sort_unique_inverse(const int64_t *codes, int64_t n,
                               int64_t *uniq, int64_t *inverse) {
  if (n == 0) return 0;
  int64_t mx = 0;
  for (int64_t i = 0; i < n; ++i)
    if (codes[i] > mx) mx = codes[i];
  int kb = 1, ob = 1;
  while ((mx >> kb) != 0) ++kb;
  while (((n - 1) >> ob) != 0) ++ob;
  if (kb + ob <= 63) {
    std::vector<int64_t> a(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) a[i] = (codes[i] << ob) | i;
    std::vector<int64_t> tmp;
    radix_sort(a.data(), n, tmp);
    const int64_t omask = (int64_t(1) << ob) - 1;
    int64_t ns = 0;
    int64_t prev = -1;
    for (int64_t i = 0; i < n; ++i) {
      const int64_t k = a[i] >> ob;
      if (k != prev) {
        uniq[ns++] = k;
        prev = k;
      }
      inverse[a[i] & omask] = ns - 1;
    }
    return ns;
  }
  if (kb <= 63 - 20) {
    // chunks of 2^(63 - kb) >= 2^20 codes, so the k-way merge runs over a
    // handful of lists
    const int cb = 63 - kb;  // origin bits per chunk
    const int64_t chunk = int64_t(1) << cb;
    const int64_t n_chunks = (n + chunk - 1) / chunk;
    std::vector<std::vector<int64_t>> uniqs(static_cast<size_t>(n_chunks));
    std::vector<int64_t> tmp;
    std::vector<int64_t> a;
    for (int64_t c = 0; c < n_chunks; ++c) {
      const int64_t lo = c * chunk;
      const int64_t m = std::min(chunk, n - lo);
      a.resize(static_cast<size_t>(m));
      for (int64_t i = 0; i < m; ++i) a[i] = (codes[lo + i] << cb) | i;
      radix_sort(a.data(), m, tmp);
      const int64_t omask = chunk - 1;
      auto &u = uniqs[c];
      u.reserve(static_cast<size_t>(m));
      int64_t prev = -1;
      for (int64_t i = 0; i < m; ++i) {
        const int64_t k = a[i] >> cb;
        if (k != prev) {
          u.push_back(k);
          prev = k;
        }
        // the local rank, remapped to the global one below
        inverse[lo + (a[i] & omask)] = static_cast<int64_t>(u.size()) - 1;
      }
    }
    std::vector<size_t> cur(static_cast<size_t>(n_chunks), 0);
    int64_t ns = 0;
    for (;;) {
      int64_t best = INT64_MAX;
      for (int64_t c = 0; c < n_chunks; ++c)
        if (cur[c] < uniqs[c].size() && uniqs[c][cur[c]] < best)
          best = uniqs[c][cur[c]];
      if (best == INT64_MAX) break;
      uniq[ns++] = best;
      for (int64_t c = 0; c < n_chunks; ++c)
        if (cur[c] < uniqs[c].size() && uniqs[c][cur[c]] == best) ++cur[c];
    }
    for (int64_t c = 0; c < n_chunks; ++c) {
      auto &u = uniqs[c];
      std::vector<int64_t> rank(u.size());
      for (size_t i = 0; i < u.size(); ++i)
        rank[i] = std::lower_bound(uniq, uniq + ns, u[i]) - uniq;
      const int64_t lo = c * chunk;
      const int64_t m = std::min(chunk, n - lo);
      for (int64_t i = 0; i < m; ++i)
        inverse[lo + i] = rank[inverse[lo + i]];
    }
    return ns;
  }
  std::vector<KV> a(static_cast<size_t>(n)), b(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) a[i] = {codes[i], i};
  radix_argsort(a, b);
  int64_t ns = 0;
  int64_t prev = a[0].k - 1;
  for (int64_t i = 0; i < n; ++i) {
    if (a[i].k != prev) {
      uniq[ns++] = a[i].k;
      prev = a[i].k;
    }
    inverse[a[i].v] = ns - 1;
  }
  return ns;
}

// Unique + inverse of codes in [0, bound): a flag array and a prefix rank,
// three linear passes. uniq has capacity min(n, bound). Returns the
// unique count.
int64_t gx_unique_inverse_bounded(const int64_t *codes, int64_t n,
                                  int64_t bound, int64_t *uniq,
                                  int64_t *inverse) {
  if (n == 0) return 0;
  std::vector<int32_t> rank(static_cast<size_t>(bound), 0);
  for (int64_t i = 0; i < n; ++i) rank[codes[i]] = 1;
  int64_t ns = 0;
  for (int64_t c = 0; c < bound; ++c) {
    if (rank[c]) {
      uniq[ns] = c;
      rank[c] = static_cast<int32_t>(ns++);
    } else {
      rank[c] = -1;
    }
  }
  for (int64_t i = 0; i < n; ++i) inverse[i] = rank[codes[i]];
  return ns;
}

// np.argsort(keys, kind="stable") for keys in [0, n_buckets): a counting
// sort.
void gx_counting_sort_perm(const int64_t *keys, int64_t n, int64_t n_buckets,
                           int64_t *perm) {
  std::vector<int64_t> count(static_cast<size_t>(n_buckets) + 1, 0);
  for (int64_t i = 0; i < n; ++i) ++count[keys[i] + 1];
  for (int64_t b = 0; b < n_buckets; ++b) count[b + 1] += count[b];
  for (int64_t i = 0; i < n; ++i) perm[count[keys[i]]++] = i;
}

// Stable counting sort by int32 keys in [0, n_buckets), applied to three
// int32 payloads: an int32 permutation, then one gather pass per array
// (random reads, sequential writes), on nt threads from 2^21 rows.
void gx_counting_sort_apply3_i32(const int32_t *keys, int64_t n,
                                 int64_t n_buckets, const int32_t *p0,
                                 const int32_t *p1, const int32_t *p2,
                                 int32_t *keys_out, int32_t *q0, int32_t *q1,
                                 int32_t *q2, int64_t nt_arg) {
  std::vector<int32_t> perm(static_cast<size_t>(n));
  {
    std::vector<int64_t> count(static_cast<size_t>(n_buckets) + 1, 0);
    for (int64_t i = 0; i < n; ++i) ++count[keys[i] + 1];
    for (int64_t b = 0; b < n_buckets; ++b) count[b + 1] += count[b];
    for (int64_t i = 0; i < n; ++i)
      perm[static_cast<size_t>(count[keys[i]]++)] = static_cast<int32_t>(i);
  }
  const int nt = threads_for(nt_arg, n, int64_t(1) << 21);
  const int64_t chunk = (n + nt - 1) / nt;
  parallel_for_threads(nt, [&](int t) {
    const int64_t lo = t * chunk, hi = std::min(lo + chunk, n);
    for (int64_t i = lo; i < hi; ++i) keys_out[i] = keys[perm[i]];
    for (int64_t i = lo; i < hi; ++i) q0[i] = p0[perm[i]];
    for (int64_t i = lo; i < hi; ++i) q1[i] = p1[perm[i]];
    for (int64_t i = lo; i < hi; ++i) q2[i] = p2[perm[i]];
  });
}

// The fused Schur plan of one (dp, dl) group with pair codes below
// n_pose^2: pair fill, bounded unique and the destination sort in two
// passes over the attach lists.
//   pass 1: a histogram of the pair codes (no pair is written);
//   scan:   the S sparsity = {codes with pairs} U {Hpp codes}, each code's
//           rank and the first place of its pairs in destination order;
//   pass 2: the pairs again, each written to its place (stable: the
//           generation order within a destination).
// Writes s_codes (capacity min(total + n_hpp, n_pose^2)), hpp_pos (the
// rank of each Hpp code) and left / right / mid (landmark) / dst (rank);
// returns the number of S blocks.
int64_t gx_pair_fill_sorted(const int64_t *counts, int64_t n_lm,
                            const int64_t *att_pose_s,
                            const int32_t *att_vals, int64_t n_pose,
                            const int64_t *hpp_codes, int64_t n_hpp,
                            int32_t *left, int32_t *right, int32_t *mid,
                            int32_t *dst, int64_t *s_codes,
                            int64_t *hpp_pos, int64_t nt_arg) {
  const int64_t n_codes = n_pose * n_pose;
  std::vector<int64_t> seg_off(static_cast<size_t>(n_lm) + 1, 0);
  for (int64_t l = 0; l < n_lm; ++l) seg_off[l + 1] = seg_off[l] + counts[l];
  std::vector<int32_t> cnt(static_cast<size_t>(n_codes), 0);
  std::vector<uint8_t> hflag(static_cast<size_t>(n_codes), 0);
  for (int64_t i = 0; i < n_hpp; ++i) hflag[hpp_codes[i]] = 1;
  for (int64_t l = 0; l < n_lm; ++l) {
    const int64_t c = counts[l], seg = seg_off[l];
    for (int64_t jj = 0; jj < c; ++jj) {
      const int64_t base = att_pose_s[seg + jj] * n_pose;
      for (int64_t ii = 0; ii <= jj; ++ii) ++cnt[base + att_pose_s[seg + ii]];
    }
  }
  // rank + destination-sorted start (cnt becomes the cursor)
  std::vector<int32_t> rank(static_cast<size_t>(n_codes));
  int64_t ns = 0, base = 0;
  for (int64_t code = 0; code < n_codes; ++code) {
    const int32_t c = cnt[code];
    if (c || hflag[code]) {
      s_codes[ns] = code;
      rank[code] = static_cast<int32_t>(ns++);
      cnt[code] = static_cast<int32_t>(base);
      base += c;
    }
  }
  for (int64_t i = 0; i < n_hpp; ++i) hpp_pos[i] = rank[hpp_codes[i]];
  // pass 2 writes the four payloads interleaved (one 16-byte store a
  // pair: one cache line touched, not four random streams), then splits
  // them in a sequential pass
  const int64_t total = base;
  std::vector<int32_t> buf(static_cast<size_t>(total) * 4);
  for (int64_t l = 0; l < n_lm; ++l) {
    const int64_t c = counts[l], seg = seg_off[l];
    for (int64_t jj = 0; jj < c; ++jj) {
      const int64_t pbase = att_pose_s[seg + jj] * n_pose;
      const int32_t vb = att_vals[seg + jj];
      for (int64_t ii = 0; ii <= jj; ++ii) {
        const int64_t code = pbase + att_pose_s[seg + ii];
        int32_t *q = buf.data() + static_cast<size_t>(cnt[code]++) * 4;
        q[0] = att_vals[seg + ii];
        q[1] = vb;
        q[2] = static_cast<int32_t>(l);
        q[3] = rank[code];
      }
    }
  }
  const int nt = threads_for(nt_arg, total, int64_t(1) << 21);
  const int64_t chunk = (total + nt - 1) / nt;
  parallel_for_threads(nt, [&](int t) {
    const int64_t lo = t * chunk, hi = std::min(lo + chunk, total);
    for (int64_t i = lo; i < hi; ++i) {
      const int32_t *q = buf.data() + static_cast<size_t>(i) * 4;
      left[i] = q[0];
      right[i] = q[1];
      mid[i] = q[2];
      dst[i] = q[3];
    }
  });
  return ns;
}

}  // extern "C"
