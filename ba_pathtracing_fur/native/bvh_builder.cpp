// Native median-split BVH clusterer.
//
// The host-side analog of KIRK's binned-SAH partition recursion
// (/root/reference/src/libraries/KIRK/CPU/CPU_Datastructures/
// CPU_BVH.cpp:357-552): recursively split primitive index ranges at the
// centroid median of the longest axis until `n_leaves` equal-size ranges
// remain. Replaces the vectorized-numpy build (ops/bvh.py build_median)
// whose per-segment python loop costs ~20 s at 1M primitives; this is
// O(N log C) of std::nth_element with a thread pool over subtrees.
//
// C ABI (ctypes):
//   void median_split(const float* centroids,   // [n, 3] row-major
//                     int64_t n,
//                     int64_t n_leaves,          // power of two
//                     int64_t* order,            // [n] in: identity / out: permutation
//                     int64_t* bounds);          // [n_leaves + 1] out: range offsets

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Ctx {
  const float* cent;  // [n,3]
  int64_t* order;
};

void split_range(const Ctx& ctx, int64_t s, int64_t e, int64_t leaves,
                 int64_t* bounds, int64_t bounds_off, int depth_budget) {
  if (leaves <= 1) {
    bounds[bounds_off] = s;
    bounds[bounds_off + 1] = e;
    return;
  }
  int64_t mid = s + (e - s + 1) / 2;
  if (e - s >= 2) {
    // longest centroid axis of this range
    float lo[3] = {3e38f, 3e38f, 3e38f}, hi[3] = {-3e38f, -3e38f, -3e38f};
    for (int64_t i = s; i < e; ++i) {
      const float* c = ctx.cent + 3 * ctx.order[i];
      for (int a = 0; a < 3; ++a) {
        lo[a] = std::min(lo[a], c[a]);
        hi[a] = std::max(hi[a], c[a]);
      }
    }
    int axis = 0;
    float best = hi[0] - lo[0];
    for (int a = 1; a < 3; ++a) {
      if (hi[a] - lo[a] > best) { best = hi[a] - lo[a]; axis = a; }
    }
    const float* cent = ctx.cent;
    std::nth_element(ctx.order + s, ctx.order + mid, ctx.order + e,
                     [cent, axis](int64_t i, int64_t j) {
                       return cent[3 * i + axis] < cent[3 * j + axis];
                     });
  }
  int64_t half = leaves / 2;
  if (depth_budget > 0 && e - s > 16384) {
    std::thread left([&] {
      split_range(ctx, s, mid, half, bounds, bounds_off, depth_budget - 1);
    });
    split_range(ctx, mid, e, leaves - half, bounds, bounds_off + half,
                depth_budget - 1);
    left.join();
  } else {
    split_range(ctx, s, mid, half, bounds, bounds_off, 0);
    split_range(ctx, mid, e, leaves - half, bounds, bounds_off + half, 0);
  }
}

}  // namespace

extern "C" {

void median_split(const float* centroids, int64_t n, int64_t n_leaves,
                  int64_t* order, int64_t* bounds) {
  Ctx ctx{centroids, order};
  unsigned hw = std::thread::hardware_concurrency();
  int budget = 0;
  while ((1u << budget) < hw && budget < 6) ++budget;
  split_range(ctx, 0, n, n_leaves, bounds, 0, budget);
}

// Scatter per-leaf index ranges into padded leaf slots (the C++ twin of
// ops/bvh._ranges_to_perm — one threaded linear pass instead of the numpy
// repeat+fancy-index version). perm must hold n_leaves*leaf_size int64; slots
// past a leaf's count are set to -1.
void ranges_to_perm(const int64_t* order, const int64_t* bounds,
                    int64_t n_leaves, int64_t leaf_size, int64_t* perm) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = hw > 1 ? hw : 1;
  if (n_threads > n_leaves) n_threads = 1;
  int64_t per = (n_leaves + n_threads - 1) / n_threads;
  std::vector<std::thread> pool;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t ls = t * per, le = std::min(ls + per, n_leaves);
    if (ls >= le) break;
    pool.emplace_back([=] {
      for (int64_t leaf = ls; leaf < le; ++leaf) {
        int64_t s = bounds[leaf], e = bounds[leaf + 1];
        int64_t* dst = perm + leaf * leaf_size;
        // Clamp: an oversized leaf (caller picked leaf_size too small) or
        // non-monotonic bounds must not write outside this leaf's slot.
        int64_t cnt = e - s;
        if (cnt < 0) cnt = 0;
        if (cnt > leaf_size) cnt = leaf_size;
        for (int64_t i = 0; i < cnt; ++i) dst[i] = order[s + i];
        for (int64_t i = cnt; i < leaf_size; ++i) dst[i] = -1;
      }
    });
  }
  for (auto& th : pool) th.join();
}

int native_bvh_abi_version() { return 3; }

}  // extern "C"
