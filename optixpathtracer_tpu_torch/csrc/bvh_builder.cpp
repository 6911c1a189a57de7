// Native binned-SAH BVH builder with skip-link flattening.
//
// The port's own copy of the reference's builder
// (optixpathtracer_tpu/native/bvh_builder.cpp), code unchanged, so that the
// port builds from its own sources and gives the same triangle order, hence
// the same triangle ids, as the reference. Large scenes (10^5-10^6
// triangles) make the numpy builder the scene-load bottleneck; this one is
// the production path, exposed over a plain C ABI consumed via ctypes
// (optixpathtracer_tpu_torch/native.py). Output layout is identical to
// scene/bvh.py: DFS node order, miss links in node_skip, contiguous leaf
// ranges over the reordered triangle array.
//
// Build: native.py compiles it with g++ -O3 -march=native -fPIC -shared
// -std=c++17 into the package's _build/ directory at first use.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kNumBins = 16;
constexpr int kMaxLeafSize = 4;

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  Vec3 lo{std::numeric_limits<float>::infinity(),
          std::numeric_limits<float>::infinity(),
          std::numeric_limits<float>::infinity()};
  Vec3 hi{-std::numeric_limits<float>::infinity(),
          -std::numeric_limits<float>::infinity(),
          -std::numeric_limits<float>::infinity()};
  void grow(const AABB& o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  void grow(const Vec3& p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.0f);
    float dy = std::max(hi.y - lo.y, 0.0f);
    float dz = std::max(hi.z - lo.z, 0.0f);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct BuildNode {
  AABB box;
  int32_t left = -1;   // index into node pool; -1 for leaf
  int32_t right = -1;
  int32_t first = 0;   // leaf: offset into ordered triangle list
  int32_t count = 0;   // leaf: triangle count
  int32_t count_subtree_tris = 0;  // triangles under this subtree
};

struct Builder {
  const float* v0;
  const float* v1;
  const float* v2;
  std::vector<AABB> tri_box;
  std::vector<Vec3> centroid;
  std::vector<int32_t> order;      // output triangle order
  std::vector<BuildNode> nodes;    // pool

  int32_t build(std::vector<int32_t>& idx, int32_t offset) {
    int32_t me = static_cast<int32_t>(nodes.size());
    nodes.emplace_back();

    AABB box;
    for (int32_t i : idx) box.grow(tri_box[i]);
    nodes[me].box = box;

    const int32_t n = static_cast<int32_t>(idx.size());
    if (n <= kMaxLeafSize) {
      make_leaf(me, idx, offset);
      return me;
    }

    // centroid bounds + widest axis
    AABB cb;
    for (int32_t i : idx) cb.grow(centroid[i]);
    float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
    int axis = 0;
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    if (ext[axis] <= 1e-12f) {
      make_leaf(me, idx, offset);
      return me;
    }

    // binned SAH
    const float cb_lo = axis == 0 ? cb.lo.x : (axis == 1 ? cb.lo.y : cb.lo.z);
    const float scale = kNumBins * (1.0f - 1e-6f) / ext[axis];
    AABB bin_box[kNumBins];
    int32_t bin_cnt[kNumBins] = {0};
    std::vector<int8_t> bin_of(idx.size());
    for (size_t k = 0; k < idx.size(); ++k) {
      const Vec3& c = centroid[idx[k]];
      float cv = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
      int b = static_cast<int>((cv - cb_lo) * scale);
      b = std::min(std::max(b, 0), kNumBins - 1);
      bin_of[k] = static_cast<int8_t>(b);
      bin_box[b].grow(tri_box[idx[k]]);
      bin_cnt[b]++;
    }

    AABB left_box[kNumBins], right_box[kNumBins];
    int64_t left_cnt[kNumBins], right_cnt[kNumBins];
    {
      AABB acc;
      int64_t cnt = 0;
      for (int b = 0; b < kNumBins; ++b) {
        acc.grow(bin_box[b]);
        cnt += bin_cnt[b];
        left_box[b] = acc;
        left_cnt[b] = cnt;
      }
      AABB acc2;
      int64_t cnt2 = 0;
      for (int b = kNumBins - 1; b >= 0; --b) {
        acc2.grow(bin_box[b]);
        cnt2 += bin_cnt[b];
        right_box[b] = acc2;
        right_cnt[b] = cnt2;
      }
    }

    int best_split = -1;
    float best_cost = std::numeric_limits<float>::infinity();
    for (int b = 0; b < kNumBins - 1; ++b) {
      if (left_cnt[b] == 0 || right_cnt[b + 1] == 0) continue;
      float cost = left_box[b].area() * left_cnt[b] +
                   right_box[b + 1].area() * right_cnt[b + 1];
      if (cost < best_cost) {
        best_cost = cost;
        best_split = b;
      }
    }

    std::vector<int32_t> li, ri;
    li.reserve(idx.size());
    ri.reserve(idx.size());
    if (best_split < 0) {
      // median split on the widest axis
      std::vector<int32_t> sorted = idx;
      std::nth_element(
          sorted.begin(), sorted.begin() + n / 2, sorted.end(),
          [&](int32_t a, int32_t b2) {
            const Vec3& ca = centroid[a];
            const Vec3& cb2 = centroid[b2];
            float va = axis == 0 ? ca.x : (axis == 1 ? ca.y : ca.z);
            float vb = axis == 0 ? cb2.x : (axis == 1 ? cb2.y : cb2.z);
            return va < vb;
          });
      li.assign(sorted.begin(), sorted.begin() + n / 2);
      ri.assign(sorted.begin() + n / 2, sorted.end());
    } else {
      for (size_t k = 0; k < idx.size(); ++k) {
        (bin_of[k] <= best_split ? li : ri).push_back(idx[k]);
      }
    }
    idx.clear();
    idx.shrink_to_fit();

    int32_t l = build(li, offset);
    int32_t r =
        build(ri, offset + static_cast<int32_t>(nodes[l].count_subtree_tris));
    nodes[me].left = l;
    nodes[me].right = r;
    nodes[me].count_subtree_tris =
        nodes[l].count_subtree_tris + nodes[r].count_subtree_tris;
    return me;
  }

  void make_leaf(int32_t me, const std::vector<int32_t>& idx, int32_t offset) {
    nodes[me].first = offset;
    nodes[me].count = static_cast<int32_t>(idx.size());
    nodes[me].count_subtree_tris = static_cast<int32_t>(idx.size());
    for (int32_t i : idx) order.push_back(i);
  }
};

}  // namespace

extern "C" {

// Returns the number of nodes, or -1 on error. Caller passes output buffers
// sized by a first call to bvh_node_bound(n_tris).
int64_t bvh_node_bound(int64_t n_tris) { return 2 * n_tris + 1; }

int64_t bvh_build(const float* v0, const float* v1, const float* v2,
                  int64_t n_tris, float* node_min, float* node_max,
                  int32_t* node_skip, int32_t* node_first,
                  int32_t* node_count, int32_t* tri_order) {
  if (n_tris <= 0) return -1;
  Builder b;
  b.v0 = v0;
  b.v1 = v1;
  b.v2 = v2;
  b.tri_box.resize(n_tris);
  b.centroid.resize(n_tris);
  for (int64_t i = 0; i < n_tris; ++i) {
    Vec3 a{v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]};
    Vec3 c{v1[3 * i], v1[3 * i + 1], v1[3 * i + 2]};
    Vec3 d{v2[3 * i], v2[3 * i + 1], v2[3 * i + 2]};
    AABB box;
    box.grow(a);
    box.grow(c);
    box.grow(d);
    b.tri_box[i] = box;
    b.centroid[i] = {(a.x + c.x + d.x) / 3.0f, (a.y + c.y + d.y) / 3.0f,
                     (a.z + c.z + d.z) / 3.0f};
  }
  b.nodes.reserve(2 * n_tris);
  b.order.reserve(n_tris);

  std::vector<int32_t> all(n_tris);
  for (int64_t i = 0; i < n_tris; ++i) all[i] = static_cast<int32_t>(i);
  b.build(all, 0);

  // Flatten to DFS order with miss links (matches scene/bvh.py layout).
  const int64_t n_nodes = static_cast<int64_t>(b.nodes.size());
  std::vector<int64_t> stack_node, stack_skip, dfs_of_pool;
  dfs_of_pool.assign(n_nodes, -1);
  // iterative DFS: (pool index, skip target in DFS numbering unknown until
  // assignment) - we do it in two passes: first compute subtree sizes
  // (already in count_subtree_nodes via recursion order), simpler: emit via
  // explicit stack carrying the skip value.
  struct Frame {
    int32_t pool;
    int64_t skip;
  };
  std::vector<Frame> st;
  st.push_back({0, n_nodes});
  int64_t cursor = 0;
  // subtree node counts
  std::vector<int64_t> sub(n_nodes, 1);
  for (int64_t i = n_nodes - 1; i >= 0; --i) {
    const BuildNode& nd = b.nodes[i];
    if (nd.left >= 0) sub[i] = 1 + sub[nd.left] + sub[nd.right];
  }
  while (!st.empty()) {
    Frame f = st.back();
    st.pop_back();
    const BuildNode& nd = b.nodes[f.pool];
    int64_t me = cursor++;
    node_min[3 * me] = nd.box.lo.x;
    node_min[3 * me + 1] = nd.box.lo.y;
    node_min[3 * me + 2] = nd.box.lo.z;
    node_max[3 * me] = nd.box.hi.x;
    node_max[3 * me + 1] = nd.box.hi.y;
    node_max[3 * me + 2] = nd.box.hi.z;
    node_skip[me] = static_cast<int32_t>(f.skip);
    if (nd.left < 0) {
      node_first[me] = nd.first;
      node_count[me] = nd.count;
    } else {
      int64_t right_dfs = me + 1 + sub[nd.left];
      node_first[me] = static_cast<int32_t>(right_dfs);
      node_count[me] = 0;
      // push right first so left pops first (DFS pre-order)
      st.push_back({nd.right, f.skip});
      st.push_back({nd.left, right_dfs});
    }
  }

  std::memcpy(tri_order, b.order.data(), n_tris * sizeof(int32_t));
  return n_nodes;
}

}  // extern "C"
