// Dense ray-triangle sweeps for Hopper: closest hit and occlusion.
//
// Replaces optixpathtracer_tpu/intersect/pallas_kernels.py
//   _closest_kernel (:114, helpers _cluster_test :48, _mt_scalar_tri :76)
//   _any_kernel     (:145)
// and keeps their output contract, not their TPU schedule (SMEM scalar
// broadcast and [32, 128] VMEM ray blocks were TPU workarounds):
//   * closest: (t, id) per ray, t = 3.4e38 and id = -1 on a miss; among
//     equal t the lowest triangle id wins (strict `<` in id order).
//   * any: blocked = 1 if some triangle has tmin < t < tmax.
//   * Moller-Trumbore in _mt_scalar_tri's operation order, |det| > 1e-12,
//     u, v >= 0, u + v <= 1. Built with --fmad=false, so every product and
//     sum rounds separately, as in the plain PyTorch version: FMA
//     contraction would move t by an ulp and flip knife-edge ids.
//   * Chunk AABB slab test with the +-1e-20 clamp of _safe_inv (no 0*inf),
//     bounded by min(best t, tmax). Padded rays carry tmax = -1; empty
//     chunks carry the point box at 3.4e38, which no slab test passes.
//
// The dense route serves scenes of fewer than 8 chunks of 128 triangles
// (Cornell: 34 triangles in one chunk; hall's cutout sub-scene, 40, in the
// plain cutout chain that checks the chain kernels below), so most slots
// of a chunk are padding; on shadow wavefronts half the rays are dead
// (tmax = -1), and on hall's cutout chains two thirds of the live rays
// miss the foliage's box. What bounds the kernels is FP32 issue (a
// test is ~54 separately rounded operations fed by three broadcast shared
// loads), so the design spends issue slots only on tests some input needs:
//   1. Only real triangles are swept: the launcher passes n_live (the last
//      valid triangle + 1; every slot past it is padding, v0 = 1e10 and
//      zero edges, which no ray can hit) and a chunk's loop ends there.
//   2. Lanes that cannot hit test nothing. A CTA owns a pool of kPool rays
//      and compacts, per tile of chunks, the rays that are live (tmax >
//      tmin), not yet blocked (occlusion) and pass the slab test of the
//      tile's union box, so warps sweep full 32-ray groups of such rays. A
//      lane then tests a chunk only while its own slab test passes (the
//      box of chunk c lies in the union box, so the filter never drops a
//      test), the occlusion lanes each up to their first blocker, and a
//      warp skips a chunk none of its lanes needs (__any_sync). No barrier
//      sits between chunks: warps sweep on their own.
//   3. The triangles are staged in shared memory once per pool of 1,024
//      rays (not each chunk once per 128 rays), in tiles
//      of up to 8 chunks (1,024 triangles, 36 KB) taken in id order; each
//      pool ray's (t, id) or blocked flag and its reciprocal direction (so
//      a swept ray divides no more) wait in shared memory. A scene of one
//      tile (every scene the dense route serves) is staged once; a larger
//      one (method "pallas" on any scene) runs tile by tile through the
//      same code.
// Measured on the H100 (PERF.md section 6): against persistent CTAs that
// sweep 32-ray groups as they come, the compaction costs fully live
// primaries about a tenth and wins on the shadow wavefronts and on hall's
// cutout chains; compacting per warp instead of per CTA lost everywhere.
// The kernels count, per 128-ray block, the chunks some ray of the block
// tested and the ray-triangle tests its rays ran; those equal the tests
// the inputs need (`dense_kernels.needed_work`), from which the bound is
// computed.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;      // triangles per chunk == culling cluster
constexpr int kBlockRays = 128;  // rays per block of the counts
constexpr int kWarps = 8;        // warps per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kPool = 1024;      // rays per CTA
constexpr int kPoolBlocks = kPool / kBlockRays;
constexpr int kTileChunks = 8;   // chunks staged at once
constexpr int kTileTris = kTileChunks * kChunk;
static_assert(kPool % kThreads == 0 && kBlockRays % 32 == 0, "pool shape");
constexpr float kBig = 3.4e38f;
constexpr float kEpsDet = 1e-12f;
constexpr unsigned kFullMask = 0xffffffffu;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmin, tmax;
};

__device__ __forceinline__ float safe_inv(float d) {
  const float tiny = d >= 0.0f ? 1e-20f : -1e-20f;
  return 1.0f / (fabsf(d) < 1e-20f ? tiny : d);
}

// Rays past the end are padding: no origin offset, tmax = -1, no hits.
// The reciprocals are left to the caller.
__device__ __forceinline__ Ray load_planes(const float* __restrict__ o,
                                           const float* __restrict__ d,
                                           const float* __restrict__ tmin,
                                           const float* __restrict__ tmax,
                                           int n, int i) {
  Ray r;
  if (i < n) {
    r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
    r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
    r.tmin = tmin[i];
    r.tmax = tmax[i];
  } else {
    r.ox = r.oy = r.oz = 0.0f;
    r.dx = r.dy = r.dz = 1.0f;
    r.tmin = 0.0f;
    r.tmax = -1.0f;
  }
  return r;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d,
                                        const float* __restrict__ tmin,
                                        const float* __restrict__ tmax,
                                        int n, int i) {
  Ray r = load_planes(o, d, tmin, tmax, n, i);
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  return r;
}

// The staged tile: triangle k as (v0x v0y v0z e1x | e1y e1z e2x e2y) in
// two float4 and e2z alone; chunk j's box as six floats.
struct Tile {
  float4* a;
  float4* b;
  float* c;
  float* box;  // [6][kTileChunks]
};

__device__ __forceinline__ Tile tile_of(float4* smem, int t_alloc) {
  Tile s;
  s.a = smem;
  s.b = smem + t_alloc;
  s.c = reinterpret_cast<float*>(smem + 2 * t_alloc);
  s.box = s.c + t_alloc;
  return s;
}

// Stage triangles [k0, k1) and the boxes of chunks [c0, c1). The caller
// synchronises before (the previous tile is done) and after.
__device__ __forceinline__ void stage_tile(const Tile& s,
                                           const float* __restrict__ tris,
                                           const float* __restrict__ boxes,
                                           int t_pad, int n_chunks, int k0,
                                           int k1, int c0, int c1) {
  for (int k = threadIdx.x; k < k1 - k0; k += blockDim.x) {
    const float* p = tris + k0 + k;
    s.a[k] = make_float4(p[0], p[t_pad], p[2 * t_pad], p[3 * t_pad]);
    s.b[k] = make_float4(p[4 * t_pad], p[5 * t_pad], p[6 * t_pad],
                         p[7 * t_pad]);
    s.c[k] = p[8 * t_pad];
  }
  for (int x = threadIdx.x; x < 6 * (c1 - c0); x += blockDim.x) {
    const int axis = x / (c1 - c0), j = x % (c1 - c0);
    s.box[axis * kTileChunks + j] = boxes[axis * n_chunks + c0 + j];
  }
}

// _cluster_test for one ray: can it hit the box (min b[0..2], max
// b[3..5], each at stride `stride`) before `limit`? Every operation is
// monotone in the box's faces, so a box inside another never passes where
// the outer one fails.
__device__ __forceinline__ bool slab(const Ray& r, const float* b,
                                     int stride, float limit) {
  const float tx0 = (b[0] - r.ox) * r.ix;
  const float ty0 = (b[stride] - r.oy) * r.iy;
  const float tz0 = (b[2 * stride] - r.oz) * r.iz;
  const float tx1 = (b[3 * stride] - r.ox) * r.ix;
  const float ty1 = (b[4 * stride] - r.oy) * r.iy;
  const float tz1 = (b[5 * stride] - r.oz) * r.iz;
  const float t_near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                             fminf(tz0, tz1));
  const float t_far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                            fmaxf(tz0, tz1));
  return t_near <= t_far && t_far >= r.tmin && t_near <= limit;
}

// The union of staged boxes [0, n) that hold a triangle (an empty chunk
// carries the point box at kBig) into u[6]; false if there is none.
__device__ __forceinline__ bool union_box(const float* box, int n,
                                          float* u) {
  bool any = false;
  for (int j = 0; j < n; ++j) {
    if (box[j] >= 1e38f) continue;
    for (int a = 0; a < 3; ++a) {
      const float lo = box[a * kTileChunks + j];
      const float hi = box[(a + 3) * kTileChunks + j];
      u[a] = any ? fminf(u[a], lo) : lo;
      u[a + 3] = any ? fmaxf(u[a + 3], hi) : hi;
    }
    any = true;
  }
  return any;
}

// Moller-Trumbore's terms for one (ray, staged triangle) pair, in
// _mt_scalar_tri's operation order, which is also `api._refine`'s.
struct MtTerms {
  bool ok;  // |det| > 1e-12
  float u, v, t;
};

__device__ __forceinline__ MtTerms mt_terms(const Ray& r, const Tile& s,
                                            int k) {
  const float4 a = s.a[k];
  const float4 b = s.b[k];
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = s.c[k];

  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  MtTerms m;
  m.ok = fabsf(det) > kEpsDet;
  const float inv_det = m.ok ? 1.0f / det : 0.0f;
  const float tvx = r.ox - v0x;
  const float tvy = r.oy - v0y;
  const float tvz = r.oz - v0z;
  m.u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  m.v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
  m.t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  return m;
}

// _mt_scalar_tri for one (ray, staged triangle) pair. Returns hit (tmin <
// t < limit inside the triangle) and t.
__device__ __forceinline__ bool mt(const Ray& r, const Tile& s, int k,
                                   float limit, float* t_out) {
  const MtTerms m = mt_terms(r, s, k);
  *t_out = m.t;
  return m.ok && m.u >= 0.0f && m.v >= 0.0f && m.u + m.v <= 1.0f &&
         m.t > r.tmin && m.t < limit;
}

// What a CTA keeps about its pool of rays across tiles.
struct Pool {
  int slot[kPool];       // the compacted pool slots of this tile
  float bt[kPool];       // closest: best t
  int bi[kPool];         // closest: best id; occlusion: blocked
  float inv[3][kPool];   // the rays' safe reciprocal directions
  int tests[kPoolBlocks];
  int swept[kPoolBlocks];
  int chunk_on[kPoolBlocks][kTileChunks];  // some ray of the block tested
  int wanted[kWarps];    // compacted slots a warp contributes
};

// Both sweeps over the CTA's pool of rays [blockIdx.x * kPool, + kPool):
// the live chunks in tiles, in id order. Per tile, the pool rays that can
// hit the tile (live, open, inside the union box) are compacted and swept
// 32 at a time. Closest keeps (t, id) in out_t / out_i, occlusion the
// blocked flag in out_i.
template <bool kClosest>
__device__ __forceinline__ void sweep(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax, int n,
    const float* __restrict__ tris, const float* __restrict__ boxes,
    int n_chunks, int n_live, float* __restrict__ out_t,
    int* __restrict__ out_i, int* __restrict__ swept,
    int* __restrict__ tests, int t_alloc) {
  extern __shared__ float4 smem[];
  __shared__ Pool p;
  const Tile s = tile_of(smem, t_alloc);
  const int t_pad = n_chunks * kChunk;
  const int live_chunks = (n_live + kChunk - 1) / kChunk;
  const int ray0 = blockIdx.x * kPool;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int q = threadIdx.x; q < kPool; q += kThreads) {
    p.bt[q] = kBig;
    p.bi[q] = kClosest ? -1 : 0;
  }
  for (int b = threadIdx.x; b < kPoolBlocks; b += kThreads) {
    p.tests[b] = p.swept[b] = 0;
    for (int j = 0; j < kTileChunks; ++j) p.chunk_on[b][j] = 0;
  }
  for (int c0 = 0; c0 < live_chunks; c0 += kTileChunks) {
    const int c1 = min(c0 + kTileChunks, live_chunks);
    const int k0 = c0 * kChunk, k1 = min(c1 * kChunk, n_live);
    __syncthreads();  // the last tile is done with s and p.slot
    stage_tile(s, tris, boxes, t_pad, n_chunks, k0, k1, c0, c1);
    __syncthreads();
    float u[6];
    const bool any_box = union_box(s.box, c1 - c0, u);
    // warp w compacts the kPool / kWarps pool slots from w * kPool /
    // kWarps, so the compacted slots stay in ray order
    unsigned want[kPool / kThreads];
    int n_want = 0;
    for (int m = 0; m < kPool / kThreads; ++m) {
      const int q = warp * (kPool / kWarps) + m * 32 + lane;
      const Ray r = load_ray(o, d, tmin, tmax, n, ray0 + q);
      p.inv[0][q] = r.ix;
      p.inv[1][q] = r.iy;
      p.inv[2][q] = r.iz;
      const bool open = r.tmax > r.tmin && (kClosest || p.bi[q] == 0);
      const float limit = kClosest ? fminf(p.bt[q], r.tmax) : r.tmax;
      want[m] = __ballot_sync(kFullMask,
                              open && any_box && slab(r, u, 1, limit));
      n_want += __popc(want[m]);
    }
    if (lane == 0) p.wanted[warp] = n_want;
    __syncthreads();
    int offset = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      offset += w < warp ? p.wanted[w] : 0;
      total += p.wanted[w];
    }
    for (int m = 0; m < kPool / kThreads; ++m) {
      if (want[m] >> lane & 1)
        p.slot[offset + __popc(want[m] & ((1u << lane) - 1))] =
            warp * (kPool / kWarps) + m * 32 + lane;
      offset += __popc(want[m]);
    }
    __syncthreads();
    for (int g = warp * 32; g < total; g += kThreads) {
      const int q = g + lane < total ? p.slot[g + lane] : -1;
      // an idle lane (q < 0) loads the dead padding ray past the end
      Ray r = load_planes(o, d, tmin, tmax, n, q < 0 ? n : ray0 + q);
      r.ix = q < 0 ? 1.0f : p.inv[0][q];
      r.iy = q < 0 ? 1.0f : p.inv[1][q];
      r.iz = q < 0 ? 1.0f : p.inv[2][q];
      const bool live = r.tmax > r.tmin;
      float bt = q < 0 ? kBig : p.bt[q];
      int bi = q < 0 ? 0 : p.bi[q];
      bool blocked = !kClosest && bi != 0;
      int n_tests = 0;
      for (int c = c0; c < c1; ++c) {
        const bool open = live && (kClosest || !blocked);
        if (!kClosest && !__any_sync(kFullMask, open)) break;  // all settled
        const bool can = open && slab(r, s.box + (c - c0), kTileChunks,
                                      kClosest ? fminf(bt, r.tmax) : r.tmax);
        if (!__any_sync(kFullMask, can)) continue;
        if (!can) continue;
        p.chunk_on[q / kBlockRays][c - c0] = 1;
        const int kb = (c - c0) * kChunk;
        const int ke = min(kb + kChunk, k1 - k0);
        if (kClosest) {
#pragma unroll 4
          for (int k = kb; k < ke; ++k) {
            float t;
            if (mt(r, s, k, fminf(bt, r.tmax), &t) && t < bt) {
              bt = t;
              bi = k0 + k;
            }
          }
          n_tests += ke - kb;
        } else {
#pragma unroll 4
          for (int k = kb; k < ke && !blocked; ++k) {
            float t;
            blocked = mt(r, s, k, r.tmax, &t);
            ++n_tests;
          }
        }
      }
      if (q >= 0) {
        p.bt[q] = bt;
        p.bi[q] = kClosest ? bi : (blocked ? 1 : 0);
        if (n_tests) atomicAdd(&p.tests[q / kBlockRays], n_tests);
      }
    }
    __syncthreads();
    for (int b = threadIdx.x; b < kPoolBlocks; b += kThreads) {
      for (int j = 0; j < kTileChunks; ++j) {
        p.swept[b] += p.chunk_on[b][j];
        p.chunk_on[b][j] = 0;
      }
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < kPool; q += kThreads) {
    const int i = ray0 + q;
    if (i >= n) break;
    if (kClosest) out_t[i] = p.bt[q];
    out_i[i] = p.bi[q];
  }
  const int n_blocks = (n + kBlockRays - 1) / kBlockRays;
  for (int b = threadIdx.x; b < kPoolBlocks; b += kThreads) {
    const int gb = blockIdx.x * kPoolBlocks + b;
    if (gb < n_blocks) {
      swept[gb] = p.swept[b];
      tests[gb] = p.tests[b];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dense_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ tmin,
                     const float* __restrict__ tmax, int n,
                     const float* __restrict__ tris,
                     const float* __restrict__ boxes, int n_chunks,
                     int n_live, float* __restrict__ out_t,
                     int* __restrict__ out_id, int* __restrict__ swept,
                     int* __restrict__ tests, int t_alloc) {
  sweep<true>(o, d, tmin, tmax, n, tris, boxes, n_chunks, n_live, out_t,
              out_id, swept, tests, t_alloc);
}

__global__ void __launch_bounds__(kThreads)
dense_any_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ tmin,
                 const float* __restrict__ tmax, int n,
                 const float* __restrict__ tris,
                 const float* __restrict__ boxes, int n_chunks, int n_live,
                 int* __restrict__ out_blocked, int* __restrict__ swept,
                 int* __restrict__ tests, int t_alloc) {
  sweep<false>(o, d, tmin, tmax, n, tris, boxes, n_chunks, n_live, nullptr,
               out_blocked, swept, tests, t_alloc);
}

// ---------------------------------------------------------------------------
// The alpha-cutout chains: one kernel a query, one thread a lane.
//
// Replaces the plain chain of integrate/cutout.py (closest_chain_plain,
// any_chain_plain), which was the reference's Python loop around
// _closest_kernel (optixpathtracer_tpu/integrate/cutout.py, split path):
// up to MAX_CUTOUT_LAYERS + 1 rounds over every lane of the wavefront,
// each a dense closest sweep, `_refine`, the alpha lookup, selects, and a
// host test "any lane still open?" that drains the stream. Here each
// thread runs its own lane's chain to its end:
//   1. sweep the staged cutout sub-scene in (cur_tmin, bound): chunks in
//      id order behind their slab test bounded by min(best t, bound),
//      strict `<` (the dense closest kernel's arithmetic and tie rule);
//   2. the hit record (a padding or invalid id is a miss) and _refine's
//      t, u, v and ok at the chosen triangle, in its operation order;
//   3. the albedo alpha as _hit_alpha computes it: the uv lerp, the
//      bilinear sample (wrap, floor, texel lerps in sample_bilinear's
//      order), the sRGB decode (divisions correctly rounded, the power in
//      float64 and rounded once, as core.math.pow), 1 without a texture;
//   4. alpha >= 0.9 ends the chain; a hole re-enters at t + 1e-4.
// Closest: after MAX_CUTOUT_LAYERS + 1 holes the deepest hole is the hit
// (the exhaustion rule); any: a chain still open occludes. Lanes that are
// dead or end on their first layer leave after one sweep, so the work is
// one dense sweep plus the few re-traced layers, with no host test and no
// wavefront-wide pass a layer.
// Bound: the first layer's needed tests (`dense_kernels.needed_work`) at
// ~54 FP32 operations each, or the bytes (32 in and 8 or 1 out a lane),
// the larger; on the hall's 40-triangle sub-scene both are tens of us.
// Design: a CTA stages the whole sub-scene once (the routing admits only
// sub-scenes of fewer than 8 chunks, so a tile holds it): the planes and
// chunk boxes as the sweeps stage them, and each triangle's uvs and
// albedo texture id (-2 for an invalid triangle). Texels are read from
// global memory (L2-resident: a few lanes per warp need them). The layers
// re-traced beyond the first are summed per CTA and added to `reentries`
// with one atomicAdd.
// ---------------------------------------------------------------------------

constexpr int kChainThreads = 256;
constexpr int kMaxCutoutLayers = 4;     // cutout.MAX_CUTOUT_LAYERS
constexpr float kAlphaThreshold = 0.9f;  // cutout.ALPHA_THRESHOLD
constexpr float kReentryEps = 1e-4f;     // cutout.REENTRY_EPS
constexpr int kInvalidTri = -2;          // meta of an invalid triangle

// The staged sub-scene: the sweeps' tile, then each triangle's three uvs
// and its albedo texture id.
struct ChainStage {
  Tile tile;
  float* uv;   // [t_alloc][6]
  int* meta;   // [t_alloc]: texture id, -1 none, kInvalidTri invalid
};

__device__ __forceinline__ ChainStage chain_stage_of(float4* smem,
                                                     int t_alloc) {
  ChainStage s;
  s.tile = tile_of(smem, t_alloc);
  s.uv = s.tile.box + 6 * kTileChunks;
  s.meta = reinterpret_cast<int*>(s.uv + 6 * t_alloc);
  return s;
}

// One layer's hit record after _refine: hit, t (tmax on a miss), u, v and
// the triangle.
struct Layer {
  bool hit;
  float t, u, v;
  int id;
};

__device__ __forceinline__ Layer chain_layer(const Ray& r,
                                             const ChainStage& s,
                                             int live_chunks, int n_live) {
  float bt = kBig;
  int bi = -1;
  if (r.tmax > r.tmin) {
    for (int c = 0; c < live_chunks; ++c) {
      if (!slab(r, s.tile.box + c, kTileChunks, fminf(bt, r.tmax))) continue;
      const int ke = min((c + 1) * kChunk, n_live);
      for (int k = c * kChunk; k < ke; ++k) {
        float t;
        if (mt(r, s.tile, k, fminf(bt, r.tmax), &t) && t < bt) {
          bt = t;
          bi = k;
        }
      }
    }
  }
  Layer h;
  h.hit = false;
  h.t = r.tmax;
  h.u = h.v = 0.0f;
  h.id = bi;
  if (bi >= 0 && s.meta[bi] != kInvalidTri) {
    const MtTerms m = mt_terms(r, s.tile, bi);
    if (m.ok) {
      h.hit = true;
      h.t = m.t;
      h.u = m.u;
      h.v = m.v;
    }
  }
  return h;
}

// sample_bilinear's texel index: floor-mod, as torch.remainder on int64.
__device__ __forceinline__ long long wrap_texel(float i, int res) {
  const long long m = static_cast<long long>(i) % res;
  return m < 0 ? m + res : m;
}

// _hit_alpha at a hit: the decoded albedo alpha, 1 without a texture.
__device__ __forceinline__ float hit_alpha(const ChainStage& s,
                                           const float* __restrict__ tex,
                                           int n_tex, int res,
                                           const Layer& h) {
  const int tex_id = s.meta[h.id];
  if (tex_id < 0) return 1.0f;
  const float* uv = s.uv + 6 * h.id;
  const float w = (1.0f - h.u) - h.v;
  const float su = (w * uv[0] + h.u * uv[2]) + h.v * uv[4];
  const float sv = (w * uv[1] + h.u * uv[3]) + h.v * uv[5];
  const int tid = min(tex_id, n_tex - 1);
  const float x = (su - floorf(su)) * static_cast<float>(res) - 0.5f;
  const float y = (sv - floorf(sv)) * static_cast<float>(res) - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const long long xa = wrap_texel(x0, res), xb = wrap_texel(x0 + 1.0f, res);
  const long long ya = wrap_texel(y0, res), yb = wrap_texel(y0 + 1.0f, res);
  const float* plane = tex + static_cast<long long>(tid) * res * res * 4 + 3;
  const float c00 = __ldg(plane + (ya * res + xa) * 4);
  const float c10 = __ldg(plane + (ya * res + xb) * 4);
  const float c01 = __ldg(plane + (yb * res + xa) * 4);
  const float c11 = __ldg(plane + (yb * res + xb) * 4);
  const float top = c00 * (1.0f - fx) + c10 * fx;
  const float bot = c01 * (1.0f - fx) + c11 * fx;
  const float c = top * (1.0f - fy) + bot * fy;
  if (c <= 0.04045f) return c / 12.92f;
  return static_cast<float>(pow(static_cast<double>((c + 0.055f) / 1.055f),
                                2.4));
}

// Both chains: closest writes (best t, best id) after the exhaustion rule,
// any the blocked flag of the lanes `gate` admits.
template <bool kClosest>
__device__ __forceinline__ void chain(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const unsigned char* __restrict__ gate, int n,
    const float* __restrict__ tris, const float* __restrict__ boxes,
    int n_chunks, int n_live, const float* __restrict__ uvs,
    const int* __restrict__ meta, const float* __restrict__ tex, int n_tex,
    int res, float* __restrict__ out_t, int* __restrict__ out_id,
    unsigned char* __restrict__ out_blocked, int* __restrict__ reentries,
    int t_alloc) {
  extern __shared__ float4 smem[];
  __shared__ int block_reentries;
  const ChainStage s = chain_stage_of(smem, t_alloc);
  const int live_chunks = (n_live + kChunk - 1) / kChunk;
  if (threadIdx.x == 0) block_reentries = 0;
  stage_tile(s.tile, tris, boxes, n_chunks * kChunk, n_chunks, 0, n_live, 0,
             live_chunks);
  for (int x = threadIdx.x; x < 6 * n_live; x += blockDim.x)
    s.uv[x] = uvs[x];
  for (int k = threadIdx.x; k < n_live; k += blockDim.x) s.meta[k] = meta[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    Ray r = load_ray(o, d, tmin, tmax, n, i);
    bool open = kClosest || gate[i] != 0;
    bool blocked = false;
    float best_t = __int_as_float(0x7f800000);  // +inf
    int best_id = -1;
    float last_t = best_t;
    int last_id = -1;
    int sweeps = 0;
    for (int layer = 0; layer <= kMaxCutoutLayers && open; ++layer) {
      ++sweeps;
      const Layer h = chain_layer(r, s, live_chunks, n_live);
      const bool solid =
          h.hit && hit_alpha(s, tex, n_tex, res, h) >= kAlphaThreshold;
      if (solid) {
        best_t = h.t;
        best_id = h.id;
        blocked = true;
      }
      open = h.hit && !solid;
      if (open) {
        r.tmin = h.t + kReentryEps;
        last_t = h.t;
        last_id = h.id;
      }
    }
    if (kClosest) {
      if (open && last_id >= 0) {  // exhausted: the deepest hole occludes
        best_t = last_t;
        best_id = last_id;
      }
      out_t[i] = best_t;
      out_id[i] = best_id;
    } else {
      out_blocked[i] = (blocked || open) ? 1 : 0;  // beyond the bound: occlude
    }
    if (sweeps > 1) atomicAdd(&block_reentries, sweeps - 1);
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_reentries)
    atomicAdd(reentries, block_reentries);
}

__global__ void __launch_bounds__(kChainThreads)
cutout_closest_kernel(const float* __restrict__ o,
                      const float* __restrict__ d,
                      const float* __restrict__ tmin,
                      const float* __restrict__ tmax, int n,
                      const float* __restrict__ tris,
                      const float* __restrict__ boxes, int n_chunks,
                      int n_live, const float* __restrict__ uvs,
                      const int* __restrict__ meta,
                      const float* __restrict__ tex, int n_tex, int res,
                      float* __restrict__ out_t, int* __restrict__ out_id,
                      int* __restrict__ reentries, int t_alloc) {
  chain<true>(o, d, tmin, tmax, nullptr, n, tris, boxes, n_chunks, n_live,
              uvs, meta, tex, n_tex, res, out_t, out_id, nullptr, reentries,
              t_alloc);
}

__global__ void __launch_bounds__(kChainThreads)
cutout_any_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ tmin,
                  const float* __restrict__ tmax,
                  const unsigned char* __restrict__ gate, int n,
                  const float* __restrict__ tris,
                  const float* __restrict__ boxes, int n_chunks, int n_live,
                  const float* __restrict__ uvs,
                  const int* __restrict__ meta,
                  const float* __restrict__ tex, int n_tex, int res,
                  unsigned char* __restrict__ out_blocked,
                  int* __restrict__ reentries, int t_alloc) {
  chain<false>(o, d, tmin, tmax, gate, n, tris, boxes, n_chunks, n_live, uvs,
               meta, tex, n_tex, res, nullptr, nullptr, out_blocked,
               reentries, t_alloc);
}

// Triangles one tile stages, and the dynamic shared memory that takes.
int staged_tris(int n_live) { return n_live < kTileTris ? n_live : kTileTris; }

size_t smem_bytes(int t_alloc) {
  return static_cast<size_t>(t_alloc) * (2 * sizeof(float4) + sizeof(float))
         + 6 * kTileChunks * sizeof(float);
}

// Launch one CTA per pool of rays, the tile's size last. A full tile and
// the static Pool pass 48 KB, so the kernel's dynamic shared memory limit
// is raised once.
template <auto kKernel, typename... Args>
int launch(int n_rays, int n_live, void* stream, Args... args) {
  if (n_rays == 0) return 0;
  static const cudaError_t raised = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kTileTris)));
  if (raised != cudaSuccess) return static_cast<int>(raised);
  const int t_alloc = staged_tris(n_live);
  kKernel<<<(n_rays + kPool - 1) / kPool, kThreads, smem_bytes(t_alloc),
            static_cast<cudaStream_t>(stream)>>>(args..., t_alloc);
  return static_cast<int>(cudaGetLastError());
}

// The chains' dynamic shared memory: the tile, then 6 uv floats and a
// texture id a triangle.
size_t chain_smem_bytes(int t_alloc) {
  return smem_bytes(t_alloc) + static_cast<size_t>(t_alloc) * 7 * 4;
}

// Zero the counter, then launch one thread a lane over the staged
// sub-scene (every live triangle in one tile, the tile's size last).
template <auto kKernel, typename... Args>
int launch_chain(int n_rays, int n_live, int* reentries, void* stream,
                 Args... args) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_live > kTileTris) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(reentries, 0, sizeof(int), st);
  if (err != cudaSuccess || n_rays == 0) return static_cast<int>(err);
  static const cudaError_t raised = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(chain_smem_bytes(kTileTris)));
  if (raised != cudaSuccess) return static_cast<int>(raised);
  kKernel<<<(n_rays + kChainThreads - 1) / kChainThreads, kChainThreads,
            chain_smem_bytes(n_live), st>>>(args..., reentries, n_live);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Both entry points launch on `stream`, do not synchronise, and return
// cudaGetLastError() (0 on success). o, d: [n, 3]; tmin, tmax: [n]; tris:
// [9, n_chunks * 128]; boxes: [6, n_chunks]; n_live: the triangles to
// sweep (every one from n_live on is padding); swept, tests: [ceil(n /
// 128)] chunks some ray of the block tested and ray-triangle tests its
// rays ran, per 128-ray block; all float32 / int32, contiguous.
int dense_closest(const float* o, const float* d, const float* tmin,
                  const float* tmax, int n_rays, const float* tris,
                  const float* boxes, int n_chunks, int n_live, float* out_t,
                  int* out_id, int* swept, int* tests, void* stream) {
  return launch<dense_closest_kernel>(n_rays, n_live, stream, o, d, tmin,
                                     tmax, n_rays, tris, boxes, n_chunks,
                                     n_live, out_t, out_id, swept, tests);
}

int dense_any(const float* o, const float* d, const float* tmin,
              const float* tmax, int n_rays, const float* tris,
              const float* boxes, int n_chunks, int n_live, int* out_blocked,
              int* swept, int* tests, void* stream) {
  return launch<dense_any_kernel>(n_rays, n_live, stream, o, d, tmin, tmax,
                                 n_rays, tris, boxes, n_chunks, n_live,
                                 out_blocked, swept, tests);
}

// The cutout chains over a staged sub-scene of n_live <= 1,024
// triangles: o, d, tmin, tmax, tris, boxes and n_live as above; uvs [n_live
// or more, 6] (tri_uvs), meta [n_live or more] int32 (the albedo texture
// id, -1 none, -2 an invalid triangle); tex [n_tex, res, res, 4] float32;
// gate [n] bool (the lanes the occlusion chain serves); reentries [1]
// int32, zeroed here, then the layers the lanes re-traced beyond the
// first. closest: out_t [n] float32 (+inf on a miss), out_id [n] int32 (-1);
// any: out_blocked [n] bool.
int cutout_closest(const float* o, const float* d, const float* tmin,
                   const float* tmax, int n_rays, const float* tris,
                   const float* boxes, int n_chunks, int n_live,
                   const float* uvs, const int* meta, const float* tex,
                   int n_tex, int res, float* out_t, int* out_id,
                   int* reentries, void* stream) {
  return launch_chain<cutout_closest_kernel>(
      n_rays, n_live, reentries, stream, o, d, tmin, tmax, n_rays, tris,
      boxes, n_chunks, n_live, uvs, meta, tex, n_tex, res, out_t, out_id);
}

int cutout_any(const float* o, const float* d, const float* tmin,
               const float* tmax, const unsigned char* gate, int n_rays,
               const float* tris, const float* boxes, int n_chunks,
               int n_live, const float* uvs, const int* meta,
               const float* tex, int n_tex, int res,
               unsigned char* out_blocked, int* reentries, void* stream) {
  return launch_chain<cutout_any_kernel>(
      n_rays, n_live, reentries, stream, o, d, tmin, tmax, gate, n_rays,
      tris, boxes, n_chunks, n_live, uvs, meta, tex, n_tex, res,
      out_blocked);
}

}  // extern "C"
