// The walk engine for Hopper: per-block candidate chunk lists, then sweeps
// of the candidates front to back, for closest hit and for occlusion.
//
// Replaces optixpathtracer_tpu/intersect/walk_kernels.py
//   _make_cand_kernel      (:444, launched by _candidates :510)
//     -> walk_candidates_kernel
//   _make_sweep_kernel     (:139, launched by intersect_closest_raw :607,
//                           helpers _cluster_test_chunk :69, _mt_smem_tri :94)
//     -> walk_closest_kernel
//   _make_any_sweep_kernel (:240, launched by intersect_any :662)
//     -> walk_any_kernel
// and keeps their output contract, not their TPU schedule (the SMEM scalar
// rays, the [8, 128] VMEM blocks and the 4-deep DMA ring were TPU means):
//   * A ray block is `block_rays` consecutive rays of the coherence-sorted
//     wavefront (128, 256, 512 or 1024). Rays past the end are padding with
//     tmax = -1. Chunk boxes are six [C] planes in walk order, triangles the
//     [C, 16, chunk] walk layout (rows 0-8: v0, e1, e2 xyz; chunk a multiple
//     of 128).
//   * candidates: entry[b, c] = min over the block's live rays (tmax >= 0)
//     that pass the slab test (t_near <= t_far, t_far >= tmin,
//     t_near <= tmax) of max(t_near, 0); 3.4e38 where none passes and in
//     the padded slots c >= C. min and max are exact, so the result does
//     not depend on the order rays are visited in.
//   * closest: Moller-Trumbore in _mt_smem_tri's operation order, |det| >
//     1e-12, u, v >= 0, u + v <= 1, t > tmin, t < tmax; the nearest hit,
//     the lowest id c * chunk + k among equal t. That is the brute oracle's
//     (t, lowest id) in any candidate order and any split of a chunk. The
//     sweep stops once the next candidate's entry distance exceeds the
//     block's max of min(best t, tmax).
//   * any: blocked = 1 if some candidate triangle has tmin < t < tmax; the
//     block stops once every live ray is blocked.
//   * Built with --fmad=false: every product and sum rounds separately, as
//     in the plain PyTorch versions, so entries are bit-identical and ids
//     break ties the same way.
//
// The candidate kernel flips the TPU kernel's roles, chunks on the vector
// lanes and rays as a scalar loop, with no atomics and no cross-thread
// reduction: one CUDA block per ray block copies the block's rays into
// shared memory (32 B a ray: origin, inverse direction, tmin, tmax), and
// each thread owns chunk slots c = tid, tid + 256, ..., keeps that chunk's
// box in registers and runs over the rays, which shared memory broadcasts
// to the warp. It is C x block_rays slab tests (28 FP32 operations each,
// with the live test and the running min) per block.
//
// The sweeps. What bounds them on the H100 is FP32 issue: a ray-triangle
// test is 54 separately rounded operations fed by three broadcast 16-byte
// shared loads, against 40 bytes of ray and answer and a few candidate
// words per ray. So the work to spend is the tests the rays need
// (`walk_kernels.needed_work`): a ray tests a candidate chunk only when its
// own slab test passes it (bounded by its best hit so far), and then only
// the chunk's real triangles. A sweep of one thread per ray would charge
// every lane of a warp with one passing ray all of a chunk's tests, idle
// the block's warps that have none, and pay per candidate a box load a
// thread from device memory and a barrier or more. The design, one 8-warp
// CTA per ray block:
//   a. Compaction. Per candidate chunk, every ray of the block slab-tests
//      the chunk's box against min(best t, tmax) (occlusion: tmax, open
//      rays only); the rays that pass are appended, by a warp ballot and
//      one shared atomic per warp, to the chunk's list in shared memory,
//      and only they are swept, in groups of 32.
//   b. Slices. Warp w owns the chunk's triangles [w, w + 1) x chunk / 8
//      and sweeps them for every group of the list, so all 8 warps work
//      on a chunk however few rays pass it. A group of 16 rays or fewer
//      spreads each ray over 32 / w lanes (w = 16, 8 or 4), each lane
//      taking every (32 / w)-th triangle of the slice. Each ray's answer
//      is merged in shared memory by an order-free rule: closest lowers a
//      64-bit key, t's bits mapped to an order-preserving uint32 above the
//      id, with atomicMin (the lowest key is the nearest hit, the lowest id
//      at equal t); occlusion sets a blocked flag, which a lane reads
//      before it sweeps a ray. So a blocked ray may run from 1 to all of a
//      chunk's triangles in the chunk that blocks it, where the count
//      model charges those up to its first blocker in slot order.
//   c. One barrier pair a candidate. The block's candidate list, entry
//      distances and boxes are staged in shared memory 64 candidates at a
//      time. The early exit reads values the compaction already reduced
//      (the warps' max of min(best t, tmax), an atomicMax on an
//      order-preserving uint32; whether a ray is still open) from counters
//      that rotate over three slots, so a chunk no ray passes costs one
//      barrier and a swept one two.
//   d. Staging. Each warp copies its slice of a swept chunk into its own
//      shared memory, dropping the padding (zero edges: det = 0 for every
//      ray, so no ray can hit it): no block barrier, the chunk staged once
//      a block. The ray state lives in shared memory (60 bytes a ray), so
//      a thread holds one ray and one triangle at a time: 5 CTAs an SM
//      (48 registers; 4 CTAs and 56 registers measured slower).
//   e. Early exits in a test. A lane whose u, then v, rules the hit out
//      leaves the test; the operations it skips could only confirm the
//      miss, so answers are unchanged. The bound charges each needed test
//      the operations up to where it can end (`NeededWork.exits`).
// Measured on the H100 (PERF.md section 6, packet_bench.py --walk): each
// step pays; a cp.async copy of the next slice before the slab tests and
// a sign test before the division did not, and are not here.
// Every sweep writes, per block, the chunks some ray swept and the
// ray-triangle tests its lanes ran, one count per test where it runs; the
// closest sweep's equal the count model's, the occlusion sweep's lie
// within the stated slack of it.

#include <cuda_runtime.h>

namespace {

constexpr int kCandThreads = 256;  // chunk slots per candidate pass
constexpr int kWarps = 8;          // warps per sweep CTA, and slices a chunk
constexpr int kThreads = kWarps * 32;
constexpr int kCtasPerSm = 5;      // sweep CTAs an SM: 48 registers a thread
constexpr int kCandTile = 64;      // candidates staged at once
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
__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
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
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  return r;
}

// t's float bits as a uint32 in the order of the floats, and back.
__device__ __forceinline__ unsigned ordered(float t) {
  const unsigned u = __float_as_uint(t);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

// A closest hit's merge key: the lowest key is the nearest hit, the lowest
// id among equal t. No hit is (3.4e38, 0xffffffff).
__device__ __forceinline__ unsigned long long hit_key(float t, unsigned id) {
  return (static_cast<unsigned long long>(ordered(t)) << 32) | id;
}

__device__ __forceinline__ float key_t(unsigned long long key) {
  return unordered(static_cast<unsigned>(key >> 32));
}

// _cluster_test_chunk for one ray (origin and tmin in ro, reciprocal
// direction in ri): can it hit the box (min b[0..2], max b[3..5], at
// stride kCandTile) before limit?
__device__ __forceinline__ bool slab(float4 ro, float4 ri, const float* b,
                                     float limit) {
  const float tx0 = (b[0] - ro.x) * ri.x;
  const float tx1 = (b[3 * kCandTile] - ro.x) * ri.x;
  const float ty0 = (b[kCandTile] - ro.y) * ri.y;
  const float ty1 = (b[4 * kCandTile] - ro.y) * ri.y;
  const float tz0 = (b[2 * kCandTile] - ro.z) * ri.z;
  const float tz1 = (b[5 * kCandTile] - ro.z) * ri.z;
  const float t_near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                             fminf(tz0, tz1));
  const float t_far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                            fmaxf(tz0, tz1));
  return t_near <= t_far && t_far >= ro.w && t_near <= limit;
}

// _mt_smem_tri for one ray (origin and tmin in ro, direction and tmax in
// rd) and the staged triangle at s (v0x v0y v0z e1x | e1y e1z e2x e2y |
// e2z slot - -), same operation order. Returns tmin < t <= bound && t <
// tmax inside the triangle, and t (set only on a hit). A lane whose u, or
// then v, already rules the hit out computes no further: every value it
// skips could only have confirmed the miss.
__device__ __forceinline__ bool mt(float4 ro, float4 rd, const float4* s,
                                   float bound, float* t_out) {
  const float4 a = s[0];
  const float4 b = s[1];
  const float4 c = s[2];
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;

  const float pvx = rd.y * e2z - rd.z * e2y;
  const float pvy = rd.z * e2x - rd.x * e2z;
  const float pvz = rd.x * e2y - rd.y * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool ok = fabsf(det) > kEpsDet;
  const float inv_det = ok ? 1.0f / det : 0.0f;
  const float tvx = ro.x - v0x;
  const float tvy = ro.y - v0y;
  const float tvz = ro.z - v0z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  if (!(ok && u >= 0.0f && u <= 1.0f)) return false;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = (rd.x * qvx + rd.y * qvy + rd.z * qvz) * inv_det;
  if (!(v >= 0.0f && u + v <= 1.0f)) return false;
  const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  *t_out = t;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > ro.w &&
         t <= bound && t < rd.w;
}

// Copy this warp's slice [k0, k0 + slice) of chunk c into s (three float4
// a triangle, the slot in the third one's y), dropping padding: a
// triangle with zero edges cannot be hit (det = 0). Returns the number of
// triangles staged; the caller syncs the warp.
__device__ __forceinline__ int stage_slice(float4* s,
                                           const float* __restrict__ tris,
                                           int chunk, int c, int k0,
                                           int slice, int lane) {
  const float* base = tris + static_cast<size_t>(c) * 16 * chunk;
  int n_real = 0;
  for (int r0 = 0; r0 < slice; r0 += 32) {
    const int k = k0 + r0 + lane;
    float v[9];
    bool real = false;
    if (r0 + lane < slice) {
#pragma unroll
      for (int row = 0; row < 9; ++row) v[row] = base[row * chunk + k];
      real = v[3] != 0.0f || v[4] != 0.0f || v[5] != 0.0f ||
             v[6] != 0.0f || v[7] != 0.0f || v[8] != 0.0f;
    }
    const unsigned m = __ballot_sync(kFullMask, real);
    if (real) {
      float4* t = s + 3 * (n_real + __popc(m & ((1u << lane) - 1)));
      t[0] = make_float4(v[0], v[1], v[2], v[3]);
      t[1] = make_float4(v[4], v[5], v[6], v[7]);
      t[2] = make_float4(v[8], __int_as_float(k), 0.0f, 0.0f);
    }
    n_real += __popc(m);
  }
  return n_real;
}

__global__ void __launch_bounds__(kCandThreads)
walk_candidates_kernel(const float* __restrict__ o,
                       const float* __restrict__ d,
                       const float* __restrict__ tmin,
                       const float* __restrict__ tmax, int n, int block_rays,
                       const float* __restrict__ boxes, int n_chunks,
                       int maxc_pad, float* __restrict__ entry) {
  extern __shared__ float4 s_ray[];  // 2 per ray: (o, ix), (iy, iz, tmin, tmax)
  const int b = blockIdx.x;
  for (int k = threadIdx.x; k < block_rays; k += blockDim.x) {
    const Ray r = load_ray(o, d, tmin, tmax, n, b * block_rays + k);
    s_ray[2 * k] = make_float4(r.ox, r.oy, r.oz, r.ix);
    s_ray[2 * k + 1] = make_float4(r.iy, r.iz, r.tmin, r.tmax);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < maxc_pad; c += blockDim.x) {
    float acc = kBig;
    if (c < n_chunks) {
      const float bnx = boxes[c];
      const float bny = boxes[n_chunks + c];
      const float bnz = boxes[2 * n_chunks + c];
      const float bxx = boxes[3 * n_chunks + c];
      const float bxy = boxes[4 * n_chunks + c];
      const float bxz = boxes[5 * n_chunks + c];
      for (int k = 0; k < block_rays; ++k) {
        const float4 p = s_ray[2 * k];
        const float4 q = s_ray[2 * k + 1];
        if (q.w >= 0.0f) {  // live ray, as the TPU kernel's pl.when
          const float tx0 = (bnx - p.x) * p.w;
          const float tx1 = (bxx - p.x) * p.w;
          const float ty0 = (bny - p.y) * q.x;
          const float ty1 = (bxy - p.y) * q.x;
          const float tz0 = (bnz - p.z) * q.y;
          const float tz1 = (bxz - p.z) * q.y;
          const float t_near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                                     fminf(tz0, tz1));
          const float t_far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                                    fmaxf(tz0, tz1));
          if (t_near <= t_far && t_far >= q.z && t_near <= q.w)
            acc = fminf(acc, fmaxf(t_near, 0.0f));
        }
      }
    }
    entry[static_cast<size_t>(b) * maxc_pad + c] = acc;
  }
}

// Both sweeps of one ray block (blockIdx.x) over its candidates in list
// order (design notes a-e above). Dynamic shared memory: per ray two
// float4 (origin, tmin | direction, tmax) and the reciprocal direction, the
// ray's merge key (closest) or blocked flag (occlusion), a slot in the
// chunk's list of passing rays; per warp its staged slice.
template <bool kClosest>
__device__ __forceinline__ void sweep(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax, int n,
    int block_rays, const int* __restrict__ cand,
    const float* __restrict__ tnear, const int* __restrict__ count,
    int maxc_pad, const float* __restrict__ boxes, int n_chunks,
    const float* __restrict__ tris, int chunk, float* __restrict__ out_t,
    int* __restrict__ out_i, int* __restrict__ swept,
    int* __restrict__ tests) {
  extern __shared__ float4 smem[];
  __shared__ int s_cid[kCandTile];
  __shared__ float s_tn[kCandTile];
  __shared__ float s_box[6 * kCandTile];
  __shared__ int s_total[3];       // rays in the chunk's list
  __shared__ unsigned s_flag[3];   // closest: max limit, ordered; any: open
  __shared__ int s_tests;
  const int nr = block_rays;
  float4* s_ro = smem;
  float4* s_rd = s_ro + nr;
  float4* s_ri = s_rd + nr;
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(s_ri + nr);
  volatile int* s_blk = reinterpret_cast<volatile int*>(s_key);
  int* s_slot = reinterpret_cast<int*>(s_key + nr);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slice = chunk / kWarps;
  float4* s_tri = reinterpret_cast<float4*>(s_slot + nr) + warp * 3 * slice;
  const unsigned lanes_below = (1u << lane) - 1;

  const int b = blockIdx.x;
  const int ray0 = b * nr;
  for (int q = threadIdx.x; q < nr; q += kThreads) {
    const Ray r = load_ray(o, d, tmin, tmax, n, ray0 + q);
    s_ro[q] = make_float4(r.ox, r.oy, r.oz, r.tmin);
    s_rd[q] = make_float4(r.dx, r.dy, r.dz, r.tmax);
    s_ri[q] = make_float4(r.ix, r.iy, r.iz, 0.0f);
    if (kClosest)
      s_key[q] = hit_key(kBig, 0xffffffffu);
    else
      s_blk[q] = 0;
  }
  if (threadIdx.x < 3) s_total[threadIdx.x] = s_flag[threadIdx.x] = 0;
  if (threadIdx.x == 0) s_tests = 0;
  const int n_cand = count[b];
  const int* cb = cand + static_cast<size_t>(b) * maxc_pad;
  const float* tb =
      kClosest ? tnear + static_cast<size_t>(b) * maxc_pad : nullptr;
  int n_swept = 0, n_tests = 0;
  bool stop = false;
  for (int j0 = 0; j0 < n_cand && !stop; j0 += kCandTile) {
    const int j1 = min(j0 + kCandTile, n_cand);
    __syncthreads();  // the last tile is read
    for (int x = threadIdx.x; x < j1 - j0; x += kThreads) {
      const int c = cb[j0 + x];
      s_cid[x] = c;
      if (kClosest) s_tn[x] = tb[j0 + x];
#pragma unroll
      for (int a = 0; a < 6; ++a)
        s_box[a * kCandTile + x] = boxes[a * n_chunks + c];
    }
    __syncthreads();
    for (int j = j0; j < j1; ++j) {
      // 1. every ray of the block tests the chunk's box; those that pass
      // join the chunk's list. Counters rotate over three slots: slot
      // (j + 1) % 3 was last read before the previous barrier.
      const int p = j % 3;
      if (threadIdx.x == 0) s_total[(j + 1) % 3] = s_flag[(j + 1) % 3] = 0;
      const float* box = s_box + (j - j0);
      float lim_max = -kBig;
      bool any_open = false;
      for (int q = threadIdx.x; q < nr; q += kThreads) {
        const float4 ro = s_ro[q];
        const float tmax_q = s_rd[q].w;
        const bool live = tmax_q > ro.w;
        const bool open = live && (kClosest || s_blk[q] == 0);
        const float limit = kClosest ? fminf(key_t(s_key[q]), tmax_q)
                                     : tmax_q;
        const bool pass = open && slab(ro, s_ri[q], box, limit);
        const unsigned m = __ballot_sync(kFullMask, pass);
        int at = 0;
        if (lane == 0 && m) at = atomicAdd(&s_total[p], __popc(m));
        at = __shfl_sync(kFullMask, at, 0);
        if (pass) s_slot[at + __popc(m & lanes_below)] = q;
        lim_max = fmaxf(lim_max, limit);
        any_open |= open;
      }
      if (kClosest) {
        const unsigned v = __reduce_max_sync(kFullMask, ordered(lim_max));
        if (lane == 0) atomicMax(&s_flag[p], v);
      } else if (__any_sync(kFullMask, any_open) && lane == 0) {
        s_flag[p] = 1;
      }
      __syncthreads();
      // candidates come sorted by entry distance: once one starts beyond
      // every ray's limit, no ray reaches it or any later one
      if (kClosest ? j > 0 && s_tn[j - j0] > unordered(s_flag[p])
                   : s_flag[p] == 0) {
        stop = true;
        break;
      }
      const int total = s_total[p];
      if (total == 0) continue;
      // 2. each warp stages its slice and sweeps it for every 32 rays of
      // the list
      ++n_swept;
      const int c = s_cid[j - j0];
      const int n_real = stage_slice(s_tri, tris, chunk, c, warp * slice,
                                     slice, lane);
      __syncwarp();
      for (int g = 0; g < total; g += 32) {
        // a group of n <= 16 rays takes 32 / w lanes a ray (w the power of
        // two from 4 up that holds n), each lane every (32 / w)-th triangle
        const int n_group = min(32, total - g);
        const int w = n_group > 16 ? 32 : n_group > 8 ? 16 : n_group > 4 ? 8
                                                                          : 4;
        const int q = lane % w < n_group ? s_slot[g + lane % w] : -1;
        if (q < 0) continue;
        const int k0 = lane / w, k_step = 32 / w;
        const float4 ro = s_ro[q];
        const float4 rd = s_rd[q];
        if (kClosest) {
          // the bound is some hit's t (or none's): never below the answer
          float bt = key_t(s_key[q]);
          unsigned bi = 0xffffffffu;
#pragma unroll 4
          for (int k = k0; k < n_real; k += k_step) {
            float t;
            ++n_tests;
            if (mt(ro, rd, s_tri + 3 * k, bt, &t)) {
              const unsigned id = static_cast<unsigned>(c * chunk) +
                                  __float_as_uint(s_tri[3 * k + 2].y);
              if (t < bt || id < bi) {
                bt = t;
                bi = id;
              }
            }
          }
          if (bi != 0xffffffffu) atomicMin(&s_key[q], hit_key(bt, bi));
        } else if (s_blk[q] == 0) {
          bool blocked = false;
#pragma unroll 4
          for (int k = k0; k < n_real && !blocked; k += k_step) {
            float t;
            blocked = mt(ro, rd, s_tri + 3 * k, kBig, &t);
            ++n_tests;
          }
          if (blocked) s_blk[q] = 1;
        }
      }
      __syncthreads();  // answers merged before the next chunk's tests
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < nr; q += kThreads) {
    const int i = ray0 + q;
    if (i >= n) break;
    if (kClosest) {
      const unsigned long long key = s_key[q];
      out_t[i] = key_t(key);
      const unsigned id = static_cast<unsigned>(key);
      out_i[i] = id == 0xffffffffu ? -1 : static_cast<int>(id);
    } else {
      out_i[i] = s_blk[q];
    }
  }
  n_tests = static_cast<int>(
      __reduce_add_sync(kFullMask, static_cast<unsigned>(n_tests)));
  if (lane == 0 && n_tests) atomicAdd(&s_tests, n_tests);
  __syncthreads();
  if (threadIdx.x == 0) {
    swept[b] = n_swept;
    tests[b] = s_tests;
  }
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
walk_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tmin,
                    const float* __restrict__ tmax, int n, int block_rays,
                    const int* __restrict__ cand,
                    const float* __restrict__ tnear,
                    const int* __restrict__ count, int maxc_pad,
                    const float* __restrict__ boxes, int n_chunks,
                    const float* __restrict__ tris, int chunk,
                    float* __restrict__ out_t, int* __restrict__ out_id,
                    int* __restrict__ swept, int* __restrict__ tests) {
  sweep<true>(o, d, tmin, tmax, n, block_rays, cand, tnear, count, maxc_pad,
              boxes, n_chunks, tris, chunk, out_t, out_id, swept, tests);
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
walk_any_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ tmin,
                const float* __restrict__ tmax, int n, int block_rays,
                const int* __restrict__ cand,
                const int* __restrict__ count, int maxc_pad,
                const float* __restrict__ boxes, int n_chunks,
                const float* __restrict__ tris, int chunk,
                int* __restrict__ out_blocked, int* __restrict__ swept,
                int* __restrict__ tests) {
  sweep<false>(o, d, tmin, tmax, n, block_rays, cand, nullptr, count,
               maxc_pad, boxes, n_chunks, tris, chunk, nullptr, out_blocked,
               swept, tests);
}

int grid_of(int n_rays, int block_rays) {
  return (n_rays + block_rays - 1) / block_rays;
}

// A sweep's dynamic shared memory: 60 bytes a ray (three float4, the
// 8-byte key or flag, the list slot) and 48 bytes a staged triangle.
size_t sweep_smem(int block_rays, int chunk) {
  return static_cast<size_t>(block_rays) *
             (3 * sizeof(float4) + sizeof(unsigned long long) + sizeof(int)) +
         static_cast<size_t>(chunk) * 3 * sizeof(float4);
}

// Launch one 8-warp CTA per ray block; raise the kernel's dynamic shared
// memory limit first where the launch needs more than 48 KB.
template <auto kKernel, typename... Args>
int launch_sweep(int n_rays, int block_rays, int chunk, void* stream,
                 Args... args) {
  if (n_rays == 0) return 0;
  const size_t smem = sweep_smem(block_rays, chunk);
  static size_t raised = 48 * 1024;
  if (smem > raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = smem;
  }
  kKernel<<<grid_of(n_rays, block_rays), kThreads, smem,
            static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every entry point launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 on success). o, d: [n, 3]; tmin, tmax:
// [n]; boxes: [6, n_chunks]; tris: [n_chunks, 16, chunk]; entry, cand,
// tnear: [n_blocks, maxc_pad]; count, swept, tests: [n_blocks], n_blocks =
// ceil(n / block_rays). All float32 / int32 and contiguous.
int walk_candidates(const float* o, const float* d, const float* tmin,
                    const float* tmax, int n_rays, int block_rays,
                    const float* boxes, int n_chunks, int maxc_pad,
                    float* entry, void* stream) {
  const size_t smem = static_cast<size_t>(block_rays) * 2 * sizeof(float4);
  walk_candidates_kernel<<<grid_of(n_rays, block_rays), kCandThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, n_rays, block_rays, boxes, n_chunks, maxc_pad, entry);
  return static_cast<int>(cudaGetLastError());
}

int walk_closest(const float* o, const float* d, const float* tmin,
                 const float* tmax, int n_rays, int block_rays,
                 const int* cand, const float* tnear, const int* count,
                 int maxc_pad, const float* boxes, int n_chunks,
                 const float* tris, int chunk, float* out_t, int* out_id,
                 int* swept, int* tests, void* stream) {
  return launch_sweep<walk_closest_kernel>(
      n_rays, block_rays, chunk, stream, o, d, tmin, tmax, n_rays,
      block_rays, cand, tnear, count, maxc_pad, boxes, n_chunks, tris, chunk,
      out_t, out_id, swept, tests);
}

int walk_any(const float* o, const float* d, const float* tmin,
             const float* tmax, int n_rays, int block_rays, const int* cand,
             const int* count, int maxc_pad, const float* boxes,
             int n_chunks, const float* tris, int chunk, int* out_blocked,
             int* swept, int* tests, void* stream) {
  return launch_sweep<walk_any_kernel>(
      n_rays, block_rays, chunk, stream, o, d, tmin, tmax, n_rays,
      block_rays, cand, count, maxc_pad, boxes, n_chunks, tris, chunk,
      out_blocked, swept, tests);
}

}  // extern "C"
