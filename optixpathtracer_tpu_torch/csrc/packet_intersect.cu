// The packet engine for Hopper: per-8-ray-packet closest-hit and occlusion
// sweeps over 128-triangle subchunks.
//
// Replaces optixpathtracer_tpu/intersect/packet_kernels.py
//   _make_packet_closest_kernel (:182, launched by _sweep_call :510 from
//                                intersect_closest_raw :571)
//     -> packet_closest_kernel
//   _make_packet_any_kernel     (:290, from intersect_any :621)
//     -> packet_any_kernel
// and fuses the mask formation the reference runs between its kernels
// (_packet_words :422). They keep the reference's output contract, not its
// TPU schedule (the MXU one-hot ray extraction, the VMEM union ring and its
// overflow DMA were TPU means):
//   * A packet is 8 consecutive rays of the coherence-sorted wavefront;
//     packet p holds rays 8p .. 8p + 7 and belongs to ray block
//     8p / block_rays, whose candidate row (cand, tnear, count: the walk
//     engine's sorted union) it sweeps. Rays past the end are padding with
//     tmax = -1.
//   * Union subchunk s (s = j * n_sub + k, j the candidate rank, n_sub =
//     chunk / 128) is triangles [cand[j] * chunk + 128 k, + 128). Bit s % 32
//     of the packet's word s / 32 is set where j < count and some ray of
//     the packet passes the subchunk box's slab test: t_near from -3.4e38,
//     t_far from 3.4e38, per axis (b - o) * inv, then t_near <= t_far,
//     t_far >= tmin, t_near <= tmax, tmax >= 0 (t_near not clamped at 0).
//   * The packet sweeps the subchunks whose bit is set, in ascending s:
//     Moller-Trumbore in _mt_packet's operation order, |det| > 1e-12, u,
//     v >= 0, u + v <= 1, t > tmin, t <= best t (inclusive), t < tmax; ties
//     (t == best t) go to the lower id. So the answer is brute's (t, lowest
//     id) over those subchunks in any order; a miss is t = 3.4e38, id = -1.
//   * Exit: before a word is formed and before each set subchunk is swept,
//     the sweep stops once tnear of that subchunk's rank (of the word's
//     first rank) exceeds the packet's limit: closest, the max over live
//     rays of min(best t, tmax); any, the max over live unblocked rays of
//     tmax. Candidates ascend in entry distance, so no later subchunk can
//     change a ray's answer. any: blocked = 1 if some swept triangle has
//     tmin < t < tmax; the packet also stops once every live ray is
//     blocked.
//   * Built with --fmad=false: every product and sum rounds separately, as
//     in the plain PyTorch versions, so words are bit-identical and ids
//     break ties the same way.
//
// Design. One CTA of kWarps warps sweeps one ray block; a warp sweeps one
// packet at a time. Lane l holds ray l % 8 of the packet in registers and
// tests it against triangles 4 k + l / 8 of each swept subchunk (the TPU's
// 8 rays x 128 triangles of one vector op, carried onto 32 lanes), keeping
// a running (t, id) for its ray; shuffles over the ray's four lanes give
// the packet's limit and, with the lowest id at the best t, the answer.
// It answers the four losses of the first port (one warp per packet, four
// packets a CTA, every packet reading its block's union and its triangles
// from L2 itself). Each step's share is the time the kernel loses on hall's
// bounce-1 (bounce-0) wavefront with that step taken out, measured with
// packet_bench.py on an H100 (PERF.md); the whole: closest 12.07 ms where
// the first port took 17.94 (9.11 / 12.40), any 6.91 where it took 7.29
// (7.41 / 8.34).
//   1. Union re-reads. The CTA stages its block's candidate ranks, tnear and
//      subchunk boxes in shared memory once, in tiles of the union
//      (tile_ranks ranks, sized by packet_kernels.smem_plan), where the
//      first port made every packet load cand and six scattered box floats
//      per lane per word itself. A word is a ballot of slab tests against
//      the shared boxes. Between tiles a packet's (t, id) per ray (any: its
//      blocked mask) and its exit flag wait in shared memory. Share: 1%
//      (0.4%) of closest, none of any: the loads it saves were two a word.
//   2. Word-granular exit. The closest sweep checks the exit before each
//      set subchunk, not once per 32-subchunk word (16 candidate chunks at
//      chunk 256); the limit is refreshed only when a lane improved a ray
//      (one vote). The occlusion sweep already stopped per subchunk once
//      every ray was blocked; its tmax exit is checked where a word is
//      formed. Share: 0.9% (10%) of closest, with 1.4% (11%) fewer tests.
//   3. Unpipelined triangle loads. A warp copies each swept subchunk's 9 x
//      128 floats into shared memory with cp.async and reads its triangles
//      from there: each lane's nine loads a test are shared-memory loads,
//      four distinct words a warp, instead of L1/L2 loads. No copy is kept
//      in flight ahead of the tests: with 32 warps an SM the others hide
//      the wait. A second stage takes the CTA from 56 to ~93 KB, so 2 CTAs
//      an SM: 13-17% slower; at equal occupancy it bought nothing for
//      closest and 3% for any. Copies are per warp: packets of a block set
//      different bits, so a shared copy would make warps wait for each
//      other.
//      Share: read from L1/L2 instead, closest takes 34% (24%) longer and
//      any 52% (51%).
//   4. Idle warps. A warp that finishes a packet takes the block's next one
//      from a shared counter, so a CTA waits only for its last packet. With
//      one ray and one triangle live a lane, a kernel takes 56-60
//      registers, so four 256-thread CTAs (kCtasPerSm, which
//      __launch_bounds__ and the plan share) run on an SM: 32 warps, where
//      the first port's 94 and 72 registers allowed 20 and 28. Shares: the
//      shared counter 5% (2%) of closest, under 1% of any; the lane mapping
//      and its registers 45% (37%) of closest and 18% (21%) of any (steps
//      1-4 on the first port's mapping, 118 and 100 registers).
// Rays that cannot hit (tmax <= tmin: dead lanes, padding) take no tests.
// An optional output receives the words the kernel formed, so a check can
// hold them bit for bit against the plain version (null on the main path);
// when it is given, words past the exit are still formed.
//
// What bounds it on the H100: FP32 throughput. Per swept subchunk a packet
// runs 8 x 128 tests of 54 separately rounded FP32 operations, and per
// union subchunk up to 8 slab tests of 28; the bytes are the block's
// candidate row and boxes once per CTA and 4.6 KB of triangles per swept
// subchunk per packet from L2 (hall's 21.7 MB of walk triangles fit the
// H100's 50 MB). A closest test issues 79-83 instructions (cuobjdump
// -sass): the 54 counted, nine shared-memory loads, the IEEE reciprocal's
// range check and the (t, id) select; that alone holds it to ~67% of the
// bound.
// Every launch writes, per ray block, the subchunks swept, the
// ray-triangle tests run and the ray-subchunk slab tests run, from which
// the bound is computed.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kPacket = 8;          // rays per packet
constexpr int kSub = 128;           // triangles per subchunk
constexpr int kRows = 9;            // v0, e1, e2 rows of the walk layout
constexpr int kTriPerLane = kSub / 32;
constexpr int kWarps = 8;           // warps per CTA (packet_kernels.WARPS)
constexpr int kCtasPerSm = 4;       // CTAS_PER_SM: registers and the plan
constexpr float kBig = 3.4e38f;
constexpr float kEpsDet = 1e-12f;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float safe_inv(float d) {
  const float tiny = d >= 0.0f ? 1e-20f : -1e-20f;
  return 1.0f / (fabsf(d) < 1e-20f ? tiny : d);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Dynamic shared memory of one CTA; packet_kernels.smem_bytes mirrors it.
struct Smem {
  float4* ring;     // [kWarps][kRows][32]: a subchunk's 9 rows x 128
  float4* rays;     // [kWarps][kPacket][3]
  float* box;       // [6][tile_ranks * n_sub]: the tile's subchunk boxes
  int* cand;        // [tile_ranks]
  float* tnear;     // [tile_ranks]
  float* state_t;   // [packets][kPacket]: best t (closest)
  int* state_id;    // [packets][kPacket]: best id; any: [p * 8] = blocked
  int* done;        // [packets]
  int* misc;        // next packet, swept, tests, slabs

  // Lays the sections out from base (when s is given) and returns the
  // bytes they take; every section starts 16-byte aligned.
  __host__ __device__ static size_t bytes(int tile_ranks, int n_sub,
                                          int packets, char* base,
                                          Smem* s) {
    const size_t sizes[9] = {
        sizeof(float4) * kWarps * kRows * 32,
        sizeof(float4) * kWarps * kPacket * 3,
        sizeof(float) * 6 * tile_ranks * n_sub,
        sizeof(int) * tile_ranks,
        sizeof(float) * tile_ranks,
        sizeof(float) * packets * kPacket,
        sizeof(int) * packets * kPacket,
        sizeof(int) * packets,
        sizeof(int) * 4};
    char* at[9];
    size_t off = 0;
    for (int i = 0; i < 9; ++i) {
      at[i] = base + off;
      off += align16(sizes[i]);
    }
    if (s != nullptr) {
      *s = Smem{reinterpret_cast<float4*>(at[0]),
                reinterpret_cast<float4*>(at[1]),
                reinterpret_cast<float*>(at[2]), reinterpret_cast<int*>(at[3]),
                reinterpret_cast<float*>(at[4]),
                reinterpret_cast<float*>(at[5]), reinterpret_cast<int*>(at[6]),
                reinterpret_cast<int*>(at[7]), reinterpret_cast<int*>(at[8])};
    }
    return off;
  }
};

struct Query {
  const float* o;
  const float* d;
  const float* tmin;
  const float* tmax;
  int n;
  int block_rays;
  const int* cand;
  const float* tnear;
  const int* count;
  int maxc_pad;
  const float* sub_box;
  int n_chunks;
  const float* tris;
  int chunk;
  int tile_ranks;
  int* words;  // [n_packets, maxc_pad * n_sub / 32] or null
  int* swept;
  int* tests;
  int* slabs;
};

// One tile of the block's union: ranks [j0, j1), subchunks [s0, s1).
struct Tile {
  int j0, j1, s0, s1, subs;  // subs: tile_ranks * n_sub, the box stride
};

// Stage the tile's cand, tnear and subchunk boxes (all threads).
__device__ void stage_tile(const Query& q, const Smem& s, int blk, int n_sub,
                           const Tile& t) {
  const int* cb = q.cand + static_cast<size_t>(blk) * q.maxc_pad;
  const float* tb = q.tnear + static_cast<size_t>(blk) * q.maxc_pad;
  const int n_sub_total = q.n_chunks * n_sub;
  for (int i = threadIdx.x; i < t.j1 - t.j0; i += blockDim.x) {
    s.cand[i] = cb[t.j0 + i];
    s.tnear[i] = tb[t.j0 + i];
  }
  for (int i = threadIdx.x; i < t.s1 - t.s0; i += blockDim.x) {
    const int j = (t.s0 + i) / n_sub;
    const int sid = cb[j] * n_sub + (t.s0 + i - j * n_sub);
#pragma unroll
    for (int a = 0; a < 6; ++a)
      s.box[a * t.subs + i] = q.sub_box[a * n_sub_total + sid];
  }
}

// Stage packet p's rays in s_ray[r] as (ox oy oz tmin | dx dy dz tmax |
// ix iy iz -); rays past the end are padding: origin 0, direction 1,
// tmin 0, tmax -1. Lanes 0..7 load. Returns the live mask: bit r set where
// ray r has some t with tmin < t < tmax.
__device__ __forceinline__ unsigned stage_rays(float4 (*s_ray)[3],
                                               const Query& q, int p,
                                               int lane) {
  bool live = false;
  if (lane < kPacket) {
    const int i = p * kPacket + lane;
    float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 1.0f, dy = 1.0f, dz = 1.0f;
    float mn = 0.0f, mx = -1.0f;
    if (i < q.n) {
      ox = q.o[3 * i]; oy = q.o[3 * i + 1]; oz = q.o[3 * i + 2];
      dx = q.d[3 * i]; dy = q.d[3 * i + 1]; dz = q.d[3 * i + 2];
      mn = q.tmin[i];
      mx = q.tmax[i];
    }
    s_ray[lane][0] = make_float4(ox, oy, oz, mn);
    s_ray[lane][1] = make_float4(dx, dy, dz, mx);
    s_ray[lane][2] = make_float4(safe_inv(dx), safe_inv(dy), safe_inv(dz),
                                 0.0f);
    live = mx > mn;
  }
  __syncwarp();
  return __ballot_sync(kFullMask, live);
}

// _packet_words' slab test of one ray against one subchunk box.
__device__ __forceinline__ bool sub_slab(const float4 (*ray)[3], int r,
                                         const float* bn, const float* bx) {
  const float4 a = ray[r][0];
  const float4 b = ray[r][1];
  const float4 c = ray[r][2];
  const float ov[3] = {a.x, a.y, a.z};
  const float iv[3] = {c.x, c.y, c.z};
  float t_near = -kBig;
  float t_far = kBig;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float p0 = (bn[ax] - ov[ax]) * iv[ax];
    const float p1 = (bx[ax] - ov[ax]) * iv[ax];
    t_near = fmaxf(t_near, fminf(p0, p1));
    t_far = fminf(t_far, fmaxf(p0, p1));
  }
  return t_near <= t_far && t_far >= a.w && t_near <= b.w && b.w >= 0.0f;
}

// Word w of the packet's mask from the staged boxes: lane b tests union
// subchunk w * 32 + b. Adds the slab tests this lane ran to *n_slabs.
__device__ __forceinline__ unsigned packet_word(const float4 (*s_ray)[3],
                                                const Smem& s, const Tile& t,
                                                int w, int lane,
                                                int* n_slabs) {
  const int sg = w * 32 + lane;
  bool pass = false;
  if (sg < t.s1) {  // ranks < count are listed candidates (tnear < BIG)
    const int i = sg - t.s0;
    const float bn[3] = {s.box[i], s.box[t.subs + i], s.box[2 * t.subs + i]};
    const float bx[3] = {s.box[3 * t.subs + i], s.box[4 * t.subs + i],
                         s.box[5 * t.subs + i]};
    for (int r = 0; r < kPacket && !pass; ++r) {
      pass = sub_slab(s_ray, r, bn, bx);
      ++*n_slabs;
    }
  }
  return __ballot_sync(kFullMask, pass);
}

struct Tri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

// Copy the subchunk of cand c starting at triangle `base` into the warp's
// staging buffer `st` (lane l copies floats 4l .. 4l + 3 of each of the 9
// rows) and wait for it: other warps' tests hide the wait.
__device__ __forceinline__ void stage_sub(float4* st, const Query& q, int c,
                                          int base, int lane) {
  const float* src = q.tris + static_cast<size_t>(c) * 16 * q.chunk + base +
                     4 * lane;
#pragma unroll
  for (int row = 0; row < kRows; ++row)
    cp_async16(st + row * 32 + lane, src + static_cast<size_t>(row) * q.chunk);
  cp_async_wait_all();
  __syncwarp();
}

// Triangle e of a staged subchunk.
__device__ __forceinline__ Tri staged_tri(const float4* st, int e) {
  const float* f = reinterpret_cast<const float*>(st);
  Tri t;
  t.v0x = f[e]; t.v0y = f[kSub + e]; t.v0z = f[2 * kSub + e];
  t.e1x = f[3 * kSub + e]; t.e1y = f[4 * kSub + e]; t.e1z = f[5 * kSub + e];
  t.e2x = f[6 * kSub + e]; t.e2y = f[7 * kSub + e]; t.e2z = f[8 * kSub + e];
  return t;
}

// _mt_packet for one (ray, triangle) pair, same operation order; a is
// (ox oy oz tmin), b is (dx dy dz tmax). Returns tmin < t <= bound &&
// t < tmax inside the triangle, and t.
__device__ __forceinline__ bool mt(const float4& a, const float4& b,
                                   const Tri& tr, float bound,
                                   float* t_out) {
  const float ox = a.x, oy = a.y, oz = a.z, dx = b.x, dy = b.y, dz = b.z;
  const float pvx = dy * tr.e2z - dz * tr.e2y;
  const float pvy = dz * tr.e2x - dx * tr.e2z;
  const float pvz = dx * tr.e2y - dy * tr.e2x;
  const float det = tr.e1x * pvx + tr.e1y * pvy + tr.e1z * pvz;
  const bool ok = fabsf(det) > kEpsDet;
  // divide unconditionally and select: the same value, and no branch
  // around the IEEE reciprocal
  const float rcp = 1.0f / det;
  const float inv_det = ok ? rcp : 0.0f;
  const float tvx = ox - tr.v0x;
  const float tvy = oy - tr.v0y;
  const float tvz = oz - tr.v0z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * tr.e1z - tvz * tr.e1y;
  const float qvy = tvz * tr.e1x - tvx * tr.e1z;
  const float qvz = tvx * tr.e1y - tvy * tr.e1x;
  const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
  const float t = (tr.e2x * qvx + tr.e2y * qvy + tr.e2z * qvz) * inv_det;
  *t_out = t;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > a.w &&
         t <= bound && t < b.w;
}

// The set bits of a packet's words over one tile, in ascending order,
// forming each word when it is reached. Every member is warp-uniform.
struct Cursor {
  const float4 (*s_ray)[3];
  const Smem* s;
  const Tile* t;
  int n_sub;
  int* words;     // the packet's row of the optional output, or null
  int w, w_end;   // next word to form, end of the tile's words
  unsigned bits;  // set bits of the current word not yet taken
  bool done;      // exited: take no more bits (words are still formed)

  // Next set subchunk, or -1 at the tile's end or on an exit at a word's
  // first rank (tnear of that rank > limit).
  __device__ __forceinline__ int next(float limit, int lane, int* n_slabs) {
    for (;;) {
      if (bits != 0u && !done) {
        const int sg = (w - 1) * 32 + __ffs(bits) - 1;
        bits &= bits - 1u;
        return sg;
      }
      if (w >= w_end) return -1;
      if (!done && s->tnear[w * 32 / n_sub - t->j0] > limit) done = true;
      if (done && words == nullptr) return -1;
      bits = packet_word(s_ray, *s, *t, w, lane, n_slabs);
      if (words != nullptr && lane == 0) words[w] = static_cast<int>(bits);
      ++w;
    }
  }
};

// One packet on its warp: lane l holds ray l % 8 of the packet in
// registers and owns triangles 4 k + l / 8 (k < 32) of a staged subchunk,
// so a lane keeps one ray, one triangle and one answer live: few
// registers, many warps an SM. The four lanes of a group read one float of
// four neighbouring triangles per load, without bank conflicts.
struct PacketLanes {
  float4 a, b;  // the lane's ray: (ox oy oz tmin), (dx dy dz tmax)
  int r;        // its index in the packet
  unsigned live_mask;

  __device__ __forceinline__ void begin_rays(const float4 (*s_ray)[3],
                                             unsigned live_in, int lane) {
    r = lane & (kPacket - 1);
    a = s_ray[r][0];
    b = s_ray[r][1];
    live_mask = live_in;
  }

  // max of v over the packet's rays (lanes l ^ 1, l ^ 2, l ^ 4)
  __device__ __forceinline__ static float rays_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, 1));
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, 2));
    return fmaxf(v, __shfl_xor_sync(kFullMask, v, 4));
  }
};

// The closest sweep: a running (t, id) per lane for its ray.
struct ClosestSweep : PacketLanes {
  static constexpr bool kClosest = true;
  float bt;
  int bi;

  __device__ __forceinline__ void begin(const float4 (*s_ray)[3],
                                        unsigned live_in, const float* st_t,
                                        const int* st_id, int lane) {
    begin_rays(s_ray, live_in, lane);
    bt = st_t[r];
    bi = st_id[r];
  }

  // The ray's best t over its lanes (l ^ 8, l ^ 16).
  __device__ __forceinline__ float ray_best() const {
    const float m = fminf(bt, __shfl_xor_sync(kFullMask, bt, 8));
    return fminf(m, __shfl_xor_sync(kFullMask, m, 16));
  }

  // max over live rays of min(best t, tmax)
  __device__ __forceinline__ float limit() const {
    const float best = ray_best();  // every lane shuffles
    return rays_max((live_mask >> r) & 1u ? fminf(best, b.w)
                                          : __int_as_float(0xff800000));
  }

  // Test the staged subchunk; returns whether the limit may have moved.
  __device__ __forceinline__ bool run(const float4* st, int first, int lane,
                                      int* n_tests) {
    bool changed = false;
    if ((live_mask >> r) & 1u) {
      const int g = lane >> 3;
#pragma unroll 4
      for (int k = 0; k < kSub / 4; ++k) {
        const int e = 4 * k + g;
        float t;
        // a hit has t <= bt: better if nearer, or as near and lower id
        if (mt(a, b, staged_tri(st, e), bt, &t) &&
            (t < bt || first + e < bi)) {
          bt = t;
          bi = first + e;
          changed = true;
        }
      }
    }
    *n_tests += __popc(live_mask) * kTriPerLane;
    return __any_sync(kFullMask, changed);
  }

  __device__ __forceinline__ bool all_blocked() const { return false; }

  // The packet's answer so far: lane r < 8 stores ray r's (t, lowest id).
  __device__ __forceinline__ void end(float* st_t, int* st_id,
                                      int lane) const {
    const float m = ray_best();
    int sel = bt == m ? bi : INT_MAX;
    sel = min(sel, __shfl_xor_sync(kFullMask, sel, 8));
    sel = min(sel, __shfl_xor_sync(kFullMask, sel, 16));
    if (lane < kPacket) {
      st_t[lane] = m;
      st_id[lane] = m < kBig ? sel : -1;
    }
  }
};

// The occlusion sweep: a lane tests its ray, while the ray is open (live
// and unblocked), against its triangles in order of k until it finds a
// blocker; the packet's blocked mask is the OR of the lanes' finds.
struct AnySweep : PacketLanes {
  static constexpr bool kClosest = false;
  unsigned blocked;

  __device__ __forceinline__ void begin(const float4 (*s_ray)[3],
                                        unsigned live_in, const float*,
                                        const int* st_id, int lane) {
    begin_rays(s_ray, live_in, lane);
    blocked = static_cast<unsigned>(st_id[0]);
  }

  __device__ __forceinline__ bool open() const {
    return ((live_mask & ~blocked) >> r) & 1u;
  }

  // max over open rays of tmax
  __device__ __forceinline__ float limit() const {
    return rays_max(open() ? b.w : __int_as_float(0xff800000));
  }

  __device__ __forceinline__ bool run(const float4* st, int, int lane,
                                      int* n_tests) {
    bool hit = false;
    if (open()) {
      const int g = lane >> 3;
      for (int k = 0; k < kSub / 4 && !hit; ++k) {
        float t;
        hit = mt(a, b, staged_tri(st, 4 * k + g), kBig, &t);
        ++*n_tests;
      }
    }
    unsigned hits = __ballot_sync(kFullMask, hit);  // bit l: ray l % 8
    hits = (hits | hits >> 8 | hits >> 16 | hits >> 24) & 0xffu;
    const bool moved = (blocked | hits) != blocked;
    blocked |= hits;
    return moved;
  }

  __device__ __forceinline__ bool all_blocked() const {
    return (blocked & live_mask) == live_mask;
  }

  __device__ __forceinline__ void end(float*, int* st_id, int lane) const {
    if (lane == 0) st_id[0] = static_cast<int>(blocked);
  }
};

// The CTA of ray block blockIdx.x. Packets wait in shared memory between
// tiles: closest (t, id) per ray, any the blocked mask; then one pass
// writes the block's answers.
template <typename Sweep>
__device__ void sweep_block(const Query& q, float* out_t, int* out_id) {
  constexpr bool kClosest = Sweep::kClosest;
  extern __shared__ __align__(16) char smem_raw[];
  const int n_sub = q.chunk / kSub;
  const int packets = q.block_rays / kPacket;
  Smem s;
  Smem::bytes(q.tile_ranks, n_sub, packets, smem_raw, &s);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int blk = blockIdx.x;
  float4 (*s_ray)[3] = reinterpret_cast<float4 (*)[3]>(
      s.rays + warp * kPacket * 3);
  float4* st = s.ring + warp * kRows * 32;

  for (int i = threadIdx.x; i < packets * kPacket; i += blockDim.x) {
    s.state_t[i] = kBig;
    s.state_id[i] = kClosest ? -1 : 0;
  }
  for (int i = threadIdx.x; i < packets; i += blockDim.x) s.done[i] = 0;
  if (threadIdx.x < 4) s.misc[threadIdx.x] = 0;

  const int count = q.count[blk];
  const int words_row = q.maxc_pad * n_sub / 32;
  int n_swept = 0, n_tests = 0, n_slabs = 0;
  for (int j0 = 0; j0 < count; j0 += q.tile_ranks) {
    const int j1 = min(j0 + q.tile_ranks, count);
    const Tile t{j0, j1, j0 * n_sub, j1 * n_sub, q.tile_ranks * n_sub};
    __syncthreads();  // the previous tile is finished, the state is set
    stage_tile(q, s, blk, n_sub, t);
    if (threadIdx.x == 0) s.misc[0] = 0;
    __syncthreads();
    for (;;) {  // take the block's next packet
      int pl = 0;
      if (lane == 0) pl = atomicAdd(s.misc, 1);
      pl = __shfl_sync(kFullMask, pl, 0);
      if (pl >= packets) break;
      const int p = blk * packets + pl;
      if (p * kPacket >= q.n) continue;  // all padding: no bit, no answer
      bool done = s.done[pl] != 0;
      if (done && q.words == nullptr) continue;
      const unsigned live = stage_rays(s_ray, q, p, lane);
      float* st_t = s.state_t + pl * kPacket;
      int* st_id = s.state_id + pl * kPacket;
      Sweep sw;
      sw.begin(s_ray, live, st_t, st_id, lane);
      Cursor cur{s_ray, &s, &t, n_sub,
                 q.words == nullptr ? nullptr
                                    : q.words + static_cast<size_t>(p) * words_row,
                 t.s0 / 32, (t.s1 + 31) / 32, 0u, done || live == 0u};
      float limit = sw.limit();
      for (int sg = cur.next(limit, lane, &n_slabs); sg >= 0;
           sg = cur.next(limit, lane, &n_slabs)) {
        const int j = sg / n_sub;
        // closest: no later subchunk can do better (for the occlusion sweep
        // this check runs where a word is formed: tested per subchunk it
        // saved no test on hall and cost ~1%)
        if (kClosest && s.tnear[j - j0] > limit) {
          cur.done = true;
          break;
        }
        const int c = s.cand[j - j0];
        const int base = (sg - j * n_sub) * kSub;
        stage_sub(st, q, c, base, lane);
        if (sw.run(st, c * q.chunk + base, lane, &n_tests))
          limit = sw.limit();
        ++n_swept;
        __syncwarp();  // every lane is done with the staged subchunk
        if (sw.all_blocked()) {
          cur.done = true;
          break;
        }
      }
      cur.next(limit, lane, &n_slabs);  // after an exit: words still asked
      sw.end(st_t, st_id, lane);
      if (lane == 0) s.done[pl] = cur.done ? 1 : 0;
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < q.block_rays; i += blockDim.x) {
    const int ray = blk * q.block_rays + i;
    if (ray >= q.n) break;
    if (kClosest) {
      out_t[ray] = s.state_t[i];
      out_id[ray] = s.state_id[i];
    } else {
      out_id[ray] = (s.state_id[(i / kPacket) * kPacket] >> (i % kPacket)) & 1;
    }
  }
  n_tests = __reduce_add_sync(kFullMask, n_tests);
  n_slabs = __reduce_add_sync(kFullMask, n_slabs);
  if (lane == 0) {
    atomicAdd(s.misc + 1, n_swept);
    atomicAdd(s.misc + 2, n_tests);
    atomicAdd(s.misc + 3, n_slabs);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    q.swept[blk] += s.misc[1];
    q.tests[blk] += s.misc[2];
    q.slabs[blk] += s.misc[3];
  }
}

__global__ void __launch_bounds__(kWarps * 32, kCtasPerSm)
packet_closest_kernel(const Query q, float* __restrict__ out_t,
                      int* __restrict__ out_id) {
  sweep_block<ClosestSweep>(q, out_t, out_id);
}

__global__ void __launch_bounds__(kWarps * 32, kCtasPerSm)
packet_any_kernel(const Query q, int* __restrict__ out_blocked) {
  sweep_block<AnySweep>(q, nullptr, out_blocked);
}

// Launch `kernel` with one CTA per ray block and smem_bytes of dynamic
// shared memory, after checking that the plan's bytes hold the layout.
template <typename Kernel, typename... Out>
int launch(Kernel kernel, const Query& q, int smem_bytes, void* stream,
           Out... out) {
  const int n_blocks = (q.n + q.block_rays - 1) / q.block_rays;
  if (n_blocks == 0) return 0;
  if (q.tile_ranks <= 0 || q.tile_ranks * (q.chunk / kSub) % 32 != 0 ||
      static_cast<size_t>(smem_bytes) <
          Smem::bytes(q.tile_ranks, q.chunk / kSub, q.block_rays / kPacket,
                      nullptr, nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_blocks, kWarps * 32, smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(q, out...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Both entry points launch on `stream`, do not synchronise, and return
// cudaGetLastError() (0 on success). o, d: [n, 3]; tmin, tmax: [n];
// cand, tnear: [n_blocks, maxc_pad]; count, swept, tests, slabs:
// [n_blocks] (zeroed by the caller), n_blocks = ceil(n / block_rays),
// block_rays a multiple of 8; sub_box: [6, n_chunks * chunk / 128];
// tris: [n_chunks, 16, chunk], 16-byte aligned, chunk a multiple of 128;
// tile_ranks, smem_bytes: packet_kernels.smem_plan (tile_ranks * chunk /
// 128 a multiple of 32); words: null or [n_blocks * block_rays / 8,
// maxc_pad * chunk / 128 / 32] (zeroed by the caller). All float32 /
// int32 and contiguous.
int packet_closest(const float* o, const float* d, const float* tmin,
                   const float* tmax, int n_rays, int block_rays,
                   const int* cand, const float* tnear, const int* count,
                   int maxc_pad, const float* sub_box, int n_chunks,
                   const float* tris, int chunk, int tile_ranks,
                   int smem_bytes, float* out_t, int* out_id, int* words,
                   int* swept, int* tests, int* slabs, void* stream) {
  const Query q{o, d, tmin, tmax, n_rays, block_rays, cand, tnear, count,
                maxc_pad, sub_box, n_chunks, tris, chunk, tile_ranks, words,
                swept, tests, slabs};
  return launch(packet_closest_kernel, q, smem_bytes, stream, out_t, out_id);
}

int packet_any(const float* o, const float* d, const float* tmin,
               const float* tmax, int n_rays, int block_rays, const int* cand,
               const float* tnear, const int* count, int maxc_pad,
               const float* sub_box, int n_chunks, const float* tris,
               int chunk, int tile_ranks, int smem_bytes, int* out_blocked,
               int* words, int* swept, int* tests, int* slabs,
               void* stream) {
  const Query q{o, d, tmin, tmax, n_rays, block_rays, cand, tnear, count,
                maxc_pad, sub_box, n_chunks, tris, chunk, tile_ranks, words,
                swept, tests, slabs};
  return launch(packet_any_kernel, q, smem_bytes, stream, out_blocked);
}

}  // extern "C"
