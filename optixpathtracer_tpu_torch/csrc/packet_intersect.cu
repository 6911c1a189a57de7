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
//   * The packet sweeps exactly the subchunks whose bit is set:
//     Moller-Trumbore in _mt_packet's operation order, |det| > 1e-12, u,
//     v >= 0, u + v <= 1, t > tmin, t <= best t (inclusive), t < tmax; ties
//     (t == best t) go to the lower id. So the answer is brute's (t, lowest
//     id) over those subchunks in any order; a miss is t = 3.4e38, id = -1.
//   * closest: after word w the sweep stops once tnear[min((w + 1) * 32 /
//     n_sub, maxc_pad - 1)] exceeds the max over the packet's live rays of
//     min(best t, tmax): candidates ascend in entry distance, so no later
//     subchunk can improve a ray. any: blocked = 1 if some swept triangle
//     has tmin < t < tmax; the packet stops once every live ray is blocked.
//   * Built with --fmad=false: every product and sum rounds separately, as
//     in the plain PyTorch versions, so words are bit-identical and ids
//     break ties the same way.
//
// Design. One warp per packet, the TPU's role flip (8 rays x 128 triangles
// in one vector op) carried onto the warp's 32 lanes. The packet's rays sit
// in shared memory (48 B a ray), read as broadcasts. For word w, lane b
// slab-tests subchunk w * 32 + b against the packet's rays, and
// __ballot_sync of the lanes' results is the reference's word by
// construction: the words never reach device memory (at 1080p on hall they
// would be ~91 MB). The warp then sweeps the word's set bits: each lane owns
// 4 of the subchunk's 128 triangles, read straight from the walk layout
// (coalesced rows, through L2: hall's 21.7 MB of walk triangles fit the
// H100's 50 MB), and keeps a running (t, id) per ray. At each word boundary
// a shuffle min per ray gives the packet's early-exit limit; at the end a
// shuffle min and a min over the ids at that t give each ray's answer.
// Rays that cannot hit (tmax <= tmin: dead lanes, padding) take no tests.
// An optional output receives the words the kernel formed, so a check can
// hold them bit for bit against the plain version (null on the main path).
//
// What bounds it on the H100: FP32 throughput. A packet reads 8 rays and
// its block's candidate row once, a subchunk box (24 B) per slab test and
// 4.6 KB of triangles per swept subchunk from L2, against 8 x 128 tests of
// 54 separately rounded FP32 operations per swept subchunk and 8 slab tests
// of ~20 per union subchunk. Every launch writes, per ray block, the
// subchunks swept, the ray-triangle tests run and the ray-subchunk slab
// tests run, from which the bound is computed.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kPacket = 8;          // rays per packet
constexpr int kSub = 128;           // triangles per subchunk
constexpr int kTriPerLane = kSub / 32;
constexpr int kWarps = 4;           // packets per CUDA block
constexpr float kBig = 3.4e38f;
constexpr float kEpsDet = 1e-12f;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float safe_inv(float d) {
  const float tiny = d >= 0.0f ? 1e-20f : -1e-20f;
  return 1.0f / (fabsf(d) < 1e-20f ? tiny : d);
}

// Stage the packet's rays in s_ray[r] as (ox oy oz tmin | dx dy dz tmax |
// ix iy iz -); rays past the end are padding: origin 0, direction 1,
// tmin 0, tmax -1. Lanes 0..7 load.
__device__ __forceinline__ void stage_rays(float4 (*s_ray)[3],
                                           const float* __restrict__ o,
                                           const float* __restrict__ d,
                                           const float* __restrict__ tmin,
                                           const float* __restrict__ tmax,
                                           int n, int p, int lane) {
  if (lane < kPacket) {
    const int i = p * kPacket + lane;
    float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 1.0f, dy = 1.0f, dz = 1.0f;
    float mn = 0.0f, mx = -1.0f;
    if (i < n) {
      ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
      dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
      mn = tmin[i];
      mx = tmax[i];
    }
    s_ray[lane][0] = make_float4(ox, oy, oz, mn);
    s_ray[lane][1] = make_float4(dx, dy, dz, mx);
    s_ray[lane][2] = make_float4(safe_inv(dx), safe_inv(dy), safe_inv(dz),
                                 0.0f);
  }
  __syncwarp();
}

// Bit r set where ray r has some t with tmin < t < tmax.
__device__ __forceinline__ unsigned live_rays(const float4 (*s_ray)[3]) {
  unsigned live = 0;
#pragma unroll
  for (int r = 0; r < kPacket; ++r)
    if (s_ray[r][1].w > s_ray[r][0].w) live |= 1u << r;
  return live;
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

// Word w of the packet's mask: lane b tests union subchunk w * 32 + b.
// Adds the slab tests this lane ran to *n_slabs.
__device__ __forceinline__ unsigned packet_word(
    const float4 (*s_ray)[3], const int* __restrict__ cb, int n_cand,
    int n_sub, const float* __restrict__ sub_box, int n_sub_total, int w,
    int lane, int* n_slabs) {
  const int s = w * 32 + lane;
  const int j = s / n_sub;
  bool pass = false;
  if (j < n_cand) {  // ranks < count are listed candidates (tnear < BIG)
    const int sid = cb[j] * n_sub + (s - j * n_sub);
    const float bn[3] = {sub_box[sid], sub_box[n_sub_total + sid],
                         sub_box[2 * n_sub_total + sid]};
    const float bx[3] = {sub_box[3 * n_sub_total + sid],
                         sub_box[4 * n_sub_total + sid],
                         sub_box[5 * n_sub_total + sid]};
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

// Triangle e of the subchunk starting at q (walk layout: rows of `chunk`).
__device__ __forceinline__ Tri load_tri(const float* __restrict__ q,
                                        int chunk, int e) {
  Tri t;
  t.v0x = q[e]; t.v0y = q[chunk + e]; t.v0z = q[2 * chunk + e];
  t.e1x = q[3 * chunk + e]; t.e1y = q[4 * chunk + e];
  t.e1z = q[5 * chunk + e];
  t.e2x = q[6 * chunk + e]; t.e2y = q[7 * chunk + e];
  t.e2z = q[8 * chunk + e];
  return t;
}

// _mt_packet for one (ray, triangle) pair, same operation order.
// Returns tmin < t <= bound && t < tmax inside the triangle, and t.
__device__ __forceinline__ bool mt(const float4 (*ray)[3], int r,
                                   const Tri& tr, float bound,
                                   float* t_out) {
  const float4 a = ray[r][0];
  const float4 b = ray[r][1];
  const float ox = a.x, oy = a.y, oz = a.z, dx = b.x, dy = b.y, dz = b.z;
  const float pvx = dy * tr.e2z - dz * tr.e2y;
  const float pvy = dz * tr.e2x - dx * tr.e2z;
  const float pvz = dx * tr.e2y - dy * tr.e2x;
  const float det = tr.e1x * pvx + tr.e1y * pvy + tr.e1z * pvz;
  const bool ok = fabsf(det) > kEpsDet;
  const float inv_det = ok ? 1.0f / det : 0.0f;
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

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

// Lane 0 adds the warp's per-lane counts to the ray block's totals.
__device__ __forceinline__ void add_counts(int blk, int lane, int n_swept,
                                           int n_tests, int n_slabs,
                                           int* swept, int* tests,
                                           int* slabs) {
  n_tests = __reduce_add_sync(kFullMask, n_tests);
  n_slabs = __reduce_add_sync(kFullMask, n_slabs);
  if (lane == 0) {
    atomicAdd(swept + blk, n_swept);
    atomicAdd(tests + blk, n_tests);
    atomicAdd(slabs + blk, n_slabs);
  }
}

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
  int* words;  // [n_packets, maxc_pad * n_sub / 32] or null
  int* swept;
  int* tests;
  int* slabs;
};

__global__ void __launch_bounds__(kWarps * 32)
packet_closest_kernel(const Query q, int n_packets, float* __restrict__ out_t,
                      int* __restrict__ out_id) {
  __shared__ float4 s_rays[kWarps][kPacket][3];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + warp;
  if (p >= n_packets) return;  // the whole warp; no block barrier follows
  const int blk = p * kPacket / q.block_rays;
  float4 (*s_ray)[3] = s_rays[warp];
  stage_rays(s_ray, q.o, q.d, q.tmin, q.tmax, q.n, p, lane);
  const unsigned live = live_rays(s_ray);

  const int n_cand = q.count[blk];
  const int* cb = q.cand + static_cast<size_t>(blk) * q.maxc_pad;
  const float* tb = q.tnear + static_cast<size_t>(blk) * q.maxc_pad;
  const int n_sub = q.chunk / kSub;
  const int n_sub_total = q.n_chunks * n_sub;
  const int words_row = q.maxc_pad * n_sub / 32;
  const int n_words = (n_cand * n_sub + 31) / 32;

  float bt[kPacket];
  int bi[kPacket];
  float limit = __int_as_float(0xff800000);  // max of min(best t, tmax)
#pragma unroll
  for (int r = 0; r < kPacket; ++r) {
    bt[r] = kBig;
    bi[r] = -1;
    if ((live >> r) & 1u) limit = fmaxf(limit, fminf(kBig, s_ray[r][1].w));
  }
  int n_swept = 0, n_tests = 0, n_slabs = 0;
  bool done = live == 0u;
  for (int w = 0; w < n_words; ++w) {
    const unsigned word = packet_word(s_ray, cb, n_cand, n_sub, q.sub_box,
                                      n_sub_total, w, lane, &n_slabs);
    if (q.words != nullptr && lane == 0)
      q.words[static_cast<size_t>(p) * words_row + w] = static_cast<int>(word);
    if (done) continue;  // only when the words are wanted
    for (unsigned bits = word; bits; bits &= bits - 1) {
      const int s = w * 32 + __ffs(bits) - 1;
      const int j = s / n_sub;
      const int c = cb[j];
      const int base = (s - j * n_sub) * kSub;
      const float* tq = q.tris + static_cast<size_t>(c) * 16 * q.chunk + base;
#pragma unroll
      for (int m = 0; m < kTriPerLane; ++m) {
        const int e = lane + 32 * m;
        const Tri tr = load_tri(tq, q.chunk, e);
        const int cid = c * q.chunk + base + e;
#pragma unroll
        for (int r = 0; r < kPacket; ++r) {
          if (!((live >> r) & 1u)) continue;
          float t;
          // a hit has t <= bt: better if nearer, or as near and lower id
          if (mt(s_ray, r, tr, bt[r], &t) && (t < bt[r] || cid < bi[r])) {
            bt[r] = t;
            bi[r] = cid;
          }
        }
      }
      ++n_swept;
      n_tests += __popc(live) * kTriPerLane;
    }
    if (word) {
      limit = __int_as_float(0xff800000);
#pragma unroll
      for (int r = 0; r < kPacket; ++r)
        if ((live >> r) & 1u)
          limit = fmaxf(limit, fminf(warp_min(bt[r]), s_ray[r][1].w));
    }
    // candidates come sorted by entry distance: once the next word's
    // first candidate starts beyond every live ray's best, stop
    const int j_next = min(((w + 1) * 32) / n_sub, q.maxc_pad - 1);
    if (tb[j_next] > limit) {
      done = true;
      if (q.words == nullptr) break;
    }
  }
#pragma unroll
  for (int r = 0; r < kPacket; ++r) {
    const float m = warp_min(bt[r]);
    int sel = __reduce_min_sync(kFullMask, bt[r] == m ? bi[r] : INT_MAX);
    if (!(m < kBig)) sel = -1;
    const int i = p * kPacket + r;
    if (lane == r && i < q.n) {
      out_t[i] = m;
      out_id[i] = sel;
    }
  }
  add_counts(blk, lane, n_swept, n_tests, n_slabs, q.swept, q.tests,
             q.slabs);
}

__global__ void __launch_bounds__(kWarps * 32)
packet_any_kernel(const Query q, int n_packets,
                  int* __restrict__ out_blocked) {
  __shared__ float4 s_rays[kWarps][kPacket][3];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + warp;
  if (p >= n_packets) return;
  const int blk = p * kPacket / q.block_rays;
  float4 (*s_ray)[3] = s_rays[warp];
  stage_rays(s_ray, q.o, q.d, q.tmin, q.tmax, q.n, p, lane);
  const unsigned live = live_rays(s_ray);

  const int n_cand = q.count[blk];
  const int* cb = q.cand + static_cast<size_t>(blk) * q.maxc_pad;
  const int n_sub = q.chunk / kSub;
  const int n_sub_total = q.n_chunks * n_sub;
  const int words_row = q.maxc_pad * n_sub / 32;
  const int n_words = (n_cand * n_sub + 31) / 32;

  unsigned blocked = 0;
  int n_swept = 0, n_tests = 0, n_slabs = 0;
  bool done = live == 0u;
  for (int w = 0; w < n_words; ++w) {
    const unsigned word = packet_word(s_ray, cb, n_cand, n_sub, q.sub_box,
                                      n_sub_total, w, lane, &n_slabs);
    if (q.words != nullptr && lane == 0)
      q.words[static_cast<size_t>(p) * words_row + w] = static_cast<int>(word);
    if (done) continue;
    for (unsigned bits = word; bits && !done; bits &= bits - 1) {
      const int s = w * 32 + __ffs(bits) - 1;
      const int j = s / n_sub;
      const int c = cb[j];
      const int base = (s - j * n_sub) * kSub;
      const float* tq = q.tris + static_cast<size_t>(c) * 16 * q.chunk + base;
      const unsigned open = live & ~blocked;
      unsigned hit = 0;
#pragma unroll
      for (int m = 0; m < kTriPerLane; ++m) {
        const Tri tr = load_tri(tq, q.chunk, lane + 32 * m);
#pragma unroll
        for (int r = 0; r < kPacket; ++r) {
          if (!((open >> r) & 1u) || ((hit >> r) & 1u)) continue;
          float t;
          if (mt(s_ray, r, tr, kBig, &t)) hit |= 1u << r;
          ++n_tests;
        }
      }
      blocked |= __reduce_or_sync(kFullMask, hit);
      ++n_swept;
      done = (blocked & live) == live;
    }
    if (done && q.words == nullptr) break;
  }
  const int i = p * kPacket + lane;
  if (lane < kPacket && i < q.n) out_blocked[i] = (blocked >> lane) & 1u;
  add_counts(blk, lane, n_swept, n_tests, n_slabs, q.swept, q.tests,
             q.slabs);
}

Query make_query(const float* o, const float* d, const float* tmin,
                 const float* tmax, int n_rays, int block_rays,
                 const int* cand, const float* tnear, const int* count,
                 int maxc_pad, const float* sub_box, int n_chunks,
                 const float* tris, int chunk, int* words, int* swept,
                 int* tests, int* slabs) {
  return Query{o, d, tmin, tmax, n_rays, block_rays, cand, tnear, count,
               maxc_pad, sub_box, n_chunks, tris, chunk, words, swept,
               tests, slabs};
}

int packets_of(int n_rays, int block_rays) {
  return (n_rays + block_rays - 1) / block_rays * (block_rays / kPacket);
}

}  // namespace

extern "C" {

// Both entry points launch on `stream`, do not synchronise, and return
// cudaGetLastError() (0 on success). o, d: [n, 3]; tmin, tmax: [n];
// cand, tnear: [n_blocks, maxc_pad]; count, swept, tests, slabs:
// [n_blocks] (zeroed by the caller), n_blocks = ceil(n / block_rays),
// block_rays a multiple of 8; sub_box: [6, n_chunks * chunk / 128];
// tris: [n_chunks, 16, chunk], chunk a multiple of 128; words: null or
// [n_blocks * block_rays / 8, maxc_pad * chunk / 128 / 32] (zeroed by the
// caller). All float32 / int32 and contiguous.
int packet_closest(const float* o, const float* d, const float* tmin,
                   const float* tmax, int n_rays, int block_rays,
                   const int* cand, const float* tnear, const int* count,
                   int maxc_pad, const float* sub_box, int n_chunks,
                   const float* tris, int chunk, float* out_t, int* out_id,
                   int* words, int* swept, int* tests, int* slabs,
                   void* stream) {
  const int n_packets = packets_of(n_rays, block_rays);
  if (n_packets == 0) return 0;
  packet_closest_kernel<<<(n_packets + kWarps - 1) / kWarps, kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      make_query(o, d, tmin, tmax, n_rays, block_rays, cand, tnear, count,
                 maxc_pad, sub_box, n_chunks, tris, chunk, words, swept,
                 tests, slabs),
      n_packets, out_t, out_id);
  return static_cast<int>(cudaGetLastError());
}

int packet_any(const float* o, const float* d, const float* tmin,
               const float* tmax, int n_rays, int block_rays, const int* cand,
               const float* tnear, const int* count, int maxc_pad,
               const float* sub_box, int n_chunks, const float* tris,
               int chunk, int* out_blocked, int* words, int* swept,
               int* tests, int* slabs, void* stream) {
  const int n_packets = packets_of(n_rays, block_rays);
  if (n_packets == 0) return 0;
  packet_any_kernel<<<(n_packets + kWarps - 1) / kWarps, kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      make_query(o, d, tmin, tmax, n_rays, block_rays, cand, tnear, count,
                 maxc_pad, sub_box, n_chunks, tris, chunk, words, swept,
                 tests, slabs),
      n_packets, out_blocked);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
