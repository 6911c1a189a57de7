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
//     of 128, staged 128 triangles at a time).
//   * candidates: entry[b, c] = min over the block's live rays (tmax >= 0)
//     that pass the slab test (t_near <= t_far, t_far >= tmin,
//     t_near <= tmax) of max(t_near, 0); 3.4e38 where none passes and in
//     the padded slots c >= C. min and max are exact, so the result does
//     not depend on the order rays are visited in.
//   * closest: Moller-Trumbore in _mt_smem_tri's operation order, |det| >
//     1e-12, u, v >= 0, u + v <= 1, t > tmin, t <= best t (inclusive), t <
//     tmax (strict); ties (t == best t) go to the lower id c * chunk + k.
//     So the result is the brute oracle's (t, lowest id) in any candidate
//     order. The sweep stops once the next candidate's entry distance
//     exceeds the block's max of min(best t, tmax).
//   * any: blocked = 1 if some candidate triangle has tmin < t < tmax; the
//     block stops once every live ray is blocked.
//   * Built with --fmad=false: every product and sum rounds separately, as
//     in the plain PyTorch versions, so entries are bit-identical and ids
//     break ties the same way.
//
// Design. The TPU candidate kernel flips roles, chunks on the vector lanes
// and rays as a scalar loop. Here the same flip needs no atomics and no
// cross-thread reduction: one CUDA block per ray block copies the block's
// rays into shared memory (32 B a ray: origin, inverse direction, tmin,
// tmax), and each thread owns chunk slots c = tid, tid + 256, ..., keeps
// that chunk's box in registers and runs over the rays, which shared
// memory broadcasts to the warp. The sweeps run one thread per ray, one
// CUDA block per ray block, with the block's candidate row read from
// device memory. A candidate chunk is slab-tested by every ray against
// min(best t, tmax); if no ray of the block passes (__syncthreads_or) the
// chunk is skipped, else it is staged in shared memory (three float4 per
// triangle, 6 KB per 128 triangles) and every warp with a passing ray
// (__any_sync) runs the tests. The early exit needs a block max of floats
// that may be negative (dead rays carry tmax = -1): a warp shuffle max,
// then one over the warps, in floats.
//
// What bounds it on the H100: FP32 throughput. A ray reads 32 bytes and writes
// 8, a staged chunk is 4.6 KB per 128 triangles from L2, while one pass of
// a block over a chunk is block_rays x chunk tests of 54 separately
// rounded FP32 operations each, fed by three broadcast 16-byte shared
// loads per triangle. The design spends that only where a block needs it:
// the sorted candidate list drops chunks no ray of the block can reach,
// the running cull and the early exit drop chunks behind the block's hits,
// and the warp skip drops warps none of whose rays reaches the chunk.
// Every sweep writes, per block, the chunks it swept and the ray-triangle
// tests its threads ran (a thread of a warp that skips a chunk runs none;
// an occlusion thread stops at its first hit), from which the bound is
// computed. The candidate kernel is C x block_rays slab tests (28 FP32
// operations each, with the live test and the running min) per block.

#include <cuda_runtime.h>

namespace {

constexpr int kPiece = 128;        // triangles staged per step
constexpr int kCandThreads = 256;  // chunk slots per candidate pass
constexpr int kMaxBlock = 1024;
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

// _cluster_test_chunk for one ray: can it hit chunk c's box before limit?
__device__ __forceinline__ bool slab(const Ray& r,
                                     const float* __restrict__ boxes,
                                     int n_chunks, int c, float limit) {
  const float tx0 = (boxes[c] - r.ox) * r.ix;
  const float tx1 = (boxes[3 * n_chunks + c] - r.ox) * r.ix;
  const float ty0 = (boxes[n_chunks + c] - r.oy) * r.iy;
  const float ty1 = (boxes[4 * n_chunks + c] - r.oy) * r.iy;
  const float tz0 = (boxes[2 * n_chunks + c] - r.oz) * r.iz;
  const float tz1 = (boxes[5 * n_chunks + c] - r.oz) * r.iz;
  const float t_near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                             fminf(tz0, tz1));
  const float t_far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                            fmaxf(tz0, tz1));
  return t_near <= t_far && t_far >= r.tmin && t_near <= limit;
}

// Stage triangles [p, p + 128) of chunk c: triangle k as three float4
// (v0x v0y v0z e1x | e1y e1z e2x e2y | e2z - - -). Threads 0..127 load.
__device__ __forceinline__ void stage_piece(float4 (*s_tri)[3],
                                            const float* __restrict__ tris,
                                            int chunk, int c, int p) {
  const int k = threadIdx.x;
  if (k < kPiece) {
    const float* q = tris + static_cast<size_t>(c) * 16 * chunk + p + k;
    s_tri[k][0] = make_float4(q[0], q[chunk], q[2 * chunk], q[3 * chunk]);
    s_tri[k][1] = make_float4(q[4 * chunk], q[5 * chunk], q[6 * chunk],
                              q[7 * chunk]);
    s_tri[k][2] = make_float4(q[8 * chunk], 0.0f, 0.0f, 0.0f);
  }
}

// _mt_smem_tri for one (ray, triangle) pair, same operation order.
// Returns tmin < t <= bound && t < tmax inside the triangle, and t.
__device__ __forceinline__ bool mt(const Ray& r, const float4 (*s_tri)[3],
                                   int k, float bound, float* t_out) {
  const float4 a = s_tri[k][0];
  const float4 b = s_tri[k][1];
  const float4 c = s_tri[k][2];
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;

  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool ok = fabsf(det) > kEpsDet;
  const float inv_det = ok ? 1.0f / det : 0.0f;
  const float tvx = r.ox - v0x;
  const float tvy = r.oy - v0y;
  const float tvz = r.oz - v0z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
  const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  *t_out = t;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > r.tmin &&
         t <= bound && t < r.tmax;
}

// Thread 0 writes the sum of v over the block to *out. Every thread calls
// it; s_sum is one int of shared memory.
__device__ __forceinline__ void block_sum_to(int v, int* s_sum, int* out) {
  v = static_cast<int>(__reduce_add_sync(kFullMask, static_cast<unsigned>(v)));
  if (threadIdx.x == 0) *s_sum = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) atomicAdd(s_sum, v);
  __syncthreads();
  if (threadIdx.x == 0) *out = *s_sum;
}

// Max of v over the block, returned to every thread. The leading
// __syncthreads() lets a second call reuse s_red.
__device__ __forceinline__ float block_max(float v, float* s_red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? s_red[lane]
                                                : __int_as_float(0xff800000);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
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

__global__ void __launch_bounds__(kMaxBlock)
walk_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tmin,
                    const float* __restrict__ tmax, int n,
                    const int* __restrict__ cand,
                    const float* __restrict__ tnear,
                    const int* __restrict__ count, int maxc_pad,
                    const float* __restrict__ boxes, int n_chunks,
                    const float* __restrict__ tris, int chunk,
                    float* __restrict__ out_t, int* __restrict__ out_id,
                    int* __restrict__ swept, int* __restrict__ tests) {
  __shared__ float4 s_tri[kPiece][3];
  __shared__ float s_red[32];
  __shared__ int s_sum;
  const int b = blockIdx.x;
  const int i = b * blockDim.x + threadIdx.x;
  const Ray r = load_ray(o, d, tmin, tmax, n, i);
  const bool live = r.tmax > r.tmin;  // else no t has tmin < t < tmax
  const int n_cand = count[b];
  const int* cb = cand + static_cast<size_t>(b) * maxc_pad;
  const float* tb = tnear + static_cast<size_t>(b) * maxc_pad;
  float bt = kBig;
  int bi = -1;
  int n_swept = 0;
  int n_tests = 0;
  for (int j = 0; j < n_cand; ++j) {
    const int c = cb[j];
    const bool can = live && slab(r, boxes, n_chunks, c, fminf(bt, r.tmax));
    if (__syncthreads_or(can)) {
      ++n_swept;
      const bool warp_on = __any_sync(kFullMask, can);
      for (int p = 0; p < chunk; p += kPiece) {
        stage_piece(s_tri, tris, chunk, c, p);
        __syncthreads();
        if (warp_on) {
          for (int k = 0; k < kPiece; ++k) {
            float t;
            const int cid = c * chunk + p + k;
            // a hit has t <= bt: better if nearer, or as near and lower id
            if (mt(r, s_tri, k, bt, &t) && (t < bt || cid < bi)) {
              bt = t;
              bi = cid;
            }
          }
          n_tests += kPiece;
        }
        __syncthreads();  // the next piece overwrites s_tri
      }
    }
    // candidates come sorted by entry distance: once the next starts
    // beyond every ray's best hit, no later chunk can contribute
    if (j + 1 < n_cand && tb[j + 1] > block_max(fminf(bt, r.tmax), s_red))
      break;
  }
  if (i < n) {
    out_t[i] = bt;
    out_id[i] = bi;
  }
  if (threadIdx.x == 0) swept[b] = n_swept;
  block_sum_to(n_tests, &s_sum, tests + b);
}

__global__ void __launch_bounds__(kMaxBlock)
walk_any_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ tmin,
                const float* __restrict__ tmax, int n,
                const int* __restrict__ cand,
                const int* __restrict__ count, int maxc_pad,
                const float* __restrict__ boxes, int n_chunks,
                const float* __restrict__ tris, int chunk,
                int* __restrict__ out_blocked, int* __restrict__ swept,
                int* __restrict__ tests) {
  __shared__ float4 s_tri[kPiece][3];
  __shared__ int s_sum;
  const int b = blockIdx.x;
  const int i = b * blockDim.x + threadIdx.x;
  const Ray r = load_ray(o, d, tmin, tmax, n, i);
  const bool live = r.tmax > r.tmin;
  const int n_cand = count[b];
  const int* cb = cand + static_cast<size_t>(b) * maxc_pad;
  bool blocked = false;
  int n_swept = 0;
  int n_tests = 0;
  for (int j = 0; j < n_cand; ++j) {
    const int c = cb[j];
    const bool open = live && !blocked;
    // skip the chunk when every ray is blocked or misses its box
    const bool can = open && slab(r, boxes, n_chunks, c, r.tmax);
    if (__syncthreads_or(can)) {
      ++n_swept;
      const bool warp_on = __any_sync(kFullMask, can);
      for (int p = 0; p < chunk; p += kPiece) {
        stage_piece(s_tri, tris, chunk, c, p);
        __syncthreads();
        if (warp_on && open) {
          for (int k = 0; k < kPiece && !blocked; ++k) {
            float t;
            blocked = mt(r, s_tri, k, kBig, &t);
            ++n_tests;
          }
        }
        __syncthreads();
      }
    }
    // stop once every live ray is blocked
    if (!__syncthreads_or(live && !blocked)) break;
  }
  if (i < n) out_blocked[i] = blocked ? 1 : 0;
  if (threadIdx.x == 0) swept[b] = n_swept;
  block_sum_to(n_tests, &s_sum, tests + b);
}

int grid_of(int n_rays, int block_rays) {
  return (n_rays + block_rays - 1) / block_rays;
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
  walk_closest_kernel<<<grid_of(n_rays, block_rays), block_rays, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, n_rays, cand, tnear, count, maxc_pad, boxes,
      n_chunks, tris, chunk, out_t, out_id, swept, tests);
  return static_cast<int>(cudaGetLastError());
}

int walk_any(const float* o, const float* d, const float* tmin,
             const float* tmax, int n_rays, int block_rays, const int* cand,
             const int* count, int maxc_pad, const float* boxes,
             int n_chunks, const float* tris, int chunk, int* out_blocked,
             int* swept, int* tests, void* stream) {
  walk_any_kernel<<<grid_of(n_rays, block_rays), block_rays, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, n_rays, cand, count, maxc_pad, boxes, n_chunks, tris,
      chunk, out_blocked, swept, tests);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
