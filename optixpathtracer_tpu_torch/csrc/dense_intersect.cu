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
// Design. One thread per ray, 128 rays per block. Triangles come as nine
// [T_pad] planes (T_pad a multiple of 128) and chunk boxes as six [C]
// planes. The block walks the chunks in ascending id order. Each ray
// slab-tests the chunk's box; if no ray of the block passes
// (__syncthreads_or) the chunk is skipped, otherwise its 128 triangles
// (4.6 KB) are staged once in shared memory as three float4 per triangle,
// and every warp with at least one passing ray (__any_sync) runs the 128
// tests. The running (t, id), or the blocked flag, stays in registers.
// As in the TPU kernel the cull is per group (block, then warp), so a ray
// is tested against a chunk that any ray of its warp may hit; the cull is
// conservative up to rounding at the box faces, like the TPU kernel's.
//
// What bounds it on the H100: FP32 issue, not memory. A ray reads 44 bytes
// and writes 8; a chunk is 4.6 KB from L2 per block, while one pass over a
// staged chunk is 128 x ~40 separately rounded FP32 operations per ray, fed
// by 3 broadcast 16-byte shared loads per triangle. The design spends that
// budget only where the cull lets a warp through: whole chunks are skipped
// per block, whole warps per chunk, and the occlusion sweep stops once
// every ray of the block is blocked. Each kernel writes, per block, the
// chunks it staged and swept and the ray-triangle tests its threads ran,
// from which the bound is computed.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;  // triangles per chunk == culling cluster
constexpr int kBlock = 128;  // rays per block, one thread per ray
static_assert(kChunk == kBlock, "staging assumes one triangle per thread");
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

// _cluster_test for one ray: can it hit chunk c's box before `limit`?
__device__ __forceinline__ bool slab(const Ray& r,
                                     const float* __restrict__ boxes,
                                     int n_chunks, int c, float limit) {
  const float tx0 = (boxes[c] - r.ox) * r.ix;
  const float ty0 = (boxes[n_chunks + c] - r.oy) * r.iy;
  const float tz0 = (boxes[2 * n_chunks + c] - r.oz) * r.iz;
  const float tx1 = (boxes[3 * n_chunks + c] - r.ox) * r.ix;
  const float ty1 = (boxes[4 * n_chunks + c] - r.oy) * r.iy;
  const float tz1 = (boxes[5 * n_chunks + c] - r.oz) * r.iz;
  const float t_near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                             fminf(tz0, tz1));
  const float t_far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                            fmaxf(tz0, tz1));
  return t_near <= t_far && t_far >= r.tmin && t_near <= limit;
}

// Stage chunk c into shared memory: triangle k as three float4
// (v0x v0y v0z e1x | e1y e1z e2x e2y | e2z - - -).
__device__ __forceinline__ void stage_chunk(float4 (*s_tri)[3],
                                            const float* __restrict__ tris,
                                            int t_pad, int c) {
  const int k = threadIdx.x;
  const float* p = tris + c * kChunk + k;
  s_tri[k][0] = make_float4(p[0], p[t_pad], p[2 * t_pad], p[3 * t_pad]);
  s_tri[k][1] = make_float4(p[4 * t_pad], p[5 * t_pad], p[6 * t_pad],
                            p[7 * t_pad]);
  s_tri[k][2] = make_float4(p[8 * t_pad], 0.0f, 0.0f, 0.0f);
}

// _mt_scalar_tri for one (ray, triangle) pair, same operation order.
// Returns hit (tmin < t < limit inside the triangle) and t.
__device__ __forceinline__ bool mt(const Ray& r, const float4 (*s_tri)[3],
                                   int k, float limit, float* t_out) {
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
         t < limit;
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

__global__ void __launch_bounds__(kBlock)
dense_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ tmin,
                     const float* __restrict__ tmax, int n,
                     const float* __restrict__ tris,
                     const float* __restrict__ boxes, int n_chunks,
                     float* __restrict__ out_t, int* __restrict__ out_id,
                     int* __restrict__ swept, int* __restrict__ tests) {
  __shared__ float4 s_tri[kChunk][3];
  __shared__ int s_sum;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const Ray r = load_ray(o, d, tmin, tmax, n, i);
  const bool live = r.tmax > r.tmin;  // else no t can satisfy tmin<t<tmax
  const int t_pad = n_chunks * kChunk;
  float bt = kBig;
  int bi = -1;
  int n_swept = 0;
  int n_tests = 0;
  for (int c = 0; c < n_chunks; ++c) {
    const bool can = live && slab(r, boxes, n_chunks, c, fminf(bt, r.tmax));
    if (!__syncthreads_or(can)) continue;
    ++n_swept;
    stage_chunk(s_tri, tris, t_pad, c);
    __syncthreads();
    if (__any_sync(kFullMask, can)) {
      for (int k = 0; k < kChunk; ++k) {
        float t;
        if (mt(r, s_tri, k, fminf(bt, r.tmax), &t) && t < bt) {
          bt = t;
          bi = c * kChunk + k;
        }
      }
      n_tests += kChunk;
    }
    __syncthreads();  // the next chunk overwrites s_tri
  }
  if (i < n) {
    out_t[i] = bt;
    out_id[i] = bi;
  }
  if (threadIdx.x == 0) swept[blockIdx.x] = n_swept;
  block_sum_to(n_tests, &s_sum, tests + blockIdx.x);
}

__global__ void __launch_bounds__(kBlock)
dense_any_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ tmin,
                 const float* __restrict__ tmax, int n,
                 const float* __restrict__ tris,
                 const float* __restrict__ boxes, int n_chunks,
                 int* __restrict__ out_blocked, int* __restrict__ swept,
                 int* __restrict__ tests) {
  __shared__ float4 s_tri[kChunk][3];
  __shared__ int s_sum;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const Ray r = load_ray(o, d, tmin, tmax, n, i);
  const bool live = r.tmax > r.tmin;
  const int t_pad = n_chunks * kChunk;
  bool blocked = false;
  int n_swept = 0;
  int n_tests = 0;
  for (int c = 0; c < n_chunks; ++c) {
    const bool open = live && !blocked;
    const bool can = open && slab(r, boxes, n_chunks, c, r.tmax);
    if (!__syncthreads_or(can)) {
      if (!__syncthreads_or(open)) break;  // every ray settled
      continue;
    }
    ++n_swept;
    stage_chunk(s_tri, tris, t_pad, c);
    __syncthreads();
    if (__any_sync(kFullMask, can)) {
      for (int k = 0; k < kChunk && !blocked; ++k) {
        float t;
        blocked = mt(r, s_tri, k, r.tmax, &t);
        ++n_tests;
      }
    }
    __syncthreads();
  }
  if (i < n) out_blocked[i] = blocked ? 1 : 0;
  if (threadIdx.x == 0) swept[blockIdx.x] = n_swept;
  block_sum_to(n_tests, &s_sum, tests + blockIdx.x);
}

}  // namespace

extern "C" {

// Both entry points launch on `stream`, do not synchronise, and return
// cudaGetLastError() (0 on success). o, d: [n, 3]; tmin, tmax: [n];
// tris: [9, n_chunks * 128]; boxes: [6, n_chunks]; swept, tests:
// [ceil(n / 128)] chunks swept and ray-triangle tests run per block; all
// float32 / int32, contiguous.
int dense_closest(const float* o, const float* d, const float* tmin,
                  const float* tmax, int n_rays, const float* tris,
                  const float* boxes, int n_chunks, float* out_t,
                  int* out_id, int* swept, int* tests, void* stream) {
  const int grid = (n_rays + kBlock - 1) / kBlock;
  dense_closest_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, n_rays, tris, boxes, n_chunks, out_t, out_id, swept,
      tests);
  return static_cast<int>(cudaGetLastError());
}

int dense_any(const float* o, const float* d, const float* tmin,
              const float* tmax, int n_rays, const float* tris,
              const float* boxes, int n_chunks, int* out_blocked,
              int* swept, int* tests, void* stream) {
  const int grid = (n_rays + kBlock - 1) / kBlock;
  dense_any_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, n_rays, tris, boxes, n_chunks, out_blocked, swept,
      tests);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
