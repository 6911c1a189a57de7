// The BSDF dispatch for Hopper (bsdf/dispatch.py f and sample), each lane
// evaluating only the lobe of its resolved material type:
//   * layered_f_kernel: the layered glossy-diffuse lobe's value, the mean of
//     n_samples random walks through the coat-over-Lambert layer;
//   * lobes_f_kernel: the closed-form lobes' value (diffuse, conductor,
//     dielectric);
//   * lobes_sample_kernel: a sample of any of the four lobes (one random
//     walk for the layered one).
//
// Replaces no TPU kernel. The JAX package evaluates the lobes
// (optixpathtracer_tpu/bsdf/) as plain jnp ops that XLA fuses, every active
// lobe on every lane, then selects each lane's own. The port's plain
// version (bsdf/dispatch.py f_plain, sample_plain) runs them as eager
// PyTorch launches, each a full pass of the wavefront through device
// memory: some 27,000 (layered f) and 15,000 (layered sample) a call, and
// a few hundred for each closed-form lobe. These kernels keep every lane's
// and walk's state in registers, and a lane computes its own lobe only.
//
// The contract is the plain version's, bit for bit, on every output and
// every lane:
//   * f: rgb [n, 3] (the caller's seed is handed back unchanged by the
//     wrapper); sample: the advanced seed, color, direction, pdf and the
//     valid / reflection / transmission / specular / glossy flags. A lane
//     whose type is not among the lobes asked for reads zero (f) or the
//     invalid sample (sample), as the plain dispatch leaves it.
//   * The diffuse and conductor lobes are one-sided and made two-sided by
//     mirroring wo and wi through the tangent plane where wo.z < 0 (and the
//     sampled direction back); the dielectric takes the true orientation and
//     its value and sample color are tinted by albedo; the layered lobe
//     flips itself.
//   * Every product and sum in the plain version's order, each separately
//     rounded (the build's --fmad=false); '/' and sqrtf are correctly
//     rounded as built, as PyTorch's are; exp, cos and sin are taken in
//     float64 and rounded once to float32, as core/math.py does; a Python
//     float constant is the float32 PyTorch makes of the double; clamp,
//     amax and comparisons treat NaN as the torch ops do.
//   * The RNG draws are the plain version's lane by lane. In sample, every
//     lobe asked for draws on every lane, in lobe order, a fixed number of
//     times (the wrapper passes the counts, dispatch.SAMPLE_DRAWS): a lane
//     samples its own lobe from the seed at that lobe's offset and steps
//     the seed past the others with the LCG alone. Within a lobe a lane
//     draws its lobe choice and the two uniforms of the rough branch's
//     sample_wm in every dielectric event, smooth or not, the two of
//     sample_wm in a conductor sample, smooth or not, and its two disk
//     uniforms in every Lambert event. A lane computes only the branch it
//     takes (smooth or rough, reflected or transmitted, and nothing of a
//     walk once it has ended), which gives the same values: the plain
//     version computes every branch and selects.
//
// What bounds the layered kernels on the H100 is arithmetic, not bytes. A
// lane of f reads 56 bytes and writes 12; a walk step is a Lambert or
// dielectric event of a few hundred FP32 operations (a normalisation,
// Fresnel, the GGX terms), plus the float64 exp, cos and sin. The
// closed-form lobes are at most a few hundred operations a lane, so bytes
// bound lobes_f (60 a lane) and a sample of them (85). The design:
//   a. f runs one thread per (lane, walk): a block holds 32 neighbouring
//      lanes and min(n_samples, 8) warps, warp w taking walks w, w + 8, ...
//      of all 32 lanes, so a warp holds one walk index of neighbouring
//      lanes (one sphere, one smooth/rough branch). Each walk's value goes
//      to shared memory, and one thread a lane sums the walks in order
//      0..n_samples-1 and adds the coat's entrance term, as the plain
//      version does. The lane's chained float-hash seed is computed once
//      (warp 0) and shared. A lane of another type walks no walk.
//   b. lobes_f and sample run one thread per lane (one walk a lane for a
//      layered sample); sample is instantiated for the closed-form lobes,
//      the layered one, or both, as the scene's lobes need.
//   c. A walk stops when it dies (f) or stops walking (sample).
// Each kernel can count the work it did (FP32 operations, as counted below
// beside each function, and float64 exp / cos / sin calls) into two
// 64-bit counters; the wrappers pass none on the main path.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFWarpsMax = 8;        // walk warps a block of f
constexpr int kFThreads = kFWarpsMax * 32;
constexpr int kSampleThreads = 128;  // lanes a block of sample
constexpr unsigned kFullMask = 0xffffffffu;

// the lobe ids of bsdf/dispatch.py (DIFFUSE is 0)
constexpr int kConductor = 1;
constexpr int kDielectric = 2;
constexpr int kGlossyDiffuse = 3;
constexpr int kLobes = 4;

// Python float constants as PyTorch applies them to float32 tensors: the
// double, rounded once to float32.
constexpr float kPi = static_cast<float>(3.14159265358979323846);
constexpr float kInvPi = static_cast<float>(0.31830988618379067154);
constexpr float kPiOver4 = static_cast<float>(0.78539816339744830961);
constexpr float kPiOver2 = static_cast<float>(1.57079632679489661923);
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265359);
constexpr float kSmoothAlpha = static_cast<float>(1e-3);
constexpr float kMinAlpha = static_cast<float>(1e-4);
constexpr float kMaxTan2 = static_cast<float>(1e6);
constexpr float kMinCos4 = static_cast<float>(1e-16);
constexpr float kMinNz = static_cast<float>(1e-6);
constexpr float kNormEps = static_cast<float>(1e-20);
constexpr float kWhMaxZ = static_cast<float>(0.99999);
constexpr float kTrMinZ = static_cast<float>(1e-8);
constexpr float kPdfMin = static_cast<float>(1e-20);
constexpr float kMaxReflectance = static_cast<float>(0.9999);
constexpr float kKEps = static_cast<float>(1e-12);
constexpr float kRRBeta = 0.25f;
constexpr float kU24 = 1.0f / 16777216.0f;  // exact: 2^-24

// Work done by one thread: FP32 operations (each add, sub, mul, div, sqrt,
// compare, min or max once; abs, negation and selects are free) and
// float64 transcendental calls. Unused (and removed by the compiler) unless
// the kernel counts.
struct Ops {
  uint32_t fp32 = 0;
  uint32_t fp64 = 0;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }

// a.x b.x + a.y b.y + a.z b.z, summed left to right (5 operations)
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// core.math.cross's formula (9 operations)
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

// torch.clamp: NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.amax over three channels: NaN if any is NaN
__device__ __forceinline__ float amax3(const float* v) {
  if (isnan(v[0]) || isnan(v[1]) || isnan(v[2])) return v[0] + v[1] + v[2];
  return fmaxf(fmaxf(v[0], v[1]), v[2]);
}

__device__ __forceinline__ float safe_sqrt(float x) {  // 2
  return x > 0.0f ? sqrtf(x) : 0.0f;
}

// core.math.normalize, eps 1e-20 (11)
__device__ __forceinline__ V3 normalize(V3 v, Ops& ops) {
  ops.fp32 += 11;
  const float len2 = dot(v, v);
  const bool ok = len2 > kNormEps;
  const float inv = ok ? 1.0f / sqrtf(len2) : 0.0f;
  return {v.x * inv, v.y * inv, v.z * inv};
}

// cos and sin of a float32 angle in float64, each rounded once
__device__ __forceinline__ void cos_sin(float theta, float& c, float& s,
                                        Ops& ops) {
  ops.fp64 += 2;
  const double t = static_cast<double>(theta);
  c = static_cast<float>(cos(t));
  s = static_cast<float>(sin(t));
}

// ---------------------------------------------------------------------------
// RNG (core/rng.py), on 32-bit words
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t tea16(uint32_t v0, uint32_t v1) {
  uint32_t s0 = 0;
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    s0 += 0x9E3779B9u;
    v0 += ((v1 << 4) + 0xA341316Cu) ^ (v1 + s0) ^ ((v1 >> 5) + 0xC8013EA4u);
    v1 += ((v0 << 4) + 0xAD90777Du) ^ (v0 + s0) ^ ((v0 >> 5) + 0x7E95761Eu);
  }
  return v0;
}

__device__ __forceinline__ void lcg(uint32_t& seed) {
  seed = 1664525u * seed + 1013904223u;
}

__device__ __forceinline__ float rnd(uint32_t& seed, Ops& ops) {
  ops.fp32 += 1;
  lcg(seed);
  return static_cast<float>(seed & 0x00FFFFFFu) * kU24;
}

// float_hash_seed's key: 1000 x truncated to int32 (saturating, NaN -> 0,
// as PyTorch's cast on CUDA), taken modulo 2^32
__device__ __forceinline__ uint32_t hash_key(float x) {
  return static_cast<uint32_t>(static_cast<int>(x * 1000.0f));
}

// (px, py) on the concentric disk (rng.sample_uniform_disk_concentric; 16)
__device__ __forceinline__ void disk_concentric(uint32_t& seed, float& px,
                                                float& py, Ops& ops) {
  ops.fp32 += 14;
  const float u0 = rnd(seed, ops);
  const float u1 = rnd(seed, ops);
  const float ux = 2.0f * u0 - 1.0f;
  const float uy = 2.0f * u1 - 1.0f;
  const bool degenerate = ux == 0.0f && uy == 0.0f;
  const bool use_x = fabsf(ux) > fabsf(uy);
  const float r = use_x ? ux : uy;
  const float safe_ux = ux == 0.0f ? 1.0f : ux;
  const float safe_uy = uy == 0.0f ? 1.0f : uy;
  const float theta = use_x ? kPiOver4 * (uy / safe_ux)
                            : kPiOver2 - kPiOver4 * (ux / safe_uy);
  float c, s;
  cos_sin(theta, c, s, ops);
  px = degenerate ? 0.0f : r * c;
  py = degenerate ? 0.0f : r * s;
}

// ---------------------------------------------------------------------------
// Spherical geometry and the GGX microfacet distribution (core/math.py,
// core/microfacet.py), isotropic
// ---------------------------------------------------------------------------

__device__ __forceinline__ float tan2_theta(V3 w) {  // 5
  const float c2 = w.z * w.z;
  const float s2 = clamp_min(1.0f - c2, 0.0f);
  return c2 > 0.0f ? s2 / c2 : __int_as_float(0x7f800000);
}

// (cos phi, sin phi) of w (15)
__device__ __forceinline__ void cos_sin_phi(V3 w, float& cp, float& sp) {
  const float st = safe_sqrt(clamp_min(1.0f - w.z * w.z, 0.0f));
  cp = st == 0.0f ? 1.0f
                  : clamp(st != 0.0f ? w.x / st : 0.0f, -1.0f, 1.0f);
  sp = st == 0.0f ? 0.0f
                  : clamp(st != 0.0f ? w.y / st : 0.0f, -1.0f, 1.0f);
}

// D(wm) (d_anisotropic with ax = ay = alpha; 40)
__device__ __forceinline__ float ggx_d(V3 wm, float alpha, Ops& ops) {
  ops.fp32 += 40;
  const float a0 = clamp_min(alpha, kMinAlpha);
  const float t2 = tan2_theta(wm);
  const bool t2_ok = isfinite(t2);
  const float t2s = clamp_max(t2_ok ? t2 : 0.0f, kMaxTan2);
  const float c2 = wm.z * wm.z;
  const float cos4 = c2 * c2;
  float cp, sp;
  cos_sin_phi(wm, cp, sp);
  const float cpa = cp / a0;
  const float spa = sp / a0;
  const float e = t2s * (cpa * cpa + spa * spa);
  const float ope = 1.0f + e;
  const float denom = kPi * a0 * a0 * cos4 * (ope * ope);
  const bool ok = t2_ok && cos4 >= kMinCos4 && isfinite(e);
  return ok ? 1.0f / denom : 0.0f;
}

// Smith Lambda(w) (lambda_anisotropic with ax = ay = alpha; 31)
__device__ __forceinline__ float smith_lambda(V3 w, float alpha, Ops& ops) {
  ops.fp32 += 31;
  const float t2 = tan2_theta(w);
  float cp, sp;
  cos_sin_phi(w, cp, sp);
  const float ca = cp * alpha;
  const float sa = sp * alpha;
  const float a2 = ca * ca + sa * sa;
  const bool ok = isfinite(t2);
  const float val = (sqrtf(1.0f + a2 * (ok ? t2 : 0.0f)) - 1.0f) * 0.5f;
  return ok ? val : 0.0f;
}

// smith_g from the two Lambdas: 1 / (1 + L(wo) + L(wi)) (3)
__device__ __forceinline__ float smith_g(float l_o, float l_i, Ops& ops) {
  ops.fp32 += 3;
  return 1.0f / (1.0f + l_o + l_i);
}

// the VNDF pdf D_w(wm) = G1(w) D(wm) |w . wm| / |cos w|, from Lambda(w)
// and D(wm) (11)
__device__ __forceinline__ float vndf_pdf(V3 w, V3 wm, float l_w, float d,
                                          Ops& ops) {
  ops.fp32 += 11;
  const float ct = fabsf(w.z);
  const float g1 = 1.0f / (1.0f + l_w);
  return g1 * d * fabsf(dot(w, wm)) / (ct == 0.0f ? 1.0f : ct);
}

// a visible microfacet normal (microfacet.sample_wm: 2 draws; 95)
__device__ __forceinline__ V3 sample_wm(uint32_t& seed, V3 w, float a,
                                        Ops& ops) {
  ops.fp32 += 60;
  V3 wh = normalize(V3{a * w.x, a * w.y, w.z}, ops);
  if (wh.z < 0.0f) wh = neg(wh);
  const V3 t1g = normalize(cross(V3{0.0f, 0.0f, 1.0f}, wh), ops);
  const V3 t1 = wh.z < kWhMaxZ ? t1g : V3{1.0f, 0.0f, 0.0f};
  const V3 t2 = cross(wh, t1);
  // rng.sample_uniform_disk_polar
  const float u0 = rnd(seed, ops);
  const float u1 = rnd(seed, ops);
  const float r = sqrtf(u0);
  float c, s;
  cos_sin(kTwoPi * u1, c, s, ops);
  const float p0 = r * c;
  const float p1 = r * s;
  const float h = sqrtf(clamp_min(1.0f - p0 * p0, 0.0f));
  const float lerp_t = (1.0f + wh.z) * 0.5f;
  const float py = (1.0f - lerp_t) * h + lerp_t * p1;
  const float pz = sqrtf(clamp_min(1.0f - (p0 * p0 + py * py), 0.0f));
  const V3 nh = {p0 * t1.x + py * t2.x + pz * wh.x,
                 p0 * t1.y + py * t2.y + pz * wh.y,
                 p0 * t1.z + py * t2.z + pz * wh.z};
  return normalize(V3{a * nh.x, a * nh.y, clamp_min(nh.z, kMinNz)}, ops);
}

// ---------------------------------------------------------------------------
// Fresnel and refraction (core/fresnel.py)
// ---------------------------------------------------------------------------

// real dielectric Fresnel with orientation flip and TIR -> 1 (29)
__device__ __forceinline__ float fresnel_dielectric(float cos_i, float ior,
                                                    Ops& ops) {
  ops.fp32 += 29;
  float ci = clamp(cos_i, -1.0f, 1.0f);
  const float eta = ci < 0.0f ? 1.0f / ior : ior;
  ci = fabsf(ci);
  const float sin2_i = 1.0f - ci * ci;
  const float sin2_t = sin2_i / (eta * eta);
  const bool tir = sin2_t >= 1.0f;
  const float ct = safe_sqrt(1.0f - clamp_max(sin2_t, 1.0f));
  const float den_parl = eta * ci + ct;
  const float den_perp = ci + eta * ct;
  const float r_parl =
      (eta * ci - ct) / (den_parl == 0.0f ? 1.0f : den_parl);
  const float r_perp =
      (ci - eta * ct) / (den_perp == 0.0f ? 1.0f : den_perp);
  const float fr = 0.5f * (r_parl * r_parl + r_perp * r_perp);
  return tir ? 1.0f : fr;
}

// Snell refraction of wi about n with orientation flip: false on total
// internal reflection, where wt = 0 (28)
__device__ __forceinline__ bool refract(V3 wi, V3 n, float eta, float& etap,
                                        V3& wt, Ops& ops) {
  ops.fp32 += 28;
  float ci = dot(n, wi);
  const bool flip = ci < 0.0f;
  const float eta_eff = flip ? 1.0f / eta : eta;
  ci = fabsf(ci);
  const V3 n_eff = flip ? neg(n) : n;
  const float sin2_i = clamp_min(1.0f - ci * ci, 0.0f);
  const float sin2_t = sin2_i / (eta_eff * eta_eff);
  const bool valid = sin2_t < 1.0f;
  const float ct = safe_sqrt(1.0f - clamp_max(sin2_t, 1.0f));
  const float k = ci / eta_eff - ct;
  etap = eta_eff;
  wt = valid ? V3{-wi.x / eta_eff + k * n_eff.x, -wi.y / eta_eff + k * n_eff.y,
                  -wi.z / eta_eff + k * n_eff.z}
             : V3{0.0f, 0.0f, 0.0f};
  return valid;
}

// Complex arithmetic on (re, im) pairs in core/fresnel.py's order: a / b
// (12) and the principal square root (12)
__device__ __forceinline__ void c_div(float ar, float ai, float br, float bi,
                                      float& re, float& im) {
  const float scale = 1.0f / (br * br + bi * bi);
  re = (ar * br + ai * bi) * scale;
  im = (ai * br - ar * bi) * scale;
}

__device__ __forceinline__ void c_sqrt(float ar, float ai, float& re,
                                       float& im) {
  const float n = sqrtf(ar * ar + ai * ai);
  const float t1 = sqrtf(0.5f * (n + fabsf(ar)));
  const float t2 = 0.5f * ai / (t1 == 0.0f ? 1.0f : t1);
  re = ar >= 0.0f ? t1 : fabsf(t2);
  im = ar >= 0.0f ? t2 : (ai >= 0.0f ? t1 : -t1);
}

// Exact Fresnel reflectance for the complex IOR er - i ei (fresnel
// fr_complex; 81)
__device__ __forceinline__ float fr_complex(float cos_i, float er, float ei,
                                            Ops& ops) {
  ops.fp32 += 81;
  const float ci = clamp(cos_i, 0.0f, 1.0f);
  const float sin2_i = 1.0f - ci * ci;
  const float e2r = er * er - ei * ei;
  const float e2i = er * ei + ei * er;
  float s2t_r, s2t_i;
  c_div(sin2_i, 0.0f, e2r, e2i, s2t_r, s2t_i);
  float ct_r, ct_i;
  c_sqrt(1.0f - s2t_r, -s2t_i, ct_r, ct_i);
  const float eci_r = er * ci;
  const float eci_i = ei * ci;
  float parl_r, parl_i;
  c_div(eci_r - ct_r, eci_i - ct_i, eci_r + ct_r, eci_i + ct_i, parl_r,
        parl_i);
  const float ect_r = er * ct_r - ei * ct_i;
  const float ect_i = er * ct_i + ei * ct_r;
  float perp_r, perp_i;
  c_div(ci - ect_r, -ect_i, ci + ect_r, ect_i, perp_r, perp_i);
  return 0.5f * ((parl_r * parl_r + parl_i * parl_i) +
                 (perp_r * perp_r + perp_i * perp_i));
}

// One channel of the conductor Fresnel from its reflectance color: eta 1,
// k = 2 sqrt(r) / sqrt(1 - r), r clamped to [0, 0.9999] (fresnel
// fresnel_conductor; 92)
__device__ __forceinline__ float fresnel_conductor(float cos_i,
                                                   float reflectance,
                                                   Ops& ops) {
  ops.fp32 += 11;
  const float r = clamp(reflectance, 0.0f, kMaxReflectance);
  const float k = 2.0f * safe_sqrt(r) /
                  safe_sqrt(clamp_min(1.0f - r, 0.0f) + kKEps);
  return fr_complex(cos_i, 1.0f, k, ops);
}

// ---------------------------------------------------------------------------
// The dielectric coat (bsdf/dielectric.py) and the Lambert base
// (bsdf/diffuse.py)
// ---------------------------------------------------------------------------

// A dielectric sample; its color is splat3 of `color`, reflection is
// !transmission and glossy is !specular.
struct DSample {
  V3 dir;
  float color;
  float pdf;
  bool valid;
  bool transmission;
  bool specular;
};

__device__ __forceinline__ bool sample_ok(const DSample& s) {  // bsdf _ok
  return s.valid && s.color != 0.0f && s.pdf != 0.0f && s.dir.z != 0.0f;
}

// dielectric.sample: one uniform for the lobe choice, then the two of
// sample_wm on every lane
template <bool kRadiance, bool kRefl, bool kTrans>
__device__ __forceinline__ DSample dielectric_sample(uint32_t& seed,
                                                     float alpha, V3 wo,
                                                     float eta, Ops& ops) {
  DSample s;
  const bool smooth = alpha < kSmoothAlpha || eta == 1.0f;
  const float uc = rnd(seed, ops);
  ops.fp32 += 2;
  if (smooth) {
    lcg(seed);  // the rough branch's two draws
    lcg(seed);
    ops.fp32 += 5;
    const float r = fresnel_dielectric(wo.z, eta, ops);
    const float t = 1.0f - r;
    const float pr = kRefl ? r : 0.0f;
    const float pt = kTrans ? t : 0.0f;
    const float psum = pr + pt;
    const bool any = psum > 0.0f;
    const float psafe = any ? psum : 1.0f;
    if (uc < pr / psafe) {
      ops.fp32 += 3;
      s.dir = V3{-wo.x, -wo.y, wo.z};
      const float ct = fabsf(s.dir.z);
      s.color = r / (ct == 0.0f ? 1.0f : ct);
      s.pdf = pr / psafe;
      s.valid = any;
      s.transmission = false;
    } else {
      ops.fp32 += 3 + (kRadiance ? 2 : 0);
      float etap;
      V3 wt;
      const bool vt = refract(wo, V3{0.0f, 0.0f, 1.0f}, eta, etap, wt, ops);
      const float ct = fabsf(wt.z);
      float ft = t / (ct == 0.0f ? 1.0f : ct);
      if (kRadiance) ft = ft / (etap * etap);
      s.dir = wt;
      s.color = ft;
      s.pdf = pt / psafe;
      s.valid = any && vt;
      s.transmission = true;
    }
    s.specular = true;
    return s;
  }
  const V3 wm = sample_wm(seed, wo, alpha, ops);
  const float dwo = dot(wo, wm);
  const float r = fresnel_dielectric(dwo, eta, ops);
  const float t = 1.0f - r;
  const float pr = kRefl ? r : 0.0f;
  const float pt = kTrans ? t : 0.0f;
  const float psum = pr + pt;
  const bool any = psum > 0.0f;
  const float psafe = any ? psum : 1.0f;
  const float d_val = ggx_d(wm, alpha, ops);
  const float l_o = smith_lambda(wo, alpha, ops);
  const float vndf = vndf_pdf(wo, wm, l_o, d_val, ops);
  ops.fp32 += 10;
  if (uc < pr / psafe) {
    ops.fp32 += 21;
    const float k = 2.0f * dwo;
    const V3 wi = {-wo.x + k * wm.x, -wo.y + k * wm.y, -wo.z + k * wm.z};
    const float awm = fabsf(dwo);
    s.pdf = vndf / (awm == 0.0f ? 1.0f : 4.0f * awm) * pr / psafe;
    const float den = 4.0f * wi.z * wo.z;
    s.color = d_val * smith_g(l_o, smith_lambda(wi, alpha, ops), ops) * r /
              (den == 0.0f ? 1.0f : den);
    s.dir = wi;
    s.valid = any && wo.z * wi.z > 0.0f && awm != 0.0f;
    s.transmission = false;
  } else {
    ops.fp32 += 24 + (kRadiance ? 2 : 0);
    float etap;
    V3 wi;
    const bool vt = refract(wo, wm, eta, etap, wi, ops);
    const float dwi = dot(wi, wm);
    const float g = dwi + dwo / etap;
    const float denom_gt = g * g;
    const float dwm_dwi =
        fabsf(dwi) / (denom_gt == 0.0f ? 1.0f : denom_gt);
    s.pdf = vndf * dwm_dwi * pt / psafe;
    const float denom_ft = wi.z * wo.z * denom_gt;
    float ft = t * d_val * smith_g(l_o, smith_lambda(wi, alpha, ops), ops) *
               fabsf(dwi * dwo / (denom_ft == 0.0f ? 1.0f : denom_ft));
    if (kRadiance) ft = ft / (etap * etap);
    s.color = ft;
    s.dir = wi;
    s.valid = any && vt && !(wo.z * wi.z > 0.0f) && wi.z != 0.0f;
    s.transmission = true;
  }
  s.specular = false;
  return s;
}

// The generalized half vector of (wo, wi) (dielectric
// _generalized_half_vector)
struct HalfVector {
  V3 wm;
  float etap;
  bool is_reflect;
  bool valid;
};

__device__ __forceinline__ HalfVector half_vector(V3 wo, V3 wi, float eta,
                                                  Ops& ops) {
  ops.fp32 += 33;
  HalfVector h;
  const float ct_o = wo.z;
  const float ct_i = wi.z;
  h.is_reflect = ct_i * ct_o > 0.0f;
  h.etap = h.is_reflect ? 1.0f : (ct_o > 0.0f ? eta : 1.0f / eta);
  const V3 raw = {wi.x * h.etap + wo.x, wi.y * h.etap + wo.y,
                  wi.z * h.etap + wo.z};
  const bool degenerate =
      ct_i == 0.0f || ct_o == 0.0f || dot(raw, raw) == 0.0f;
  V3 wm = normalize(raw, ops);
  if (wm.z < 0.0f) wm = neg(wm);
  const bool backfacing =
      dot(wm, wi) * ct_i < 0.0f || dot(wm, wo) * ct_o < 0.0f;
  h.wm = wm;
  h.valid = !degenerate && !backfacing;
  return h;
}

// dielectric.f in radiance mode (one channel of its splat3), and, when
// pdf_t is given and f is not 0, dielectric.pdf with reflection off and
// transmission on, for the same (wo, wi): the two share the half vector,
// Fresnel, D and Lambda(wo).
__device__ __forceinline__ float dielectric_f(float alpha, V3 wo, V3 wi,
                                              float eta, float* pdf_t,
                                              Ops& ops) {
  if (alpha < kSmoothAlpha || eta == 1.0f) return 0.0f;
  const HalfVector h = half_vector(wo, wi, eta, ops);
  const float ct_o = wo.z;
  const float ct_i = wi.z;
  const float dwo = dot(wo, h.wm);
  const float dwi = dot(wi, h.wm);
  const float g = dwi + dwo / h.etap;
  const float denom_t = g * g * ct_i * ct_o;
  ops.fp32 += 20;
  if (!h.valid || denom_t == 0.0f) return 0.0f;
  const float fr = fresnel_dielectric(dwo, eta, ops);
  const float d_val = ggx_d(h.wm, alpha, ops);
  const float l_o = smith_lambda(wo, alpha, ops);
  const float g_val = smith_g(l_o, smith_lambda(wi, alpha, ops), ops);
  float val;
  if (h.is_reflect) {
    ops.fp32 += 6;
    const float denom_r = fabsf(4.0f * ct_i * ct_o);
    val = d_val * g_val * fr / (denom_r == 0.0f ? 1.0f : denom_r);
  } else {
    ops.fp32 += 8;
    val = d_val * (1.0f - fr) * g_val * fabsf(dwi * dwo / denom_t);
    val = val / (h.etap * h.etap);
  }
  if (pdf_t != nullptr && val != 0.0f) {
    ops.fp32 += 10;
    const float t = 1.0f - fr;
    const float pr = 0.0f;
    const float pt = t;
    const float psum = pr + pt;
    const bool any = psum > 0.0f;
    const float psafe = any ? psum : 1.0f;
    const float vndf = vndf_pdf(wo, h.wm, l_o, d_val, ops);
    float p;
    if (h.is_reflect) {
      const float awm = fabsf(dwo);
      p = vndf / (awm == 0.0f ? 1.0f : 4.0f * awm) * pr / psafe;
    } else {
      const float denom = g * g;
      const float dwm_dwi = fabsf(dwi) / (denom == 0.0f ? 1.0f : denom);
      p = vndf * dwm_dwi * pt / psafe;
    }
    *pdf_t = any ? p : 0.0f;
  }
  return val;
}

// A cosine-weighted Lambert direction (diffuse.sample; the color is
// albedo / pi and valid is pdf > 0)
struct LSample {
  V3 dir;
  float pdf;
};

__device__ __forceinline__ LSample lambert_sample(uint32_t& seed, Ops& ops) {
  ops.fp32 += 7;
  float px, py;
  disk_concentric(seed, px, py, ops);
  const float z = sqrtf(clamp_min(1.0f - px * px - py * py, 0.0f));
  LSample s;
  s.dir = V3{px, py, fabsf(z)};
  s.pdf = fabsf(s.dir.z) * kInvPi;
  return s;
}

// exp(-|dz / w.z|) in float64, rounded once; 1 for a thin layer, 0 below
// |w.z| = 1e-8 (glossy_diffuse.transmittance; neg_dz = -|dz|; 2)
__device__ __forceinline__ float transmittance(float neg_dz, bool thin,
                                               V3 w, Ops& ops) {
  if (thin) return 1.0f;
  ops.fp32 += 2;
  ops.fp64 += 1;
  const float wz = fabsf(w.z);
  const bool ok = wz > kTrMinZ;
  const float tr =
      static_cast<float>(exp(static_cast<double>(neg_dz / (ok ? wz : 1.0f))));
  return ok ? tr : 0.0f;
}

// balance-squared MIS weight (5)
__device__ __forceinline__ float power_heuristic(float f_pdf, float g_pdf,
                                                 Ops& ops) {
  ops.fp32 += 5;
  const float f2 = f_pdf * f_pdf;
  const float g2 = g_pdf * g_pdf;
  const float denom = f2 + g2;
  return denom > 0.0f ? f2 / denom : 0.0f;
}

struct Lane {
  V3 wo, wi;
  float alb[3];
  float alpha, eta;
  uint32_t seed;
};

// ---------------------------------------------------------------------------
// f: one estimator walk (glossy_diffuse.f_plain, one slice of its leading
// axis); adds the walk's value to wf
// ---------------------------------------------------------------------------

__device__ __forceinline__ void walk_f(const Lane& L, uint32_t k,
                                       uint32_t rr_base, int max_depth,
                                       float neg_dz, bool thin, float* wf,
                                       Ops& ops) {
  uint32_t seed = tea16(L.seed, k);
  uint32_t seed_rr = tea16(rr_base, k + 0x9E37u);
  // the entrance transmission (wos) and the virtual light's (wis)
  const DSample wos =
      dielectric_sample<true, false, true>(seed, L.alpha, L.wo, L.eta, ops);
  const DSample wis =
      dielectric_sample<false, false, true>(seed, L.alpha, L.wi, L.eta, ops);
  if (!(sample_ok(wos) && sample_ok(wis))) return;
  const bool exit_specular = L.alpha < kSmoothAlpha;
  ops.fp32 += 16;
  const float b0 = wos.color * fabsf(wos.dir.z) /
                   (wos.pdf == 0.0f ? 1.0f : wos.pdf);
  float beta[3] = {b0, b0, b0};
  V3 w = wos.dir;
  const float wis_pdf = wis.pdf;
  const float wis_weight =
      fabsf(wis.dir.z) * transmittance(neg_dz, thin, wis.dir, ops) *
      wis.color / (wis.pdf == 0.0f ? 1.0f : wis.pdf);
  const V3 wis_down = neg(wis.dir);

  for (int depth = 0; depth < max_depth; ++depth) {
    if (depth > 3) {  // Russian roulette
      ops.fp32 += 6;
      const float beta_max = amax3(beta);
      const bool rr_on = beta_max < kRRBeta;
      const float q = clamp_min(1.0f - beta_max, 0.0f);
      const float u_rr = rnd(seed_rr, ops);
      if (rr_on && u_rr < q) return;
      if (rr_on) {
        ops.fp32 += 6;
        const float boost = 1.0f / (q < 1.0f ? 1.0f - q : 1.0f);
        beta[0] = beta[0] * boost;
        beta[1] = beta[1] * boost;
        beta[2] = beta[2] * boost;
      }
    }
    const float tr = transmittance(neg_dz, thin, w, ops);
    beta[0] = beta[0] * tr;
    beta[1] = beta[1] * tr;
    beta[2] = beta[2] * tr;
    ops.fp32 += 3;

    if ((depth & 1) == 0) {
      // bottom (Lambert): NEE toward the presampled wis direction
      const V3 w_down = neg(w);
      const bool same = w_down.z * wis_down.z > 0.0f;
      const float pdf_d = same ? fabsf(wis_down.z) * kInvPi : 0.0f;
      const float ph_w = power_heuristic(wis_pdf, pdf_d, ops);
      const float wt1 = exit_specular ? 1.0f : ph_w;
      ops.fp32 += 18;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float f_d = same ? L.alb[c] * kInvPi : 0.0f;
        wf[c] = wf[c] + beta[c] * f_d * wt1 * wis_weight;
      }
      // sample the base, then NEE through the exit coat along it
      const LSample bs = lambert_sample(seed, ops);
      float color[3];
      bool color_nz = false;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        color[c] = L.alb[c] * kInvPi;
        color_nz = color_nz || color[c] != 0.0f;
      }
      const bool bs_ok = bs.pdf > 0.0f && color_nz && bs.pdf != 0.0f &&
                         bs.dir.z != 0.0f;
      const float cos_b = fabsf(bs.dir.z);
      const float pdf_safe = bs.pdf == 0.0f ? 1.0f : bs.pdf;
      ops.fp32 += 19;
      float new_beta[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        new_beta[c] = beta[c] * color[c] * cos_b / pdf_safe;
      if (bs_ok && !exit_specular) {
        float exit_pdf = 0.0f;
        const float f_exit =
            dielectric_f(L.alpha, neg(bs.dir), L.wi, L.eta, &exit_pdf, ops);
        if (f_exit != 0.0f) {
          const float wt2 = power_heuristic(bs.pdf, exit_pdf, ops);
          const float tr_b = transmittance(neg_dz, thin, bs.dir, ops);
          ops.fp32 += 12;
#pragma unroll
          for (int c = 0; c < 3; ++c)
            wf[c] = wf[c] + new_beta[c] * tr_b * f_exit * wt2;
        }
      }
      if (!bs_ok) return;
      beta[0] = new_beta[0];
      beta[1] = new_beta[1];
      beta[2] = new_beta[2];
      w = bs.dir;
    } else {
      // top (dielectric): reflection back down
      const DSample bs = dielectric_sample<true, true, false>(
          seed, L.alpha, neg(w), L.eta, ops);
      if (!sample_ok(bs)) return;
      ops.fp32 += 14;
      const float cos_b = fabsf(bs.dir.z);
      const float pdf_safe = bs.pdf == 0.0f ? 1.0f : bs.pdf;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        beta[c] = beta[c] * bs.color * cos_b / pdf_safe;
      w = bs.dir;
    }
  }
}

__device__ __forceinline__ Lane load_lane(const int64_t* __restrict__ seed,
                                          const float* __restrict__ albedo,
                                          const float* __restrict__ rough,
                                          const float* __restrict__ wo,
                                          const float* __restrict__ eta,
                                          int i) {
  Lane L;
  L.seed = static_cast<uint32_t>(seed[i]);
  L.alb[0] = albedo[3 * i];
  L.alb[1] = albedo[3 * i + 1];
  L.alb[2] = albedo[3 * i + 2];
  const float r = rough[i];
  L.alpha = r * r;
  L.eta = eta[i];
  L.wo = V3{wo[3 * i], wo[3 * i + 1], wo[3 * i + 2]};
  return L;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullMask, v, o);
  return v;
}

// Adds the block's work to ops_out[0] (FP32 operations) and ops_out[1]
// (float64 calls). Every thread of the block calls it.
__device__ __forceinline__ void report(const Ops& ops,
                                       unsigned long long* ops_out) {
  const unsigned long long a = warp_sum<unsigned long long>(ops.fp32);
  const unsigned long long b = warp_sum<unsigned long long>(ops.fp64);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(ops_out, a);
    atomicAdd(ops_out + 1, b);
  }
}

// One block: 32 lanes x blockDim.y walk warps. Shared memory: the walks'
// values [n_samples][32][3], then the lanes' float-hash seeds [32]. With
// `type`, a lane of another type walks nothing and is written zero where
// `others`, else left to lobes_f_kernel.
template <bool kCount>
__global__ void __launch_bounds__(kFThreads)
    layered_f_kernel(const int64_t* __restrict__ seed,
                     const int* __restrict__ type,
                     const float* __restrict__ albedo,
                     const float* __restrict__ rough,
                     const float* __restrict__ wo,
                     const float* __restrict__ wi, const float* __restrict__ eta,
                     int n, int others, int n_samples, int max_depth,
                     float neg_dz, int thin, float* __restrict__ out,
                     unsigned long long* __restrict__ ops_out) {
  extern __shared__ float smem[];
  float* walk_vals = smem;
  uint32_t* rr_base = reinterpret_cast<uint32_t*>(smem + n_samples * 96);
  const int lane = threadIdx.x;
  const int i = blockIdx.x * 32 + lane;
  const bool live =
      i < n && (type == nullptr || type[i] == kGlossyDiffuse);
  if (i < n && !live && others && threadIdx.y == 0) {
    out[3 * i] = 0.0f;
    out[3 * i + 1] = 0.0f;
    out[3 * i + 2] = 0.0f;
  }
  Ops ops;
  Lane L;
  bool same_hemi = false;
  if (live) {
    L = load_lane(seed, albedo, rough, wo, eta, i);
    L.wi = V3{wi[3 * i], wi[3 * i + 1], wi[3 * i + 2]};
    if (L.wo.z < 0.0f) {  // two-sided
      L.wo = neg(L.wo);
      L.wi = neg(L.wi);
    }
    same_hemi = L.wo.z * L.wi.z > 0.0f;
    if (threadIdx.y == 0) {
      uint32_t s = tea16(hash_key(L.wo.x), hash_key(L.wo.y));
      s = tea16(s, hash_key(L.wi.x));
      s = tea16(s, hash_key(L.wi.y));
      rr_base[lane] = tea16(s, L.seed);
    }
  }
  __syncthreads();
  if (live) {
    for (int k = threadIdx.y; k < n_samples; k += blockDim.y) {
      float wf[3] = {0.0f, 0.0f, 0.0f};
      if (same_hemi)
        walk_f(L, static_cast<uint32_t>(k), rr_base[lane], max_depth, neg_dz,
               thin != 0, wf, ops);
      float* dst = walk_vals + (k * 32 + lane) * 3;
      dst[0] = wf[0];
      dst[1] = wf[1];
      dst[2] = wf[2];
    }
  }
  __syncthreads();
  if (live && threadIdx.y == 0) {
    // the coat's entrance reflection, counted n_samples times, plus the
    // walks summed in order
    const float nf = static_cast<float>(n_samples);
    const float f_coat =
        same_hemi ? nf * dielectric_f(L.alpha, L.wo, L.wi, L.eta, nullptr, ops)
                  : 0.0f;
    ops.fp32 += 2 + 6 + 3 * (n_samples - 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float sum = walk_vals[lane * 3 + c];
      for (int k = 1; k < n_samples; ++k)
        sum = sum + walk_vals[(k * 32 + lane) * 3 + c];
      out[3 * i + c] = (f_coat + sum) / nf;
    }
  }
  if (kCount) report(ops, ops_out);
}

// ---------------------------------------------------------------------------
// The closed-form lobes, as bsdf/dispatch.py calls them
// ---------------------------------------------------------------------------

// One sample's outputs (base.BSDFSample); as constructed, the invalid one
struct Sample {
  float color[3] = {0.0f, 0.0f, 0.0f};
  V3 dir = {0.0f, 0.0f, 0.0f};
  float pdf = 0.0f;
  bool valid = false;
  bool reflection = false;
  bool transmission = false;
  bool specular = false;
  bool glossy = false;
};

// dispatch._mirror_z: the reflection through the tangent plane
__device__ __forceinline__ V3 mirror_z(V3 v) { return {v.x, v.y, -v.z}; }

// diffuse.f: albedo / pi where wo and wi share a hemisphere (5)
__device__ __forceinline__ void diffuse_f(const float* alb, V3 wo, V3 wi,
                                          float* f, Ops& ops) {
  ops.fp32 += 5;
  const bool same = wo.z * wi.z > 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) f[c] = same ? alb[c] * kInvPi : 0.0f;
}

// conductor.f: D F G / (4 cos_i cos_o), 0 for a smooth (delta) surface
// (14, then 163 + 3 x 93)
__device__ __forceinline__ void conductor_f(const float* alb, float alpha,
                                            V3 wo, V3 wi, float* f,
                                            Ops& ops) {
  ops.fp32 += 14;
  const float ct_o = fabsf(wo.z);
  const float ct_i = fabsf(wi.z);
  const V3 raw = {wi.x + wo.x, wi.y + wo.y, wi.z + wo.z};
  const bool degenerate =
      dot(raw, raw) == 0.0f || ct_i == 0.0f || ct_o == 0.0f;
  if (!(wo.z * wi.z > 0.0f) || alpha < kSmoothAlpha || degenerate) {
    f[0] = f[1] = f[2] = 0.0f;
    return;
  }
  ops.fp32 += 10 + 3;
  const V3 wm = normalize(raw, ops);
  const float cos_m = fabsf(dot(wo, wm));
  const float denom = 4.0f * ct_i * ct_o;
  const float scale =
      ggx_d(wm, alpha, ops) *
      smith_g(smith_lambda(wo, alpha, ops), smith_lambda(wi, alpha, ops),
              ops) /
      (denom == 0.0f ? 1.0f : denom);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    f[c] = scale * fresnel_conductor(cos_m, alb[c], ops);
}

// A closed-form lobe's value (t: DIFFUSE, kConductor or kDielectric), as
// dispatch.f_plain computes it for a lane of that type
__device__ __forceinline__ void closed_f(int t, const float* alb,
                                         float alpha, V3 wo, V3 wi,
                                         float eta, float* f, Ops& ops) {
  if (t == kDielectric) {
    ops.fp32 += 3;
    const float v = dielectric_f(alpha, wo, wi, eta, nullptr, ops);
#pragma unroll
    for (int c = 0; c < 3; ++c) f[c] = v * alb[c];
    return;
  }
  const bool flip = wo.z < 0.0f;  // two-sided
  const V3 wo_m = flip ? mirror_z(wo) : wo;
  const V3 wi_m = flip ? mirror_z(wi) : wi;
  if (t == kConductor)
    conductor_f(alb, alpha, wo_m, wi_m, f, ops);
  else
    diffuse_f(alb, wo_m, wi_m, f, ops);
}

// diffuse.sample: a cosine-weighted direction (2 draws; 4)
__device__ __forceinline__ void diffuse_sample(uint32_t seed, const float* alb,
                                               Sample& s, Ops& ops) {
  ops.fp32 += 4;
  const LSample b = lambert_sample(seed, ops);
#pragma unroll
  for (int c = 0; c < 3; ++c) s.color[c] = alb[c] * kInvPi;
  s.dir = b.dir;
  s.pdf = b.pdf;
  s.valid = b.pdf > 0.0f;
  s.reflection = true;
}

// conductor.sample: the mirror when smooth, else a visible microfacet
// normal's reflection (sample_wm's 2 draws; 1, then 2 + 3 x 93 smooth or
// 27 + 3 x 94 rough)
__device__ __forceinline__ void conductor_sample(uint32_t seed,
                                                 const float* alb,
                                                 float alpha, V3 wo,
                                                 Sample& s, Ops& ops) {
  ops.fp32 += 1;
  s.reflection = true;
  if (alpha < kSmoothAlpha) {
    ops.fp32 += 2;
    s.dir = V3{-wo.x, -wo.y, wo.z};
    const float ct = fabsf(s.dir.z);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ops.fp32 += 1;
      s.color[c] =
          fresnel_conductor(ct, alb[c], ops) / (ct == 0.0f ? 1.0f : ct);
    }
    s.pdf = 1.0f;
    s.valid = ct > 0.0f;
    s.specular = true;
    return;
  }
  ops.fp32 += 27;
  const V3 wm = sample_wm(seed, wo, alpha, ops);
  const float dwo = dot(wo, wm);
  const float k = 2.0f * dwo;
  s.dir = V3{-wo.x + k * wm.x, -wo.y + k * wm.y, -wo.z + k * wm.z};
  const float awm = fabsf(dwo);
  const float d = ggx_d(wm, alpha, ops);
  const float l_o = smith_lambda(wo, alpha, ops);
  s.pdf = vndf_pdf(wo, wm, l_o, d, ops) / (awm == 0.0f ? 1.0f : 4.0f * awm);
  const float ct_o = fabsf(wo.z);
  const float ct_i = fabsf(s.dir.z);
  const float denom = 4.0f * ct_i * ct_o;
  const float scale =
      d * smith_g(l_o, smith_lambda(s.dir, alpha, ops), ops) /
      (denom == 0.0f ? 1.0f : denom);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ops.fp32 += 1;
    s.color[c] = scale * fresnel_conductor(awm, alb[c], ops);
  }
  s.valid = wo.z != 0.0f && wo.z * s.dir.z > 0.0f && ct_i != 0.0f &&
            ct_o != 0.0f && awm != 0.0f;
  s.glossy = true;
}

// A closed-form lobe's sample (t: DIFFUSE, kConductor or kDielectric) from
// the seed at that lobe's draws, as dispatch.sample_plain computes it for a
// lane of that type
__device__ __forceinline__ void closed_sample(int t, uint32_t seed,
                                              const float* alb, float alpha,
                                              V3 wo, float eta, Sample& s,
                                              Ops& ops) {
  if (t == kDielectric) {
    ops.fp32 += 3;
    const DSample d =
        dielectric_sample<true, true, true>(seed, alpha, wo, eta, ops);
#pragma unroll
    for (int c = 0; c < 3; ++c) s.color[c] = d.color * alb[c];
    s.dir = d.dir;
    s.pdf = d.pdf;
    s.valid = d.valid;
    s.reflection = !d.transmission;
    s.transmission = d.transmission;
    s.specular = d.specular;
    s.glossy = !d.specular;
    return;
  }
  const bool flip = wo.z < 0.0f;  // two-sided
  if (t == kConductor)
    conductor_sample(seed, alb, alpha, flip ? mirror_z(wo) : wo, s, ops);
  else
    diffuse_sample(seed, alb, s, ops);
  if (flip) s.dir = mirror_z(s.dir);
}

// One thread a lane; a lane of the layered type, where the layered lobe is
// asked for, is layered_f_kernel's, and is left as it is.
template <bool kCount>
__global__ void __launch_bounds__(kSampleThreads)
    lobes_f_kernel(const int* __restrict__ type,
                   const float* __restrict__ albedo,
                   const float* __restrict__ rough,
                   const float* __restrict__ wo, const float* __restrict__ wi,
                   const float* __restrict__ eta, int n, int mask,
                   float* __restrict__ out,
                   unsigned long long* __restrict__ ops_out) {
  const int i = blockIdx.x * kSampleThreads + threadIdx.x;
  Ops ops;
  if (i < n) {
    const int t = type[i];
    const bool on = t >= 0 && t < kLobes && ((mask >> t) & 1);
    if (!(on && t == kGlossyDiffuse)) {
      float f[3] = {0.0f, 0.0f, 0.0f};
      if (on) {
        const float alb[3] = {albedo[3 * i], albedo[3 * i + 1],
                              albedo[3 * i + 2]};
        const float r = rough[i];
        closed_f(t, alb, r * r, V3{wo[3 * i], wo[3 * i + 1], wo[3 * i + 2]},
                 V3{wi[3 * i], wi[3 * i + 1], wi[3 * i + 2]}, eta[i], f, ops);
      }
      out[3 * i] = f[0];
      out[3 * i + 1] = f[1];
      out[3 * i + 2] = f[2];
    }
  }
  if (kCount) report(ops, ops_out);
}

// ---------------------------------------------------------------------------
// sample: one thread a lane, one walk a layered lane
// (glossy_diffuse.sample_plain)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void layered_sample(uint32_t seed, const Lane& L,
                                               int max_depth, float neg_dz,
                                               bool thin, Sample& s,
                                               Ops& ops) {
  const bool flip = L.wo.z < 0.0f;  // two-sided
  const V3 wo_up = flip ? neg(L.wo) : L.wo;

  // entrance event at the coat
  const DSample bs0 =
      dielectric_sample<true, true, true>(seed, L.alpha, wo_up, L.eta, ops);
  const bool bs0_ok = sample_ok(bs0);
  const bool reflected = bs0_ok && !bs0.transmission;

  // transmitted into the layer: the walk
  bool walking = bs0_ok && bs0.transmission;
  V3 w = bs0.dir;
  const float f0 = bs0.color * fabsf(bs0.dir.z);
  float f_val[3] = {f0, f0, f0};
  float pdf_val = bs0.pdf;
  bool specular_path = bs0.specular;
  uint32_t seed_rr =
      tea16(tea16(hash_key(wo_up.x), hash_key(wo_up.y)), seed);
  bool done = false;
  float out_color[3] = {0.0f, 0.0f, 0.0f};
  V3 out_dir = {0.0f, 0.0f, 0.0f};
  float out_pdf = 0.0f;
  bool out_specular = false;

  for (int depth = 0; depth < max_depth; ++depth) {
    if (walking && depth > 3) {  // Russian roulette
      ops.fp32 += 10;
      const bool pdf_ok = pdf_val > kPdfMin;
      const float rr_beta = pdf_ok ? amax3(f_val) / pdf_val : 1.0f;
      const bool rr_on = rr_beta < kRRBeta;
      const float q = clamp_min(1.0f - rr_beta, 0.0f);
      const float u_rr = rnd(seed_rr, ops);
      const bool die = rr_on && u_rr < q;
      if (rr_on && !die) pdf_val = pdf_val * (1.0f - q);
      walking = !die;
    }
    walking = walking && w.z != 0.0f;
    if (!walking) break;
    // advance to the other interface
    const float tr = transmittance(neg_dz, thin, w, ops);
    f_val[0] = f_val[0] * tr;
    f_val[1] = f_val[1] * tr;
    f_val[2] = f_val[2] * tr;
    ops.fp32 += 3;
    V3 bs_dir;
    float bs_color[3], bs_pdf;
    bool bs_ok, bs_transmission, bs_specular;
    if ((depth & 1) == 0) {  // bottom: Lambert reflection
      const LSample bs = lambert_sample(seed, ops);
      bool color_nz = false;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        bs_color[c] = L.alb[c] * kInvPi;
        color_nz = color_nz || bs_color[c] != 0.0f;
      }
      ops.fp32 += 9;
      bs_dir = bs.dir;
      bs_pdf = bs.pdf;
      bs_ok = bs.pdf > 0.0f && color_nz && bs.pdf != 0.0f &&
              bs.dir.z != 0.0f;
      bs_transmission = false;
      bs_specular = false;
    } else {  // top: the coat reflects back down or transmits out
      const DSample bs = dielectric_sample<true, true, true>(
          seed, L.alpha, neg(w), L.eta, ops);
      bs_dir = bs.dir;
      bs_color[0] = bs_color[1] = bs_color[2] = bs.color;
      bs_pdf = bs.pdf;
      bs_ok = sample_ok(bs);
      bs_transmission = bs.transmission;
      bs_specular = bs.specular;
    }
    if (!bs_ok) break;
    ops.fp32 += 4;
    f_val[0] = f_val[0] * bs_color[0];
    f_val[1] = f_val[1] * bs_color[1];
    f_val[2] = f_val[2] * bs_color[2];
    pdf_val = pdf_val * bs_pdf;
    specular_path = specular_path && bs_specular;
    w = bs_dir;
    if (bs_transmission) {  // exit through the top
      out_color[0] = f_val[0];
      out_color[1] = f_val[1];
      out_color[2] = f_val[2];
      out_dir = w;
      out_pdf = pdf_val;
      out_specular = specular_path;
      done = true;
      break;
    }
    // cosine after an in-layer scattering event
    ops.fp32 += 3;
    const float cos_b = fabsf(bs_dir.z);
    f_val[0] = f_val[0] * cos_b;
    f_val[1] = f_val[1] * cos_b;
    f_val[2] = f_val[2] * cos_b;
  }

  V3 dir;
  if (reflected) {
    s.color[0] = s.color[1] = s.color[2] = bs0.color;
    dir = bs0.dir;
    s.pdf = bs0.pdf;
    s.valid = true;
    s.reflection = true;
    s.specular = bs0.specular;
  } else {
    s.color[0] = out_color[0];
    s.color[1] = out_color[1];
    s.color[2] = out_color[2];
    dir = out_dir;
    s.pdf = out_pdf;
    s.valid = done;
    s.reflection = wo_up.z * out_dir.z > 0.0f;
    s.specular = out_specular;
  }
  s.dir = flip ? neg(dir) : dir;
  s.transmission = !s.reflection;
  s.glossy = !s.specular;
}

// lcg steps of each lobe's sample on every lane (0 for a lobe not asked for)
struct Draws {
  int n[kLobes];
};

struct SampleArgs {
  const int64_t* seed;
  const int* type;  // null: every lane is of the layered type
  const float* albedo;
  const float* rough;
  const float* wo;
  const float* eta;
  int n;
  int mask;  // bit t: lobe t is asked for
  Draws draws;
  int max_depth;
  float neg_dz;
  int thin;
  int64_t* seed_out;
  float* color;
  float* dir;
  float* pdf;
  uint8_t* flags;
  unsigned long long* ops;
};

// Instantiated for the closed-form lobes (kClosed), the layered one
// (kLayered) or both, as `mask` asks.
template <bool kCount, bool kClosed, bool kLayered>
__global__ void __launch_bounds__(kSampleThreads)
    lobes_sample_kernel(const SampleArgs a) {
  const int i = blockIdx.x * kSampleThreads + threadIdx.x;
  Ops ops;
  if (i < a.n) {
    const Lane L = load_lane(a.seed, a.albedo, a.rough, a.wo, a.eta, i);
    const int t = a.type == nullptr ? kGlossyDiffuse : a.type[i];
    // every lobe asked for draws on every lane, in lobe order; a lane
    // samples its own from the seed at that lobe's offset
    uint32_t seed = L.seed;
    uint32_t own = seed;
#pragma unroll
    for (int lobe = 0; lobe < kLobes; ++lobe) {
      if (lobe == t) own = seed;
      for (int k = 0; k < a.draws.n[lobe]; ++k) lcg(seed);
    }
    Sample s;
    if (t >= 0 && t < kLobes && ((a.mask >> t) & 1)) {
      if (t == kGlossyDiffuse) {
        if (kLayered)
          layered_sample(own, L, a.max_depth, a.neg_dz, a.thin != 0, s, ops);
      } else if (kClosed) {
        closed_sample(t, own, L.alb, L.alpha, L.wo, L.eta, s, ops);
      }
    }
    const int n = a.n;
    a.seed_out[i] = static_cast<int64_t>(seed);
    a.color[3 * i] = s.color[0];
    a.color[3 * i + 1] = s.color[1];
    a.color[3 * i + 2] = s.color[2];
    a.dir[3 * i] = s.dir.x;
    a.dir[3 * i + 1] = s.dir.y;
    a.dir[3 * i + 2] = s.dir.z;
    a.pdf[i] = s.pdf;
    a.flags[i] = s.valid;
    a.flags[n + i] = s.reflection;
    a.flags[2 * n + i] = s.transmission;
    a.flags[3 * n + i] = s.specular;
    a.flags[4 * n + i] = s.glossy;
  }
  if (kCount) report(ops, a.ops);
}

template <bool kClosed, bool kLayered>
void launch_sample(const SampleArgs& a, cudaStream_t s) {
  const unsigned grid =
      static_cast<unsigned>((a.n + kSampleThreads - 1) / kSampleThreads);
  if (a.ops != nullptr)
    lobes_sample_kernel<true, kClosed, kLayered>
        <<<grid, kSampleThreads, 0, s>>>(a);
  else
    lobes_sample_kernel<false, kClosed, kLayered>
        <<<grid, kSampleThreads, 0, s>>>(a);
}

size_t f_smem(int n_samples) {
  return (static_cast<size_t>(n_samples) * 96 + 32) * sizeof(float);
}

}  // namespace

extern "C" {

// Every entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success). seed: [n] int64 holding u32; type: [n]
// int32 lobe ids (dispatch.py), or null where every lane is of the layered
// type; albedo, wo, wi, rgb, color, dir: [n, 3]; rough, eta, pdf: [n];
// flags: [5, n] bytes (valid, reflection, transmission, specular, glossy).
// mask: bit t set where lobe t is asked for. layered_f takes n_samples <=
// 127 (its walks' values fill 48 KB of shared memory) and writes only the
// layered lanes of rgb, and the others zero where `others`. neg_dz is
// -|thickness| in float32, thin is 1 where |thickness| is at most the
// smallest normal float32 (transmittance 1). ops: null, or two uint64
// counters the kernel adds its FP32 operations and float64 calls to.
int layered_f(const int64_t* seed, const int* type, const float* albedo,
              const float* rough, const float* wo, const float* wi,
              const float* eta, int n, int others, int n_samples,
              int max_depth, float neg_dz, int thin, float* rgb,
              unsigned long long* ops, void* stream) {
  if (n == 0) return 0;
  const size_t smem = f_smem(n_samples);  // up to 48 KB: n_samples <= 127
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32, n_samples < kFWarpsMax ? n_samples : kFWarpsMax);
  const unsigned grid = static_cast<unsigned>((n + 31) / 32);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ops != nullptr)
    layered_f_kernel<true><<<grid, block, smem, s>>>(
        seed, type, albedo, rough, wo, wi, eta, n, others, n_samples,
        max_depth, neg_dz, thin, rgb, ops);
  else
    layered_f_kernel<false><<<grid, block, smem, s>>>(
        seed, type, albedo, rough, wo, wi, eta, n, others, n_samples,
        max_depth, neg_dz, thin, rgb, ops);
  return static_cast<int>(cudaGetLastError());
}

// Writes every lane of rgb but the layered ones where mask asks for the
// layered lobe (layered_f's).
int lobes_f(const int* type, const float* albedo, const float* rough,
            const float* wo, const float* wi, const float* eta, int n,
            int mask, float* rgb, unsigned long long* ops, void* stream) {
  if (n == 0) return 0;
  const unsigned grid =
      static_cast<unsigned>((n + kSampleThreads - 1) / kSampleThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ops != nullptr)
    lobes_f_kernel<true><<<grid, kSampleThreads, 0, s>>>(
        type, albedo, rough, wo, wi, eta, n, mask, rgb, ops);
  else
    lobes_f_kernel<false><<<grid, kSampleThreads, 0, s>>>(
        type, albedo, rough, wo, wi, eta, n, mask, rgb, ops);
  return static_cast<int>(cudaGetLastError());
}

// draws: 4 host ints, the lcg steps of each lobe's sample (0 for a lobe not
// in mask); the advanced seed is the input stepped by their sum.
int lobes_sample(const int64_t* seed, const int* type, const float* albedo,
                 const float* rough, const float* wo, const float* eta, int n,
                 int mask, const int* draws, int max_depth, float neg_dz,
                 int thin, int64_t* seed_out, float* color, float* dir,
                 float* pdf, uint8_t* flags, unsigned long long* ops,
                 void* stream) {
  if (n == 0) return 0;
  SampleArgs a{seed,  type,      albedo, rough,  wo,       eta,
               n,     mask,      {},     max_depth, neg_dz, thin,
               seed_out, color,  dir,    pdf,    flags,    ops};
  for (int lobe = 0; lobe < kLobes; ++lobe) a.draws.n[lobe] = draws[lobe];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool layered = (mask >> kGlossyDiffuse) & 1;
  const bool closed = (mask & ((1 << kGlossyDiffuse) - 1)) != 0;
  if (layered && closed)
    launch_sample<true, true>(a, s);
  else if (layered)
    launch_sample<false, true>(a, s);
  else
    launch_sample<true, false>(a, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
