// The per-bounce shading (S1) for NVIDIA Hopper (sm_90a): everything the
// staged and NEE executors' bounce body does after the intersection, one
// launch a bounce.
//
// Replaces no Pallas kernel: the JAX package's bounce body
// (render/integrator.py::_bounce_update) is jnp code that XLA fuses. Its
// plain version here, ops/bsdf.py::shade_plain, launches one torch kernel
// per operation: ~170 a bounce (the five-way BSDF evaluated on every ray and
// blended by masks). Here each bounce is one launch, one thread a ray, held
// to the plain version bit for bit.
//
// Per ray, in the plain version's order:
// - the live masks: live_hit = alive & valid, live_miss = alive & ~valid;
// - rad += live_miss ? thr * background : 0 (the background is black, so
//   thr * 0, which keeps a non-finite throughput's NaN);
// - rad += emit ? thr * emission : 0, emit = live_hit & ~prev_nee (NEE's
//   suppression; live_hit where no flags are given);
// - NEE only: rad += live_hit ? thr * contrib : 0 with the throughput from
//   before the update, and prev_nee_out = live_hit & did;
// - a live hit scatters by its material (bsdf.scatter: Lambertian, Metal,
//   Dielectric with the critical angle and the full-ior Schlick quirk,
//   Parameterized with the biased branch, Isotropic; any other type takes
//   the Lambertian lobe, as `pick` leaves it), then the dot term
//   |dir . n| clamped to [0, 1] (1 at a zero normal) and
//   thr *= (dot * inv_pdf) * att, o = point, d = dir; any other ray keeps
//   its o, d and thr.
// A ray evaluates its own material's branch alone: the plain version
// evaluates all five and picks one by masks, so the picked values are the
// same operations on the same inputs.
//
// Bound: bytes. Every ray reads its alive and valid flags, thr and rad
// (26 B) and writes rad, o, d, thr and live_hit (49 B); a live hit reads its
// point, normal, material type, albedo, d, ball and branch uniform (68 B),
// what its material needs of roughness, metallic, ior and front face, and
// its emission where it counts (12 B); any other ray reads o and d (24 B).
// NEE adds a live hit's flag in (1 B) where the flags are given, every ray's
// flag out (1 B) and a live hit's contrib and did (13 B): ~180 B a ray,
// ~0.22 ms at 4,194,304 rays and 3.35 TB/s.
//
// Arithmetic: built with -fmad=false, so each float multiply and add rounds
// on its own, as in the plain version's separate torch kernels; divides and
// square roots are correctly rounded (no fast math). torch's CUDA division by
// a Python scalar is a multiply by the float32 reciprocal, so albedo / pi is
// albedo * (1 / (float)pi); 1.0 / ior is torch's reciprocal (times 1); and
// torch.clamp passes NaN through.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
// models/materials.py's material types
constexpr int kLambertian = 0, kMetal = 1, kDielectric = 2, kParameterized = 3, kIsotropic = 4;
constexpr float kPi = (float)3.14159265358979;   // ops/bsdf.py::PI
constexpr float kInvPi = 1.0f / kPi;             // what albedo / PI multiplies by on the card
constexpr float kTwoPi = (float)6.283185307179586;  // sampling.hemisphere_inv_pdf()

// Pointers of a launch (ops/kernels/shade.py::POINTERS, in this order);
// prev_nee may be null (no suppression); contrib, did and prev_out are read
// and written by the NEE instantiation alone.
struct Ptrs {
  const bool *alive, *valid;
  const float *point, *normal;
  const bool* ff;
  const int* mtype;
  const float *albedo, *emission, *roughness, *metallic, *ior;
  const float *o, *d, *thr, *rad, *ball, *u_choice;
  const bool* prev_nee;
  const float* contrib;
  const bool* did;
  float *o_out, *d_out, *thr_out, *rad_out;
  bool *live_hit, *prev_out;
};

__device__ __forceinline__ void load3(const float* __restrict__ a, int i, float* v) {
  v[0] = a[3 * i];
  v[1] = a[3 * i + 1];
  v[2] = a[3 * i + 2];
}

__device__ __forceinline__ void store3(float* __restrict__ a, int i, const float* v) {
  a[3 * i] = v[0];
  a[3 * i + 1] = v[1];
  a[3 * i + 2] = v[2];
}

// vecmath.dot: (a0 b0 + a1 b1) + a2 b2
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// torch.clamp(x, max=hi) and clamp(x, min=lo) on the card: NaN passes through.
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// vecmath.reflect: v - (2 (v . n)) n
__device__ __forceinline__ void reflect(const float* v, const float* n, float* r) {
  const float s = 2.0f * dot3(v, n);
  for (int k = 0; k < 3; ++k) r[k] = v[k] - s * n[k];
}

// sampling.hemisphere_vec: the ball vector folded into the half-ball about n
__device__ __forceinline__ void hemisphere(const float* b, const float* n, float* h) {
  const float s = dot3(b, n);
  for (int k = 0; k < 3; ++k) h[k] = s < 0.0f ? b[k] - (2.0f * s) * n[k] : b[k];
}

// vecmath.fresnel: Schlick of the full index ir, pow5 as x ((x x) (x x))
__device__ __forceinline__ float fresnel(const float* v, const float* n, float ir) {
  float r0 = (ir - 1.0f) / (ir + 1.0f);
  r0 = r0 * r0;
  const float x = 1.0f - fabsf(dot3(v, n));
  const float x2 = x * x;
  return r0 + (1.0f - r0) * (x * (x2 * x2));
}

// kNee: add the NEE term and write the suppression flags of the next vertex.
template <bool kNee>
__global__ void __launch_bounds__(kThreads) shade_kernel(const Ptrs p, const int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const bool alive = p.alive[i], valid = p.valid[i];
  const bool live_hit = alive && valid, live_miss = alive && !valid;
  float thr[3], rad[3];
  load3(p.thr, i, thr);
  load3(p.rad, i, rad);

  // the miss term: background (black) times throughput (tracing.rs:306)
  for (int k = 0; k < 3; ++k) rad[k] = rad[k] + (live_miss ? thr[k] * 0.0f : 0.0f);
  // the emission term (tracing.rs:307), suppressed after a NEE sample
  const bool emit = live_hit && !(p.prev_nee != nullptr && p.prev_nee[i]);
  float e[3] = {0.0f, 0.0f, 0.0f};
  if (emit) load3(p.emission, i, e);
  for (int k = 0; k < 3; ++k) rad[k] = rad[k] + (emit ? thr[k] * e[k] : 0.0f);
  if (kNee) {
    float c[3] = {0.0f, 0.0f, 0.0f};
    if (live_hit) load3(p.contrib, i, c);
    for (int k = 0; k < 3; ++k) rad[k] = rad[k] + (live_hit ? thr[k] * c[k] : 0.0f);
    p.prev_out[i] = live_hit && p.did[i];
  }
  store3(p.rad_out, i, rad);
  p.live_hit[i] = live_hit;

  if (!live_hit) {  // dead or missed: the path keeps its state
    float v[3];
    load3(p.o, i, v);
    store3(p.o_out, i, v);
    load3(p.d, i, v);
    store3(p.d_out, i, v);
    store3(p.thr_out, i, thr);
    return;
  }

  // the scatter (bsdf.scatter, materials.rs:33-166)
  float nrm[3], din[3], b[3], alb[3], dir[3], att[3], ipdf = 1.0f;
  load3(p.normal, i, nrm);
  load3(p.d, i, din);
  load3(p.ball, i, b);
  load3(p.albedo, i, alb);
  const float uc = p.u_choice[i];
  const int mt = p.mtype[i];
  if (mt == kIsotropic) {
    for (int k = 0; k < 3; ++k) dir[k] = b[k], att[k] = alb[k];
  } else if (mt == kDielectric) {
    const float ior = p.ior[i];
    const float eta = p.ff[i] ? 1.0f / ior : ior;
    const float nd[3] = {-din[0], -din[1], -din[2]};
    const float cin = clamp_max(dot3(nd, nrm), 1.0f);
    const bool critical = eta * sqrtf(clamp_min(1.0f - cin * cin, 0.0f)) > 1.0f;
    if (!critical && uc >= fresnel(din, nrm, ior)) {  // refract (vecmath.refract)
      float perp[3];
      for (int k = 0; k < 3; ++k) perp[k] = eta * (din[k] + cin * nrm[k]);
      const float par = -sqrtf(fabsf(1.0f - dot3(perp, perp)));
      for (int k = 0; k < 3; ++k) dir[k] = perp[k] + par * nrm[k];
    } else {
      reflect(din, nrm, dir);
    }
    for (int k = 0; k < 3; ++k) att[k] = 1.0f;
  } else if (mt == kParameterized) {
    const float rough = p.roughness[i], metal = p.metallic[i];
    const float k_s = fresnel(din, nrm, 1.5f) * (1.0f - rough);
    const float k_d = (1.0f - k_s) * (1.0f - metal);
    if (uc < k_d) {  // the diffuse lobe
      hemisphere(b, nrm, dir);
      for (int k = 0; k < 3; ++k) att[k] = alb[k] * kInvPi;
      ipdf = kTwoPi;
    } else {  // the metal lobe, attenuated by lerp(1, albedo, metallic)
      reflect(din, nrm, dir);
      for (int k = 0; k < 3; ++k) {
        dir[k] = dir[k] + rough * b[k];
        att[k] = (1.0f - metal) * 1.0f + metal * alb[k];
      }
    }
  } else if (mt == kMetal) {
    const float rough = p.roughness[i];
    reflect(din, nrm, dir);
    for (int k = 0; k < 3; ++k) dir[k] = dir[k] + rough * b[k], att[k] = alb[k];
  } else {  // Lambertian, and any other type
    hemisphere(b, nrm, dir);
    for (int k = 0; k < 3; ++k) att[k] = alb[k] * kInvPi;
    ipdf = kTwoPi;
  }

  // the dot term (tracing.rs:313) and the path's update
  float dot_term = 1.0f;
  if (dot3(nrm, nrm) > 0.0f) {
    const float x = fabsf(dot3(dir, nrm));
    dot_term = isnan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);
  }
  const float s = dot_term * ipdf;
  for (int k = 0; k < 3; ++k) thr[k] = thr[k] * (s * att[k]);
  float pt[3];
  load3(p.point, i, pt);
  store3(p.o_out, i, pt);
  store3(p.d_out, i, dir);
  store3(p.thr_out, i, thr);
}

typedef void (*Kernel)(const Ptrs, const int);

// instantiation 0 the path's, 1 NEE's (kNee)
const Kernel kKernels[2] = {shade_kernel<false>, shade_kernel<true>};

}  // namespace

extern "C" {

// One launch of instantiation `nee` over n rays on `stream`; returns
// cudaGetLastError() after it (0 on success). Nothing is launched for 0 rays.
int rt_shade_launch(const void* const* ptrs, int n, int nee, void* stream) {
  Ptrs p;
  memcpy(&p, ptrs, sizeof p);
  if (n <= 0) return 0;
  if (nee < 0 || nee > 1) return (int)cudaErrorInvalidValue;
  const int grid = (int)(((long long)n + kThreads - 1) / kThreads);
  kKernels[nee]<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p, n);
  return (int)cudaGetLastError();
}

// Registers per thread and local (spill) bytes of instantiation `nee`.
int rt_shade_attrs(int nee, int* num_regs, int* local_bytes) {
  if (nee < 0 || nee > 1) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kKernels[nee]);
  if (e != cudaSuccess) return (int)e;
  *num_regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

// The layout and constants the wrapper checks its own against: the pointers
// a launch takes and the five material types.
int rt_shade_constants(int* n_ptrs, int* lambertian, int* metal, int* dielectric,
                       int* parameterized, int* isotropic) {
  *n_ptrs = (int)(sizeof(Ptrs) / sizeof(void*));
  *lambertian = kLambertian;
  *metal = kMetal;
  *dielectric = kDielectric;
  *parameterized = kParameterized;
  *isotropic = kIsotropic;
  return 0;
}

}  // extern "C"
