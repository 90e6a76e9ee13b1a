// NEE's light sample (N1) for NVIDIA Hopper (sm_90a): everything the NEE
// executor's bounce does for its direct-light term around the shadow ray, in
// two launches a NEE bounce.
//
// Replaces no Pallas kernel: the JAX package's NEE sample
// (render/nee.py::direct_light) is jnp code that XLA fuses. Its plain
// versions here, render/nee.py::nee_sample_plain and nee_contrib_plain,
// launch one torch kernel per operation: ~134 a NEE bounce (the light pick,
// both light kinds evaluated on every ray and blended by masks, the diffuse
// mask with its Fresnel term, the geometry term, the shadow ray's `where`s).
// Here they are two launches, one thread a ray, held to the plain versions
// bit for bit:
// - nee_sample_kernel (N1a), before the shadow ray: the light pick
//   (uniform over the n_t triangle and n_s sphere lights), the uniform point
//   on the picked light's area and its normal, emission and inverse density;
//   the diffuse mask (Lambertian and Parameterized at a surface vertex, the
//   latter where the shared branch uniform picked its diffuse lobe by the
//   Fresnel weight; Isotropic at a zero-normal vertex); the shadow ray's
//   origin, direction (the unit direction times the ball length u^(1/3)) and
//   window end; the reach test; and the contribution before the visibility
//   mask, f * emission * geo. A ray that does not shoot gets the plain
//   version's empty ray (origin 0, direction 1, window end 0, contribution 0).
// - nee_contrib_kernel (N1b), after it: contrib = valid ? 0 : pending, which
//   is pending where the ray shot and its shadow ray hit nothing (pending is
//   0 where it did not shoot).
// A ray evaluates its own light's branch alone: the plain version evaluates
// both kinds and picks one by masks, so the picked values are the same
// operations on the same inputs. The light counts are the launch's, so a
// scene with one kind of light never reads the other table.
//
// Bound: bytes. N1a: every ray reads its live and valid flags (2 B) and
// writes did, shoot, the shadow origin, direction and window end and the
// pending contribution (42 B); a live hit reads its normal and material type
// (16 B); a Parameterized one its incoming direction, roughness, metallic
// and branch uniform (24 B); a vertex that samples its four draws, point
// and albedo (40 B) and its light's row (52 or 28 B, from L1 or L2 after
// the first). N1b: valid in (1 B), pending where it is not (12 B), contrib
// out (12 B). ~85 + 25 B a ray, ~0.03 ms at 1,048,576 rays and 3.35 TB/s.
//
// Arithmetic: built with -fmad=false, so each float multiply and add rounds
// on its own, as in the plain version's separate torch kernels; divides and
// square roots are correctly rounded (no fast math); rsqrtf, sincosf and
// powf are the CUDA math library's, as torch.rsqrt, torch.sin, torch.cos and
// torch.pow on the card. torch's CUDA division by a Python scalar is a
// multiply by the float32 reciprocal, so albedo / pi is albedo * (1 /
// (float)pi); a Python scalar is rounded to float32 once, after Python
// folded it in double (n_l * 4 pi, 2 pi); torch.clamp passes NaN through.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
// models/materials.py's material types NEE tells apart
constexpr int kLambertian = 0, kParameterized = 3, kIsotropic = 4;
constexpr double kPiD = 3.14159265358979;                  // render/nee.py::PI
constexpr float kInvPi = 1.0f / (float)kPiD;               // albedo / PI on the card
constexpr float kInvFourPi = 1.0f / (float)(4.0 * kPiD);   // albedo / FOUR_PI
constexpr float kTwoPi = (float)(2.0 * kPiD);              // 2.0 * PI * u2
constexpr float kShadowTMax = (float)(1.0 - 1e-3);         // render/nee.py::SHADOW_T_MAX
constexpr float kThird = (float)(1.0 / 3.0);               // u ** (1.0 / 3.0)
// the light tables' row widths (models/scene.py: lt_tri a, e1, e2, emission,
// area; lt_sph center, radius, emission)
constexpr int kTriRow = 13, kSphRow = 7;

// Pointers of a sample launch (ops/kernels/nee.py::POINTERS, in this order).
struct Ptrs {
  const bool *live, *valid;
  const float *point, *normal;
  const int* mtype;
  const float *albedo, *roughness, *metallic, *d_in, *u_choice, *u, *lt_tri, *lt_sph;
  bool *did, *shoot;
  float *sh_o, *sh_dir, *t_max, *pending;
};

// The launch's scalars, as the plain version rounds them.
struct Scalars {
  int n, m, n_t, n_s;
  float n_l;        // (float)n_lights: u_pick * n_l and n_l * area
  float sph_scale;  // (float)(n_lights * 4 pi) in double: a sphere's inverse density over r^2
  float max_dist;   // (float)max_trace_dist
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

// torch.clamp(x, min=lo) on the card: NaN passes through.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// vecmath.fresnel of the index 1.5: Schlick, pow5 as x ((x x) (x x))
__device__ __forceinline__ float fresnel15(const float* v, const float* n) {
  float r0 = (1.5f - 1.0f) / (1.5f + 1.0f);
  r0 = r0 * r0;
  const float x = 1.0f - fabsf(dot3(v, n));
  const float x2 = x * x;
  return r0 + (1.0f - r0) * (x * (x2 * x2));
}

__global__ void __launch_bounds__(kThreads) nee_sample_kernel(const Ptrs p, const Scalars s) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= s.n) return;
  bool did = false, shoot = false;
  float o[3] = {0.0f, 0.0f, 0.0f}, dir[3] = {1.0f, 1.0f, 1.0f}, t_max = 0.0f;
  float pend[3] = {0.0f, 0.0f, 0.0f};

  if (p.live[i] && p.valid[i]) {
    // the diffuse mask (render/nee.py::_diffuse_mask)
    float nrm[3];
    load3(p.normal, i, nrm);
    const bool has_normal = dot3(nrm, nrm) > 0.0f;
    const int mt = p.mtype[i];
    const bool iso = mt == kIsotropic && !has_normal;
    bool applies = iso || (mt == kLambertian && has_normal);
    if (mt == kParameterized && has_normal) {
      float din[3];
      load3(p.d_in, i, din);
      const float k_s = fresnel15(din, nrm) * (1.0f - p.roughness[i]);
      const float k_d = (1.0f - k_s) * (1.0f - p.metallic[i]);
      applies = p.u_choice[i] < k_d;
    }
    did = applies;
    if (applies) {
      // the light sample (render/nee.py::sample_light_point)
      const float* u = p.u + (size_t)s.m * i;
      const float u1 = u[1], u2 = u[2];
      const int pick = min((int)(u[0] * s.n_l), s.n_t + s.n_s - 1);
      float x[3], n_l[3], emi[3], inv_pdf;
      if (pick < s.n_t) {  // uniform over the triangle: a + su (1 - u2) e1 + su u2 e2
        const float* row = p.lt_tri + (size_t)kTriRow * pick;
        float a[3], e1[3], e2[3];
        for (int k = 0; k < 3; ++k) {
          a[k] = __ldg(row + k);
          e1[k] = __ldg(row + 3 + k);
          e2[k] = __ldg(row + 6 + k);
          emi[k] = __ldg(row + 9 + k);
        }
        const float su = sqrtf(clamp_min(u1, 0.0f));
        const float s1 = su * (1.0f - u2), s2 = su * u2;
        for (int k = 0; k < 3; ++k) x[k] = (a[k] + s1 * e1[k]) + s2 * e2[k];
        // vecmath.normalize(vecmath.cross(e1, e2), eps=1e-30)
        const float c[3] = {e1[1] * e2[2] - e1[2] * e2[1], e1[2] * e2[0] - e1[0] * e2[2],
                            e1[0] * e2[1] - e1[1] * e2[0]};
        const float len = sqrtf(dot3(c, c) + (float)1e-30);
        for (int k = 0; k < 3; ++k) n_l[k] = c[k] / len;
        inv_pdf = s.n_l * __ldg(row + 12);
      } else {  // uniform over the sphere
        const float* row = p.lt_sph + (size_t)kSphRow * (pick - s.n_t);
        const float r = __ldg(row + 3);
        const float z = 1.0f - 2.0f * u1;
        const float rr = sqrtf(clamp_min(1.0f - z * z, 0.0f));
        const float phi = kTwoPi * u2;
        // sinf's and cosf's values from one argument reduction, which needs
        // no stack frame where the two calls apart take one
        float sin_phi, cos_phi;
        sincosf(phi, &sin_phi, &cos_phi);
        n_l[0] = rr * cos_phi;
        n_l[1] = rr * sin_phi;
        n_l[2] = z;
        for (int k = 0; k < 3; ++k) {
          x[k] = __ldg(row + k) + r * n_l[k];
          emi[k] = __ldg(row + 4 + k);
        }
        inv_pdf = (s.sph_scale * r) * r;
      }

      // the geometry term and the shadow ray (render/nee.py::nee_sample_plain)
      float pt[3], to_l[3], wl[3];
      load3(p.point, i, pt);
      for (int k = 0; k < 3; ++k) to_l[k] = x[k] - pt[k];
      const float dist2 = dot3(to_l, to_l);
      const float dist2c = clamp_min(dist2, (float)1e-12);
      const float inv_dist = rsqrtf(dist2c);
      const float dist = dist2 * inv_dist;
      for (int k = 0; k < 3; ++k) wl[k] = to_l[k] * inv_dist;
      float cos_x = 1.0f;
      if (has_normal) {  // clipped to [0, 1] like the estimator's dot term
        const float c = dot3(wl, nrm);
        cos_x = isnan(c) ? c : fminf(fmaxf(c, 0.0f), 1.0f);
      }
      const float cos_y = fabsf(dot3(wl, n_l));
      const float r_len = clamp_min(powf(u[3], kThird), (float)1e-6);
      const float t_light = dist / r_len;
      shoot = t_light <= s.max_dist;
      if (shoot) {
        for (int k = 0; k < 3; ++k) o[k] = pt[k], dir[k] = wl[k] * r_len;
        t_max = kShadowTMax * t_light;
        float geo = cos_x * cos_y / dist2c * inv_pdf;
        if (!iso) geo = geo * r_len;  // the ball length weights a surface vertex
        float alb[3];
        load3(p.albedo, i, alb);
        for (int k = 0; k < 3; ++k) {
          const float f = alb[k] * (iso ? kInvFourPi : kInvPi);
          pend[k] = f * emi[k] * geo;
        }
      }
    }
  }
  p.did[i] = did;
  p.shoot[i] = shoot;
  store3(p.sh_o, i, o);
  store3(p.sh_dir, i, dir);
  p.t_max[i] = t_max;
  store3(p.pending, i, pend);
}

__global__ void __launch_bounds__(kThreads)
    nee_contrib_kernel(const bool* __restrict__ valid, const float* __restrict__ pending,
                       float* __restrict__ contrib, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float c[3] = {0.0f, 0.0f, 0.0f};
  if (!valid[i]) load3(pending, i, c);
  store3(contrib, i, c);
}

int grid_of(int n) { return (int)(((long long)n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// One sample launch (N1a) over n rays on `stream`, u (n, m) with m >= 4, n_t
// triangle and n_s sphere lights (n_t + n_s >= 1); returns cudaGetLastError()
// after it (0 on success). Nothing is launched for 0 rays.
int rt_nee_sample_launch(const void* const* ptrs, int n, int m, int n_t, int n_s,
                         float max_dist, void* stream) {
  Ptrs p;
  memcpy(&p, ptrs, sizeof p);
  if (n <= 0) return 0;
  if (m < 4 || n_t < 0 || n_s < 0 || n_t + n_s < 1) return (int)cudaErrorInvalidValue;
  const int n_l = n_t + n_s;
  const Scalars s = {n, m, n_t, n_s, (float)n_l, (float)((double)n_l * (4.0 * kPiD)), max_dist};
  nee_sample_kernel<<<grid_of(n), kThreads, 0, (cudaStream_t)stream>>>(p, s);
  return (int)cudaGetLastError();
}

// One contribution launch (N1b) over n rays on `stream`.
int rt_nee_contrib_launch(const void* valid, const void* pending, void* contrib, int n,
                          void* stream) {
  if (n <= 0) return 0;
  nee_contrib_kernel<<<grid_of(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const bool*)valid, (const float*)pending, (float*)contrib, n);
  return (int)cudaGetLastError();
}

// Registers per thread and local (spill) bytes of entry point `which`: 0 the
// sample (N1a), 1 the contribution (N1b).
int rt_nee_attrs(int which, int* num_regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e;
  if (which == 0) {
    e = cudaFuncGetAttributes(&a, nee_sample_kernel);
  } else if (which == 1) {
    e = cudaFuncGetAttributes(&a, nee_contrib_kernel);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  *num_regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

// The layout and constants the wrapper checks its own against: the pointers
// a sample launch takes, the three material types NEE tells apart and the
// light tables' row widths.
int rt_nee_constants(int* n_ptrs, int* lambertian, int* parameterized, int* isotropic,
                     int* tri_row, int* sph_row) {
  *n_ptrs = (int)(sizeof(Ptrs) / sizeof(void*));
  *lambertian = kLambertian;
  *parameterized = kParameterized;
  *isotropic = kIsotropic;
  *tri_row = kTriRow;
  *sph_row = kSphRow;
  return 0;
}

}  // extern "C"
