// Mega-bounce path-trace kernel (K1) for NVIDIA Hopper (sm_90a).
//
// Replaces cs397raytracingsp22_tpu/ops/pallas/bounce.py::path_trace_pallas
// (the Pallas TPU kernel built by _make_kernel / _build_bounce). It computes
// what render/integrator.py::path_trace computes — the plain version beside
// it is cs397raytracingsp22_tpu_torch/render/integrator.py::path_trace —
// for scenes that pass scene_is_simple: spheres, planes, standalone
// triangles, sphere-bounded volumes and dense meshes with an explicit
// material.
//
// Shape: one thread per ray runs every bounce in a loop. Origin,
// direction, throughput, radiance and the segment count stay in
// registers, so device memory sees the camera rays once and the radiance
// and per-ray segment count once. Each bounce: the analytic scan (spheres,
// planes, triangles, volumes with free flight) against a running nearest
// hit, the dense-mesh Möller–Trumbore scan with per-ray superleaf culling,
// the winner resolve, Threefry-2x32-20 for the bounce draws, the five-way
// BSDF and the throughput update. A miss ends the ray's loop; the last
// bounce accumulates emission only (its scatter would never be traced)
// but still draws its volume uniforms, whose counters are the spec's.
//
// Semantics kept from the spec: class order spheres → planes → triangles
// → volumes → meshes with the earliest index winning ties (strict `<`
// against the running best); mesh t stays in object space and is compared
// with world t; the plane normal flips with Rust signum; the sphere root is
// t1 when t1 >= t_min, else t2 (geometry.rs:406-410); volume free flight
// draws uniform 4+v of the bounce; a thread past the ray count does
// nothing, so padding never counts as a segment.
//
// Arithmetic: Threefry in native uint32 gives the bits of
// utils/threefry.py::bounce_uniforms. sincos_2pi and cbrt_fast are the
// same polynomials and Newton steps as utils/sampling.py (not sinf/cbrtf).
// The mesh test is Möller–Trumbore with the reference's |det| >= 1e-4
// reject and an exact IEEE divide (the Baldwin–Weber rows and approximate
// reciprocal of the TPU kernel were an op-count trick for its vector
// unit). Built without --use_fast_math, so divides and square roots are
// correctly rounded; -fmad stays ON (nvcc's default): multiply-adds are
// contracted into FMAs, which differ from the plain torch version in the
// last bit. That moves no more than float rounding at triangle edges,
// which the parity tests allow for (a winner flip re-rolls one path).
//
// What bounds it on the H100, and what the design does about it:
// - FP32 issue in the mesh scan: a 6,144-triangle mesh is ~40 FP32 ops per
//   triangle test. Per-ray culling of 16-triangle superleaf boxes (sibling
//   BVH leaves, epsilon-padded) against the running best t skips most
//   groups; a later PR replaces the flat scan with BVH traversal.
// - Divergence from dead rays: a ray that misses leaves the loop and its
//   lanes idle while the warp's other rays bounce on. Camera rays of one
//   pixel sit in neighbouring lanes, so warps start coherent; compacting
//   live rays between bounces (the wavefront kernel K4) is a later PR.
// - Register pressure: the whole path state plus the scan's running hit is
//   live across the loop. __launch_bounds__(128, 4) caps the kernel at 128
//   registers (nvcc 12.9 allots it 64, with no spills, so 32 warps fit on
//   an SM); the scene's analytic and material tables (a few KB) sit in
//   shared memory, staged once per block, and the mesh rows (221 KB at
//   6,144 triangles) are read through __ldg from L2.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kPi = 3.14159265358979f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kMtEps = 1e-4f;

// Row widths of the packed scene table (models/scene.py::pack_kernel_tables).
constexpr int kSph = 5;    // cx cy cz r mat
constexpr int kPln = 7;    // px py pz nx ny nz mat
constexpr int kTri = 10;   // a(3) e1(3) e2(3) mat
constexpr int kVol = 6;    // cx cy cz r density mat
constexpr int kMat = 10;   // type albedo(3) emission(3) roughness metallic ior
constexpr int kMesh = 38;  // inv R(9) inv t(3) normal matrix(9) R(9) t(3) mat start count sl_first sl_count

// material type enum (models/materials.py); 0 = Lambertian is the switch's default
constexpr int METAL = 1, DIELECTRIC = 2, PARAMETERIZED = 3, ISOTROPIC = 4;

struct Params {
  const float* o;
  const float* d;
  const int* uid;
  int n;
  float* rad;
  int* segs;
  uint32_t k0, k1;
  int depth;
  float t_min, t_max;
  const float* scene;
  int scene_len;
  int n_sph, n_pln, n_tri, n_vol, n_mat, n_mesh;
  const float* mesh_tri;  // (TT, 9) [a, e1, e2]
  const float* mesh_nrm;  // (TT, 9) decoded corner normals n0 n1 n2
  const float* sl;        // (NSL, 6) superleaf [lo, hi]
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

#define TF_ROUND(r) { x0 += x1; x1 = rotl32(x1, r); x1 ^= x0; }
#define TF_EVEN TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ODD TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)

// Threefry-2x32-20 (utils/threefry.py::threefry2x32).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0,
                                             uint32_t c1, uint32_t& r0, uint32_t& r1) {
  const uint32_t ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
  TF_EVEN x0 += k1;  x1 += ks2 + 1u;
  TF_ODD  x0 += ks2; x1 += k0 + 2u;
  TF_EVEN x0 += k0;  x1 += k1 + 3u;
  TF_ODD  x0 += k1;  x1 += ks2 + 4u;
  TF_EVEN x0 += ks2; x1 += k0 + 5u;
  r0 = x0;
  r1 = x1;
}

// (cos 2πu, sin 2πu): quadrant reduction + Cephes polynomials
// (utils/sampling.py::sincos_2pi).
__device__ __forceinline__ void sincos_2pi(float u, float& co, float& si) {
  const float y = u * 4.0f;
  const float k = rintf(y);  // half to even, as torch.round
  const float th = (y - k) * 1.5707963267948966f;
  const float z = th * th;
  const float s = th * (1.0f + z * (-1.6666654611e-1f + z * (8.3321608736e-3f + z * -1.9515295891e-4f)));
  const float c = 1.0f - 0.5f * z +
                  (z * z) * (4.166664568298827e-2f + z * (-1.388731625493765e-3f + z * 2.443315711809948e-5f));
  const int ki = (int)k;
  co = (ki & 1) ? -s : c;
  si = (ki & 1) ? c : s;
  if (ki & 2) { co = -co; si = -si; }
}

// x^(1/3): bit-hack seed + three Newton steps (utils/sampling.py::cbrt_fast).
__device__ __forceinline__ float cbrt_fast(float u) {
  const float x = fmaxf(u, 1.1754944e-38f);
  float z = __int_as_float(0x54A21D2A - __float_as_int(x) / 3);
  const float third = (float)(1.0 / 3.0);
  for (int i = 0; i < 3; ++i) z = z * (4.0f - x * z * z * z) * third;
  return x * z * z;
}

__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x * (x2 * x2);
}

// Schlick fresnel of the full index of refraction (vecmath.fresnel).
__device__ __forceinline__ float fresnel(float cos_abs_term, float ir) {
  float r0 = (ir - 1.0f) / (ir + 1.0f);
  r0 = r0 * r0;
  return r0 + (1.0f - r0) * pow5(1.0f - cos_abs_term);
}

__global__ void __launch_bounds__(kThreads, 4) bounce_kernel(const Params p) {
  extern __shared__ float sm[];
  for (int k = threadIdx.x; k < p.scene_len; k += blockDim.x) sm[k] = p.scene[k];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;

  const float* sph = sm;
  const float* pln = sph + kSph * p.n_sph;
  const float* tri = pln + kPln * p.n_pln;
  const float* vol = tri + kTri * p.n_tri;
  const float* mat = vol + kVol * p.n_vol;
  const float* msh = mat + kMat * p.n_mat;

  float ox = p.o[3 * i], oy = p.o[3 * i + 1], oz = p.o[3 * i + 2];
  float dx = p.d[3 * i], dy = p.d[3 * i + 1], dz = p.d[3 * i + 2];
  float tr = 1.0f, tg = 1.0f, tb = 1.0f;
  float rr = 0.0f, rg = 0.0f, rb = 0.0f;
  int segs = 0;
  const uint32_t uid = (uint32_t)p.uid[i];
  const float tmin = p.t_min, tmax = p.t_max;

  for (int depth = 0; depth < p.depth; ++depth) {
    ++segs;
    const uint32_t site = (uint32_t)(1 + depth) << 16;  // SITE_BOUNCE0 + depth

    // ---------------- nearest hit ----------------
    float best = CUDART_INF_F;
    int cls = -1, widx = 0, wmesh = 0;
    float bu = 0.0f, bv = 0.0f;

    const float a2 = dx * dx + dy * dy + dz * dz;
    for (int s = 0; s < p.n_sph; ++s) {
      const float* S = sph + kSph * s;
      const float fx = ox - S[0], fy = oy - S[1], fz = oz - S[2];
      const float b = 2.0f * (fx * dx + fy * dy + fz * dz);
      const float c = (fx * fx + fy * fy + fz * fz) - S[3] * S[3];
      const float disc = b * b - 4.0f * a2 * c;
      if (disc >= 0.0f) {
        const float sq = sqrtf(disc);
        const float t1 = (-b - sq) / (2.0f * a2);
        const float t2 = (-b + sq) / (2.0f * a2);
        const float t = t1 >= tmin ? t1 : t2;
        if (t >= tmin && t <= tmax && t < best) { best = t; cls = 0; widx = s; }
      }
    }
    for (int q = 0; q < p.n_pln; ++q) {
      const float* P = pln + kPln * q;
      const float od = (ox - P[0]) * P[3] + (oy - P[1]) * P[4] + (oz - P[2]) * P[5];
      const float sg = od >= 0.0f ? 1.0f : -1.0f;
      const float dd = dx * (sg * P[3]) + dy * (sg * P[4]) + dz * (sg * P[5]);
      const float t = fabsf(od) / fabsf(dd);
      if (dd < 0.0f && t >= tmin && t <= tmax && t < best) { best = t; cls = 1; widx = q; }
    }
    for (int q = 0; q < p.n_tri; ++q) {
      const float* T = tri + kTri * q;
      const float qx = dy * T[8] - dz * T[7], qy = dz * T[6] - dx * T[8], qz = dx * T[7] - dy * T[6];
      const float det = T[3] * qx + T[4] * qy + T[5] * qz;
      if (fabsf(det) >= kMtEps) {
        const float f = 1.0f / det;
        const float sx = ox - T[0], sy = oy - T[1], sz = oz - T[2];
        const float u = f * (sx * qx + sy * qy + sz * qz);
        const float rx = sy * T[5] - sz * T[4], ry = sz * T[3] - sx * T[5], rz = sx * T[4] - sy * T[3];
        const float v = f * (dx * rx + dy * ry + dz * rz);
        const float t = f * (T[6] * rx + T[7] * ry + T[8] * rz);
        if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= tmin && t <= tmax && t < best) {
          best = t; cls = 2; widx = q;
        }
      }
    }
    uint32_t w0 = 0, w1 = 0;
    for (int q = 0; q < p.n_vol; ++q) {
      const float* V = vol + kVol * q;
      // free-flight uniform = draw 4+q: block 1 + q/2, 24-bit
      if ((q & 1) == 0) threefry2x32(p.k0, p.k1, uid, site + 1u + (uint32_t)(q >> 1), w0, w1);
      const float uq = (float)(((q & 1) ? w1 : w0) >> 8) * 5.9604644775390625e-08f;
      const float fx = ox - V[0], fy = oy - V[1], fz = oz - V[2];
      const float b = 2.0f * (fx * dx + fy * dy + fz * dz);
      const float c = (fx * fx + fy * fy + fz * fz) - V[3] * V[3];
      const float disc = b * b - 4.0f * a2 * c;
      if (disc >= 0.0f) {
        const float sq = sqrtf(disc);
        const float t1 = (-b - sq) / (2.0f * a2);
        const float t2 = (-b + sq) / (2.0f * a2);
        const bool exit_ok = t2 >= t1 + 1e-4f;
        const bool in_range = t2 >= tmin && t1 <= tmax;
        const float t_start = fmaxf(t1, tmin);
        const float t_end = fminf(t2, tmax);
        const float dist = (-1.0f / V[4]) * logf(fmaxf(uq, 1e-38f));
        const float t = t_start + dist;
        if (exit_ok && in_range && dist < t_end - t_start && t < best) { best = t; cls = 3; widx = q; }
      }
    }
    for (int m = 0; m < p.n_mesh; ++m) {
      const float* X = msh + kMesh * m;
      const float mox = X[0] * ox + X[1] * oy + X[2] * oz + X[9];
      const float moy = X[3] * ox + X[4] * oy + X[5] * oz + X[10];
      const float moz = X[6] * ox + X[7] * oy + X[8] * oz + X[11];
      const float mdx = X[0] * dx + X[1] * dy + X[2] * dz;
      const float mdy = X[3] * dx + X[4] * dy + X[5] * dz;
      const float mdz = X[6] * dx + X[7] * dy + X[8] * dz;
      const float ix = 1.0f / mdx, iy = 1.0f / mdy, iz = 1.0f / mdz;
      const int start = (int)X[34], sl_first = (int)X[36], sl_count = (int)X[37];
      for (int g = 0; g < sl_count; ++g) {
        const float* B = p.sl + 6 * (sl_first + g);
        const float t0x = (__ldg(B + 0) - mox) * ix, t1x = (__ldg(B + 3) - mox) * ix;
        const float t0y = (__ldg(B + 1) - moy) * iy, t1y = (__ldg(B + 4) - moy) * iy;
        const float t0z = (__ldg(B + 2) - moz) * iz, t1z = (__ldg(B + 5) - moz) * iz;
        const float lo = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fmaxf(fminf(t0z, t1z), tmin));
        const float hi = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                               fminf(fmaxf(t0z, t1z), fminf(best, tmax)));
        if (!(hi >= lo)) continue;  // the ray cannot reach this group before its best hit
        const int r0 = start + 16 * g;
        for (int k = 0; k < 16; ++k) {
          const float* T = p.mesh_tri + 9 * (r0 + k);
          const float ax = __ldg(T + 0), ay = __ldg(T + 1), az = __ldg(T + 2);
          const float e1x = __ldg(T + 3), e1y = __ldg(T + 4), e1z = __ldg(T + 5);
          const float e2x = __ldg(T + 6), e2y = __ldg(T + 7), e2z = __ldg(T + 8);
          const float qx = mdy * e2z - mdz * e2y, qy = mdz * e2x - mdx * e2z, qz = mdx * e2y - mdy * e2x;
          const float det = e1x * qx + e1y * qy + e1z * qz;
          if (!(fabsf(det) >= kMtEps)) continue;
          const float f = 1.0f / det;
          const float sx = mox - ax, sy = moy - ay, sz = moz - az;
          const float u = f * (sx * qx + sy * qy + sz * qz);
          if (!(u >= 0.0f)) continue;
          const float rx = sy * e1z - sz * e1y, ry = sz * e1x - sx * e1z, rz = sx * e1y - sy * e1x;
          const float v = f * (mdx * rx + mdy * ry + mdz * rz);
          const float t = f * (e2x * rx + e2y * ry + e2z * rz);
          // t < tmax strictly: the spec's scan starts its running best at t_max
          if (v >= 0.0f && u + v <= 1.0f && t >= tmin && t < fminf(best, tmax)) {
            best = t; cls = 4; widx = r0 + k; wmesh = m; bu = u; bv = v;
          }
        }
      }
    }

    if (cls < 0) break;  // miss: black background, the ray dies

    // ---------------- winner resolve ----------------
    float px, py, pz, nx = 0.0f, ny = 0.0f, nz = 0.0f;
    bool ff = false;
    int mid;
    if (cls == 4) {
      const float* X = msh + kMesh * wmesh;
      const float mox = X[0] * ox + X[1] * oy + X[2] * oz + X[9];
      const float moy = X[3] * ox + X[4] * oy + X[5] * oz + X[10];
      const float moz = X[6] * ox + X[7] * oy + X[8] * oz + X[11];
      const float mdx = X[0] * dx + X[1] * dy + X[2] * dz;
      const float mdy = X[3] * dx + X[4] * dy + X[5] * dz;
      const float mdz = X[6] * dx + X[7] * dy + X[8] * dz;
      const float* N = p.mesh_nrm + 9 * widx;
      const float w = 1.0f - bu - bv;
      float sx = bu * __ldg(N + 3) + bv * __ldg(N + 6) + w * __ldg(N + 0);
      float sy = bu * __ldg(N + 4) + bv * __ldg(N + 7) + w * __ldg(N + 1);
      float sz = bu * __ldg(N + 5) + bv * __ldg(N + 8) + w * __ldg(N + 2);
      float len = sqrtf(sx * sx + sy * sy + sz * sz + 1e-30f);
      sx /= len; sy /= len; sz /= len;
      ff = sx * mdx + sy * mdy + sz * mdz < 0.0f;
      if (!ff) { sx = -sx; sy = -sy; sz = -sz; }
      const float wx = X[12] * sx + X[13] * sy + X[14] * sz;
      const float wy = X[15] * sx + X[16] * sy + X[17] * sz;
      const float wz = X[18] * sx + X[19] * sy + X[20] * sz;
      len = sqrtf(wx * wx + wy * wy + wz * wz + 1e-30f);
      nx = wx / len; ny = wy / len; nz = wz / len;
      const float qx = mox + best * mdx, qy = moy + best * mdy, qz = moz + best * mdz;
      px = X[21] * qx + X[22] * qy + X[23] * qz + X[30];
      py = X[24] * qx + X[25] * qy + X[26] * qz + X[31];
      pz = X[27] * qx + X[28] * qy + X[29] * qz + X[32];
      mid = (int)X[33];
    } else {
      px = ox + best * dx; py = oy + best * dy; pz = oz + best * dz;
      if (cls == 0) {
        const float* S = sph + kSph * widx;
        const float vx = px - S[0], vy = py - S[1], vz = pz - S[2];
        const float len = sqrtf(vx * vx + vy * vy + vz * vz + 1e-30f);
        nx = vx / len; ny = vy / len; nz = vz / len;
        ff = nx * dx + ny * dy + nz * dz < 0.0f;
        mid = (int)S[4];
      } else if (cls == 1) {
        const float* P = pln + kPln * widx;
        const float od = (ox - P[0]) * P[3] + (oy - P[1]) * P[4] + (oz - P[2]) * P[5];
        const float sg = od >= 0.0f ? 1.0f : -1.0f;
        nx = sg * P[3]; ny = sg * P[4]; nz = sg * P[5];
        ff = nx * dx + ny * dy + nz * dz < 0.0f;
        mid = (int)P[6];
      } else if (cls == 2) {
        const float* T = tri + kTri * widx;
        const float cx = T[4] * T[8] - T[5] * T[7];
        const float cy = T[5] * T[6] - T[3] * T[8];
        const float cz = T[3] * T[7] - T[4] * T[6];
        const float len = sqrtf(cx * cx + cy * cy + cz * cz + 1e-30f);
        nx = cx / len; ny = cy / len; nz = cz / len;
        ff = nx * dx + ny * dy + nz * dz < 0.0f;
        mid = (int)T[9];
      } else {
        mid = (int)(vol + kVol * widx)[5];  // zero normal, back face
      }
      if (cls != 3 && !ff) { nx = -nx; ny = -ny; nz = -nz; }
    }
    const float* M = mat + kMat * mid;
    rr += tr * M[4];
    rg += tg * M[5];
    rb += tb * M[6];
    if (depth == p.depth - 1) break;  // the last scatter is never traced

    // ---------------- scatter ----------------
    uint32_t x0, x1;
    threefry2x32(p.k0, p.k1, uid, site, x0, x1);
    const float s16 = 1.52587890625e-05f;  // 2^-16
    const float u0 = (float)(x0 >> 16) * s16, u1 = (float)(x0 & 0xFFFFu) * s16;
    const float u2 = (float)(x1 >> 16) * s16, uc = (float)(x1 & 0xFFFFu) * s16;
    const float zb = 2.0f * u0 - 1.0f;
    float cphi, sphi;
    sincos_2pi(u1, cphi, sphi);
    const float rad_b = cbrt_fast(u2);
    const float sb = sqrtf(fmaxf(1.0f - zb * zb, 0.0f));
    const float bx = rad_b * (sb * cphi), by = rad_b * (sb * sphi), bz = rad_b * zb;

    const int mtype = (int)M[0];
    const float ar = M[1], ag = M[2], ab = M[3];
    const float rough = M[7], metal = M[8], ior = M[9];
    const float ddn = dx * nx + dy * ny + dz * nz;
    const float bd = bx * nx + by * ny + bz * nz;
    const float hx = bd < 0.0f ? bx - 2.0f * bd * nx : bx;
    const float hy = bd < 0.0f ? by - 2.0f * bd * ny : by;
    const float hz = bd < 0.0f ? bz - 2.0f * bd * nz : bz;
    const float rfx = dx - 2.0f * ddn * nx, rfy = dy - 2.0f * ddn * ny, rfz = dz - 2.0f * ddn * nz;

    float ndx, ndy, ndz, atr, atg, atb, ipdf;
    if (mtype == METAL) {
      ndx = rfx + rough * bx; ndy = rfy + rough * by; ndz = rfz + rough * bz;
      atr = ar; atg = ag; atb = ab; ipdf = 1.0f;
    } else if (mtype == DIELECTRIC) {
      const float eta = ff ? 1.0f / ior : ior;
      const float cos_in = fminf(-ddn, 1.0f);
      const bool critical = eta * sqrtf(fmaxf(1.0f - cos_in * cos_in, 0.0f)) > 1.0f;
      const float fres = fresnel(fabsf(ddn), ior);
      if (!critical && uc >= fres) {
        const float perx = eta * (dx + cos_in * nx);
        const float pery = eta * (dy + cos_in * ny);
        const float perz = eta * (dz + cos_in * nz);
        const float par = -sqrtf(fabsf(1.0f - (perx * perx + pery * pery + perz * perz)));
        ndx = perx + par * nx; ndy = pery + par * ny; ndz = perz + par * nz;
      } else {
        ndx = rfx; ndy = rfy; ndz = rfz;
      }
      atr = atg = atb = 1.0f; ipdf = 1.0f;
    } else if (mtype == PARAMETERIZED) {
      const float k_s = fresnel(fabsf(ddn), 1.5f) * (1.0f - rough);
      const float k_d = (1.0f - k_s) * (1.0f - metal);
      if (uc < k_d) {
        ndx = hx; ndy = hy; ndz = hz;
        atr = ar / kPi; atg = ag / kPi; atb = ab / kPi; ipdf = kTwoPi;
      } else {
        ndx = rfx + rough * bx; ndy = rfy + rough * by; ndz = rfz + rough * bz;
        atr = (1.0f - metal) * 1.0f + metal * ar;
        atg = (1.0f - metal) * 1.0f + metal * ag;
        atb = (1.0f - metal) * 1.0f + metal * ab;
        ipdf = 1.0f;
      }
    } else if (mtype == ISOTROPIC) {
      ndx = bx; ndy = by; ndz = bz;
      atr = ar; atg = ag; atb = ab; ipdf = 1.0f;
    } else {  // Lambertian (and the masked switch's default)
      ndx = hx; ndy = hy; ndz = hz;
      atr = ar / kPi; atg = ag / kPi; atb = ab / kPi; ipdf = kTwoPi;
    }
    // dot term |dir·n| clamped to [0, 1]; 1 for zero-normal volume hits
    const float n2 = nx * nx + ny * ny + nz * nz;
    const float dot_term = n2 > 0.0f ? fminf(fmaxf(fabsf(ndx * nx + ndy * ny + ndz * nz), 0.0f), 1.0f) : 1.0f;
    const float fac = dot_term * ipdf;
    tr = tr * (fac * atr);
    tg = tg * (fac * atg);
    tb = tb * (fac * atb);
    ox = px; oy = py; oz = pz;
    dx = ndx; dy = ndy; dz = ndz;
  }

  p.rad[3 * i] = rr;
  p.rad[3 * i + 1] = rg;
  p.rad[3 * i + 2] = rb;
  p.segs[i] = segs;
}

}  // namespace

extern "C" {

// Launch K1 on `stream`. Returns cudaGetLastError() after the launch (0 on
// success); the caller raises on anything else.
int rt_bounce_launch(const float* o, const float* d, const int* uid, int n, float* rad,
                     int* segs, unsigned k0, unsigned k1, int depth, float t_min,
                     float t_max, const float* scene, int scene_len, int n_sph, int n_pln,
                     int n_tri, int n_vol, int n_mat, int n_mesh, const float* mesh_tri,
                     const float* mesh_nrm, const float* sl, void* stream) {
  if (n <= 0) return 0;
  Params p{o, d, uid, n, rad, segs, k0, k1, depth, t_min, t_max, scene, scene_len,
           n_sph, n_pln, n_tri, n_vol, n_mat, n_mesh, mesh_tri, mesh_nrm, sl};
  const size_t smem = sizeof(float) * (size_t)scene_len;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(bounce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  bounce_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Registers per thread and local (spill) bytes of the compiled kernel.
int rt_bounce_attrs(int* num_regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, bounce_kernel);
  if (e != cudaSuccess) return (int)e;
  *num_regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

}  // extern "C"
