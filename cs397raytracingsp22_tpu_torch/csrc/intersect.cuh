// Intersection device functions shared by the mega-bounce kernel (K1,
// bounce.cu) and the scene-intersection kernel (K2, scene_intersect.cu).
//
// They read the packed scene table of models/scene.py::pack_kernel_tables
// (staged into shared memory by each kernel) and the dense-mesh rows
// kmesh_tri / ksl_bounds (through __ldg). Semantics are those of the plain
// torch spec, ops/intersect.py::intersect_scene_plain:
// - a running nearest hit with strict `<`, visited in class order spheres →
//   planes → triangles → volumes → dense meshes, so the earliest class and
//   index win ties (the spec's class-ordered argmin);
// - analytic candidates need t in [t_min, t_max]; mesh candidates need
//   t < t_max strictly (the spec's scan starts its running best at t_max);
// - sphere root t1 when t1 >= t_min, else t2 (geometry.rs:406-410); plane
//   normals flip with Rust signum (geometry.rs:477-478); a volume scatters
//   at t_start - ln(U)/density when that fits before its exit
//   (geometry.rs:502-525);
// - mesh rays go to object space without renormalisation, so object-space
//   mesh t is compared with world t (geometry.rs:304).
// Möller–Trumbore rejects |det| < 1e-4 (geometry.rs:335) and divides
// exactly (no fast math).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace rt {

constexpr float kMtEps = 1e-4f;

// Row widths of the packed scene table (models/scene.py::pack_kernel_tables).
constexpr int kSph = 5;    // cx cy cz r mat
constexpr int kPln = 7;    // px py pz nx ny nz mat
constexpr int kTri = 10;   // a(3) e1(3) e2(3) mat
constexpr int kVol = 6;    // cx cy cz r density mat
constexpr int kMat = 10;   // type albedo(3) emission(3) roughness metallic ior
constexpr int kMesh = 38;  // inv R(9) inv t(3) normal matrix(9) R(9) t(3) mat start count sl_first sl_count

// Winner classes (the spec's group codes; 4 + k is dense mesh k).
constexpr int kClsSphere = 0, kClsPlane = 1, kClsTri = 2, kClsVolume = 3, kClsMesh = 4;

// The running nearest hit of one ray.
struct Nearest {
  float t;    // starts at +inf
  int cls;    // -1 until something is hit
  int idx;    // index in its class; the global kmesh_tri row for meshes
  int mesh;   // dense mesh k of a mesh winner
  float u, v; // barycentrics of a mesh winner
};

__device__ __forceinline__ Nearest nearest_none() {
  Nearest h;
  h.t = CUDART_INF_F;
  h.cls = -1;
  h.idx = 0;
  h.mesh = 0;
  h.u = 0.0f;
  h.v = 0.0f;
  return h;
}

// The pointers into a staged scene table.
struct SceneRows {
  const float* sph;
  const float* pln;
  const float* tri;
  const float* vol;
  const float* mat;
  const float* msh;
};

__device__ __forceinline__ SceneRows scene_rows(const float* table, int n_sph, int n_pln,
                                                int n_tri, int n_vol, int n_mat) {
  SceneRows r;
  r.sph = table;
  r.pln = r.sph + kSph * n_sph;
  r.tri = r.pln + kPln * n_pln;
  r.vol = r.tri + kTri * n_tri;
  r.mat = r.vol + kVol * n_vol;
  r.msh = r.mat + kMat * n_mat;
  return r;
}

__device__ __forceinline__ void scan_spheres(const float* sph, int n, float ox, float oy, float oz,
                                             float dx, float dy, float dz, float a2, float tmin,
                                             float tmax, Nearest& h) {
  for (int s = 0; s < n; ++s) {
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
      if (t >= tmin && t <= tmax && t < h.t) { h.t = t; h.cls = kClsSphere; h.idx = s; }
    }
  }
}

__device__ __forceinline__ void scan_planes(const float* pln, int n, float ox, float oy, float oz,
                                            float dx, float dy, float dz, float tmin, float tmax,
                                            Nearest& h) {
  for (int q = 0; q < n; ++q) {
    const float* P = pln + kPln * q;
    const float od = (ox - P[0]) * P[3] + (oy - P[1]) * P[4] + (oz - P[2]) * P[5];
    const float sg = od >= 0.0f ? 1.0f : -1.0f;
    const float dd = dx * (sg * P[3]) + dy * (sg * P[4]) + dz * (sg * P[5]);
    const float t = fabsf(od) / fabsf(dd);
    if (dd < 0.0f && t >= tmin && t <= tmax && t < h.t) { h.t = t; h.cls = kClsPlane; h.idx = q; }
  }
}

__device__ __forceinline__ void scan_triangles(const float* tri, int n, float ox, float oy,
                                               float oz, float dx, float dy, float dz, float tmin,
                                               float tmax, Nearest& h) {
  for (int q = 0; q < n; ++q) {
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
      if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= tmin && t <= tmax && t < h.t) {
        h.t = t; h.cls = kClsTri; h.idx = q;
      }
    }
  }
}

// One sphere-bounded volume with free-flight uniform uq: the candidate t
// when the ray scatters inside the volume within [t_min, t_max].
__device__ __forceinline__ void test_volume(const float* V, int q, float uq, float ox, float oy,
                                            float oz, float dx, float dy, float dz, float a2,
                                            float tmin, float tmax, Nearest& h) {
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
    if (exit_ok && in_range && dist < t_end - t_start && t < h.t) {
      h.t = t; h.cls = kClsVolume; h.idx = q;
    }
  }
}

// World ray → object space of the mesh whose packed row is X (inverse R,
// inverse t), without renormalising the direction.
__device__ __forceinline__ void to_object(const float* X, float ox, float oy, float oz, float dx,
                                          float dy, float dz, float& mox, float& moy, float& moz,
                                          float& mdx, float& mdy, float& mdz) {
  mox = X[0] * ox + X[1] * oy + X[2] * oz + X[9];
  moy = X[3] * ox + X[4] * oy + X[5] * oz + X[10];
  moz = X[6] * ox + X[7] * oy + X[8] * oz + X[11];
  mdx = X[0] * dx + X[1] * dy + X[2] * dz;
  mdy = X[3] * dx + X[4] * dy + X[5] * dz;
  mdz = X[6] * dx + X[7] * dy + X[8] * dz;
}

// Dense mesh m (packed row X): Möller–Trumbore over its kmesh_tri rows in
// BVH order, 16 at a time, skipping each 16-row superleaf whose
// epsilon-padded box the ray cannot reach before its running best.
__device__ __forceinline__ void scan_dense_mesh(const float* X, int m, const float* mesh_tri,
                                                const float* sl, float ox, float oy, float oz,
                                                float dx, float dy, float dz, float tmin,
                                                float tmax, Nearest& h) {
  float mox, moy, moz, mdx, mdy, mdz;
  to_object(X, ox, oy, oz, dx, dy, dz, mox, moy, moz, mdx, mdy, mdz);
  const float ix = 1.0f / mdx, iy = 1.0f / mdy, iz = 1.0f / mdz;
  const int start = (int)X[34], sl_first = (int)X[36], sl_count = (int)X[37];
  for (int g = 0; g < sl_count; ++g) {
    const float* B = sl + 6 * (sl_first + g);
    const float t0x = (__ldg(B + 0) - mox) * ix, t1x = (__ldg(B + 3) - mox) * ix;
    const float t0y = (__ldg(B + 1) - moy) * iy, t1y = (__ldg(B + 4) - moy) * iy;
    const float t0z = (__ldg(B + 2) - moz) * iz, t1z = (__ldg(B + 5) - moz) * iz;
    const float lo = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fmaxf(fminf(t0z, t1z), tmin));
    const float hi = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                           fminf(fmaxf(t0z, t1z), fminf(h.t, tmax)));
    if (!(hi >= lo)) continue;  // the ray cannot reach this group before its best hit
    const int r0 = start + 16 * g;
    for (int k = 0; k < 16; ++k) {
      const float* T = mesh_tri + 9 * (r0 + k);
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
      if (v >= 0.0f && u + v <= 1.0f && t >= tmin && t < fminf(h.t, tmax)) {
        h.t = t; h.cls = kClsMesh; h.idx = r0 + k; h.mesh = m; h.u = u; h.v = v;
      }
    }
  }
}

// Point, front-facing shading normal and material id of an analytic winner
// (class 0-3; a volume hit has a zero normal and faces back).
__device__ __forceinline__ void resolve_analytic(const SceneRows& r, int cls, int widx, float best,
                                                 float ox, float oy, float oz, float dx, float dy,
                                                 float dz, float& px, float& py, float& pz,
                                                 float& nx, float& ny, float& nz, bool& ff,
                                                 int& mid) {
  nx = 0.0f; ny = 0.0f; nz = 0.0f;
  ff = false;
  px = ox + best * dx; py = oy + best * dy; pz = oz + best * dz;
  if (cls == kClsSphere) {
    const float* S = r.sph + kSph * widx;
    const float vx = px - S[0], vy = py - S[1], vz = pz - S[2];
    const float len = sqrtf(vx * vx + vy * vy + vz * vz + 1e-30f);
    nx = vx / len; ny = vy / len; nz = vz / len;
    ff = nx * dx + ny * dy + nz * dz < 0.0f;
    mid = (int)S[4];
  } else if (cls == kClsPlane) {
    const float* P = r.pln + kPln * widx;
    const float od = (ox - P[0]) * P[3] + (oy - P[1]) * P[4] + (oz - P[2]) * P[5];
    const float sg = od >= 0.0f ? 1.0f : -1.0f;
    nx = sg * P[3]; ny = sg * P[4]; nz = sg * P[5];
    ff = nx * dx + ny * dy + nz * dz < 0.0f;
    mid = (int)P[6];
  } else if (cls == kClsTri) {
    const float* T = r.tri + kTri * widx;
    const float cx = T[4] * T[8] - T[5] * T[7];
    const float cy = T[5] * T[6] - T[3] * T[8];
    const float cz = T[3] * T[7] - T[4] * T[6];
    const float len = sqrtf(cx * cx + cy * cy + cz * cz + 1e-30f);
    nx = cx / len; ny = cy / len; nz = cz / len;
    ff = nx * dx + ny * dy + nz * dz < 0.0f;
    mid = (int)T[9];
  } else {
    mid = (int)(r.vol + kVol * widx)[5];  // zero normal, back face
  }
  if (cls != kClsVolume && !ff) { nx = -nx; ny = -ny; nz = -nz; }
}

// Stage `len` floats of a table into shared memory (all threads of the
// block take part; ends with a barrier).
__device__ __forceinline__ void stage_table(float* sm, const float* table, int len) {
  for (int k = threadIdx.x; k < len; k += blockDim.x) sm[k] = table[k];
  __syncthreads();
}

}  // namespace rt
