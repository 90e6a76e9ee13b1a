// One bounce of the reference estimator, shared by the mega-bounce kernel
// (K1, bounce.cu: every bounce of a ray in one loop) and the wavefront
// kernel (K4, wavefront.cu: one bounce per launch), so the two cannot
// drift apart. A bounce is the nearest hit over every class (the device
// functions of intersect.cuh), the winner resolve, emission, the
// Threefry-2x32-20 draws of the bounce, the five-way BSDF and the
// throughput update, as render/integrator.py::_bounce_update computes it.
//
// Arithmetic: Threefry in native uint32 gives the bits of
// utils/threefry.py::bounce_uniforms. sincos_2pi and cbrt_fast are the
// same polynomials and Newton steps as utils/sampling.py (not sinf/cbrtf).

#pragma once

#include "intersect.cuh"

namespace rt {

constexpr float kPi = 3.14159265358979f;
constexpr float kTwoPi = 6.283185307179586f;

// material type enum (models/materials.py); 0 = Lambertian is the switch's default
constexpr int METAL = 1, DIELECTRIC = 2, PARAMETERIZED = 3, ISOTROPIC = 4;

// The state a ray carries from one bounce to the next.
struct PathState {
  float ox, oy, oz, dx, dy, dz;  // origin, direction
  float tr, tg, tb;              // throughput
  float rr, rg, rb;              // radiance so far
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

// Point and front-facing world shading normal of a mesh winner at t `best`,
// barycentrics (bu, bv): the object-space ray (mo, md), the winner's decoded
// corner normals N (n0 n1 n2, in device memory) and P, its mesh's normal
// matrix, R and t (9, 9 and 3 floats, row-major, one after the other).
__device__ __forceinline__ void resolve_mesh(const float* P, const float* N, float mox, float moy,
                                             float moz, float mdx, float mdy, float mdz,
                                             float best, float bu, float bv, float& px,
                                             float& py, float& pz, float& nx, float& ny,
                                             float& nz, bool& ff) {
  const float w = 1.0f - bu - bv;
  float sx = bu * __ldg(N + 3) + bv * __ldg(N + 6) + w * __ldg(N + 0);
  float sy = bu * __ldg(N + 4) + bv * __ldg(N + 7) + w * __ldg(N + 1);
  float sz = bu * __ldg(N + 5) + bv * __ldg(N + 8) + w * __ldg(N + 2);
  float len = sqrtf(sx * sx + sy * sy + sz * sz + 1e-30f);
  sx /= len; sy /= len; sz /= len;
  ff = sx * mdx + sy * mdy + sz * mdz < 0.0f;
  if (!ff) { sx = -sx; sy = -sy; sz = -sz; }
  const float wx = P[0] * sx + P[1] * sy + P[2] * sz;
  const float wy = P[3] * sx + P[4] * sy + P[5] * sz;
  const float wz = P[6] * sx + P[7] * sy + P[8] * sz;
  len = sqrtf(wx * wx + wy * wy + wz * wz + 1e-30f);
  nx = wx / len; ny = wy / len; nz = wz / len;
  const float qx = mox + best * mdx, qy = moy + best * mdy, qz = moz + best * mdz;
  px = P[9] * qx + P[10] * qy + P[11] * qz + P[18];
  py = P[12] * qx + P[13] * qy + P[14] * qz + P[19];
  pz = P[15] * qx + P[16] * qy + P[17] * qz + P[20];
}

// The big mesh's staged kmesh_xfm row (after the superleaf trees, which
// follow the scene table, whose sphere rows stay: no sphere tree beside a
// big mesh), and this thread's stack for its walk after it, entry k at
// [k * kStackStride].
template <class Args>
__device__ __forceinline__ const float* big_row(const SceneRows& R, const Args& a) {
  return reinterpret_cast<const float*>(R.tree) + a.tree_len;
}
template <class Args>
__device__ __forceinline__ int2* big_stack(const SceneRows& R, const Args& a) {
  return reinterpret_cast<int2*>(const_cast<float*>(big_row(R, a)) + kXfm) + threadIdx.x;
}

// Bounce `depth` (RNG site SITE_BOUNCE0 + depth) of ray `uid`, whose scene
// table and superleaf trees R are staged in shared memory. `a` is the
// calling kernel's own flat parameter block, read by field name: the RNG
// key (k0, k1), the ray
// window (t_min, t_max), the table counts (n_sph, n_pln, n_tri, n_vol,
// n_mesh) and the dense-mesh rows (mesh_tri, mesh_nrm;
// models/scene.py::pack_kernel_tables). A flat block keeps K1 as fast as
// before this body was shared; the same fields in a nested struct made K1
// 1.3% slower on the H100 (PERF.md). Returns false when the ray ends here:
// it misses (black background), or this is the `last` bounce, which adds
// emission only (its scatter would never be traced) but still draws its
// volume uniforms, whose counters are the spec's. Otherwise the state moves
// on to the scattered ray and returns true. kDense false compiles out the
// dense-mesh walk and resolve, for a scene with no dense mesh. kSphTree
// walks the sphere tree (intersect.cuh::walk_spheres: its staged nodes
// R.sph_tree, and from `a` its leaves sph_leaves and its table sph_table in
// device memory) in place of the sphere scan; only K1 instantiates it.
// kBig walks the scene's big mesh's BVH after the analytic classes
// (intersect.cuh::walk_big_mesh: its staged kmesh_xfm row and the thread's
// stack, big_row and big_stack, and from `a` the tables big_nodes and
// big_tris, the corner normals in big_res, the stack's stride
// kStackStride); only K1 instantiates it, for a scene with no dense mesh. The pointers are worked out here
// and not kept in SceneRows: two more fields there moved the registers of
// bounce_kernel<true, true>'s SASS (PERF.md, PR 21).
template <bool kDense = true, bool kSphTree = false, bool kBig = false, class Args>
__device__ __forceinline__ bool bounce_step(const Args& a, const SceneRows& R, uint32_t uid,
                                            int depth, bool last, PathState& s) {
  float &ox = s.ox, &oy = s.oy, &oz = s.oz, &dx = s.dx, &dy = s.dy, &dz = s.dz;
  float &tr = s.tr, &tg = s.tg, &tb = s.tb, &rr = s.rr, &rg = s.rg, &rb = s.rb;
  const float tmin = a.t_min, tmax = a.t_max;
  const uint32_t site = (uint32_t)(1 + depth) << 16;  // SITE_BOUNCE0 + depth

  // ---------------- nearest hit (intersect.cuh) ----------------
  Nearest h = nearest_none();
  const float a2 = dx * dx + dy * dy + dz * dz;
  if constexpr (kSphTree) {
    const float4* slots = a.sph_table + 4 * a.sph_leaves;  // after the header and nodes
    walk_spheres(R.sph_tree, a.sph_leaves, slots,
                 reinterpret_cast<const float*>(slots + kSphLeaf * a.sph_leaves), ox, oy, oz, dx,
                 dy, dz, a2, tmin, tmax, h);
  } else {
    scan_spheres(R.sph, a.n_sph, ox, oy, oz, dx, dy, dz, a2, tmin, tmax, h);
  }
  scan_planes(R.pln, a.n_pln, ox, oy, oz, dx, dy, dz, tmin, tmax, h);
  scan_triangles(R.tri, a.n_tri, ox, oy, oz, dx, dy, dz, tmin, tmax, h);
  uint32_t w0 = 0, w1 = 0;
  for (int q = 0; q < a.n_vol; ++q) {
    // free-flight uniform = draw 4+q: block 1 + q/2, 24-bit
    if ((q & 1) == 0) threefry2x32(a.k0, a.k1, uid, site + 1u + (uint32_t)(q >> 1), w0, w1);
    const float uq = (float)(((q & 1) ? w1 : w0) >> 8) * 5.9604644775390625e-08f;
    test_volume(R.vol + kVol * q, q, uq, ox, oy, oz, dx, dy, dz, a2, tmin, tmax, h);
  }
  for (int m = 0; kDense && m < a.n_mesh; ++m) {
    scan_dense_mesh(R.msh + kMesh * m, m, a.mesh_tri, R.tree, ox, oy, oz, dx, dy, dz, tmin, tmax, h);
  }
  if constexpr (kBig) {
    walk_big_mesh<Args::kStackStride>(big_row(R, a), a.big_nodes, a.big_tris, big_stack(R, a), ox,
                                      oy, oz, dx, dy, dz, tmin, tmax, h);
  }
  const float best = h.t;
  const int cls = h.cls, widx = h.idx;

  if (cls < 0) return false;  // miss: black background, the ray dies

  // ---------------- winner resolve ----------------
  float px, py, pz, nx, ny, nz;
  bool ff;
  int mid;
  if (kDense && cls == kClsMesh) {
    const float* X = R.msh + kMesh * h.mesh;
    float mox, moy, moz, mdx, mdy, mdz;
    to_object(X, ox, oy, oz, dx, dy, dz, mox, moy, moz, mdx, mdy, mdz);
    resolve_mesh(X + 12, a.mesh_nrm + 9 * widx, mox, moy, moz, mdx, mdy, mdz, best, h.u, h.v,
                 px, py, pz, nx, ny, nz, ff);
    mid = (int)X[33];
  } else {
    // nested so that the instantiations without big meshes compile to the SASS they had
    if constexpr (kBig) {
      if (cls == kClsBig) {
        const float* Y = big_row(R, a);
        float mox, moy, moz, mdx, mdy, mdz;
        to_object(Y + 21, ox, oy, oz, dx, dy, dz, mox, moy, moz, mdx, mdy, mdz);
        // the winner's kmesh_res row: [corner normals, uvs, tangent]
        resolve_mesh(Y, a.big_res + 18 * ((int)Y[33] + widx), mox, moy, moz, mdx, mdy, mdz, best,
                     h.u, h.v, px, py, pz, nx, ny, nz, ff);
        mid = (int)Y[35];
      } else {
        resolve_analytic(R, cls, widx, best, ox, oy, oz, dx, dy, dz, px, py, pz, nx, ny, nz, ff,
                         mid);
      }
    } else {
      resolve_analytic(R, cls, widx, best, ox, oy, oz, dx, dy, dz, px, py, pz, nx, ny, nz, ff, mid);
    }
  }
  const float* M = R.mat + kMat * mid;
  rr += tr * M[4];
  rg += tg * M[5];
  rb += tb * M[6];
  if (last) return false;  // the last scatter is never traced

  // ---------------- scatter ----------------
  uint32_t x0, x1;
  threefry2x32(a.k0, a.k1, uid, site, x0, x1);
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
  return true;
}

}  // namespace rt
