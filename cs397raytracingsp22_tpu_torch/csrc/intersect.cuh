// Intersection device functions shared by the mega-bounce kernel (K1,
// bounce.cu) and the scene-intersection kernel (K2, scene_intersect.cu).
//
// They read the packed scene table and the superleaf trees of
// models/scene.py::pack_kernel_tables (both staged into shared memory by
// each kernel) and the dense-mesh rows kmesh_tri4 (through __ldg, three
// 16-byte loads a row). Semantics are those of the plain torch spec,
// ops/intersect.py::intersect_scene_plain:
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
// exactly (no fast math). K1 walks a scene's sphere tree (walk_spheres)
// in place of scan_spheres from 64 spheres on, with the scan's result.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "bvh_walk.cuh"

namespace rt {

// Row widths of the packed scene table (models/scene.py::pack_kernel_tables).
constexpr int kSph = 5;    // cx cy cz r mat
constexpr int kPln = 7;    // px py pz nx ny nz mat
constexpr int kTri = 10;   // a(3) e1(3) e2(3) mat
constexpr int kVol = 6;    // cx cy cz r density mat
constexpr int kMat = 10;   // type albedo(3) emission(3) roughness metallic ior
constexpr int kMesh = 38;  // inv R(9) inv t(3) normal matrix(9) R(9) t(3) mat start count sl_first sl_count
// a big mesh's row (kmesh_xfm, K1): normal matrix(9) R(9) t(3) inv R(9) inv t(3) first kmesh_res
// row, triangles, mat
constexpr int kXfm = 36;

// Winner classes (the spec's group codes; 4 + k is dense mesh k). K1 marks a
// big mesh's winner kClsBig.
constexpr int kClsSphere = 0, kClsPlane = 1, kClsTri = 2, kClsVolume = 3, kClsMesh = 4;
constexpr int kClsBig = 5;

// The running nearest hit of one ray.
struct Nearest {
  float t;    // starts at +inf
  int cls;    // -1 until something is hit
  int idx;    // index in its class; the global kmesh_tri row for dense meshes, the
              // mesh's own bvh_tri4 row for a big mesh
  int mesh;   // dense mesh k, or big mesh b, of a mesh winner
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
  const float4* tree;  // the dense meshes' superleaf trees, two float4 a node
  const float4* sph_tree;  // the staged sphere tree's header and nodes (K1), or null
};

__device__ __forceinline__ SceneRows scene_rows(const float* table, int n_sph, int n_pln,
                                                int n_tri, int n_vol, int n_mat,
                                                const float4* tree) {
  SceneRows r;
  r.sph = table;
  r.pln = r.sph + kSph * n_sph;
  r.tri = r.pln + kPln * n_pln;
  r.vol = r.tri + kTri * n_tri;
  r.mat = r.vol + kVol * n_vol;
  r.msh = r.mat + kMat * n_mat;
  r.tree = tree;
  r.sph_tree = nullptr;
  return r;
}

// The root of sphere (cx, cy, cz, r) that the scan keeps: t1 when t1 >=
// t_min, else t2; false when the ray's line misses the sphere.
__device__ __forceinline__ bool sphere_root(float cx, float cy, float cz, float r, float ox,
                                            float oy, float oz, float dx, float dy, float dz,
                                            float a2, float tmin, float& t) {
  const float fx = ox - cx, fy = oy - cy, fz = oz - cz;
  const float b = 2.0f * (fx * dx + fy * dy + fz * dz);
  const float c = (fx * fx + fy * fy + fz * fz) - r * r;
  const float disc = b * b - 4.0f * a2 * c;
  if (!(disc >= 0.0f)) return false;
  const float sq = sqrtf(disc);
  const float t1 = (-b - sq) / (2.0f * a2);
  const float t2 = (-b + sq) / (2.0f * a2);
  t = t1 >= tmin ? t1 : t2;
  return true;
}

__device__ __forceinline__ void scan_spheres(const float* sph, int n, float ox, float oy, float oz,
                                             float dx, float dy, float dz, float a2, float tmin,
                                             float tmax, Nearest& h) {
  for (int s = 0; s < n; ++s) {
    const float* S = sph + kSph * s;
    float t;
    if (sphere_root(S[0], S[1], S[2], S[3], ox, oy, oz, dx, dy, dz, a2, tmin, t) && t >= tmin &&
        t <= tmax && t < h.t) {
      h.t = t; h.cls = kClsSphere; h.idx = s;
    }
  }
}

// The sphere tree (models/scene.py::sphere_tree) in place of scan_spheres,
// for scenes of SPHERE_TREE_MIN spheres or more: `nodes` the staged header
// and nodes (node k at nodes[2k], nodes[2k + 1]), `g` its leaves, `slots`
// and `ids` each leaf's kSphLeaf sphere rows [c, r] and scene indices in
// device memory. A stackless preorder walk, as scan_dense_mesh's: node k is
// entered when the ray meets its box, grown by `pad` on every side, within
// [tmin, min(running best, tmax)]; a leaf tests its spheres with
// sphere_root and keeps the least (t, index), so the result is the scan's,
// ties to the lowest index included. The walk is the first class, so the
// running best holds only spheres.
//
// The pad makes the cull safe against rounding. A sphere's computed root
// can lie off the sphere: where the ray grazes it, the rounding of b² -
// 4ac (~eps·|f|² with f = o - c) moves the root along the ray by up to
// ~sqrt(eps)·|f| and the accepted line up to ~eps·|f|²/r outside the
// sphere. On 16 million float32 grazing rays (radii 0.5 to 100, |o - c| up
// to 6,000, directions of length 0.01 to 3) the root lay at most 5.7e-4 ·
// (|o|_inf + reach) outside the sphere's box, with reach = max |c|_inf + r
// over the scene's spheres (the header's first float), so kSphPad = 2^-9
// of that leaves 3.4 times the worst reading. An ancestor's box holds its
// leaf's exactly, and (lo - (o + pad)) * inv is monotone in lo, so a leaf
// whose grown box passes is never culled by an ancestor.
constexpr int kSphLeaf = 4;
constexpr float kSphPad = 1.0f / 512.0f;

__device__ __forceinline__ void walk_spheres(const float4* nodes, int g, const float4* slots,
                                             const float* ids, float ox, float oy, float oz,
                                             float dx, float dy, float dz, float a2, float tmin,
                                             float tmax, Nearest& h) {
  const float pad = kSphPad * (fmaxf(fmaxf(fabsf(ox), fabsf(oy)), fabsf(oz)) + nodes[0].x);
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  // (lo - pad) - o as lo - (o + pad), (hi + pad) - o as hi - (o - pad)
  const float lx = ox + pad, ly = oy + pad, lz = oz + pad;
  const float ux = ox - pad, uy = oy - pad, uz = oz - pad;
  int k = 1;
  do {
    const float4 lo = nodes[2 * k], hi = nodes[2 * k + 1];
    const float t0x = (lo.x - lx) * ix, t1x = (hi.x - ux) * ix;
    const float t0y = (lo.y - ly) * iy, t1y = (hi.y - uy) * iy;
    const float t0z = (lo.z - lz) * iz, t1z = (hi.z - uz) * iz;
    const float near_t =
        fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fmaxf(fminf(t0z, t1z), tmin));
    const float far_t =
        fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fminf(fmaxf(t0z, t1z), fminf(h.t, tmax)));
    if (far_t >= near_t) {
      if (k < g) {
        k *= 2;  // an inner node: enter its first child
        continue;
      }
      for (int j = kSphLeaf * (k - g); j < kSphLeaf * (k - g + 1); ++j) {
        const int s = (int)__ldg(ids + j);
        if (s < 0) break;  // the leaf's empty slots come last
        const float4 S = __ldg(slots + j);
        float t;
        if (sphere_root(S.x, S.y, S.z, S.w, ox, oy, oz, dx, dy, dz, a2, tmin, t) && t >= tmin &&
            t <= tmax && (t < h.t || (t == h.t && s < h.idx))) {
          h.t = t; h.cls = kClsSphere; h.idx = s;
        }
      }
    }
    k = (k >> (__ffs(~k) - 1)) + 1;  // past k's subtree
  } while (k != 1);
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

// The slab test of one superleaf-tree node (lo, hi: two float4 in shared
// memory) for an object-space ray (origin mo, inverse direction i): does the
// ray meet the box within [tmin, far]? fminf / fmaxf drop a NaN slab (0 * inf
// where a direction component is zero and the origin lies on a face), and
// tmin and far are never NaN, so neither bound is.
__device__ __forceinline__ bool node_reached(const float4* node, float mox, float moy, float moz,
                                             float ix, float iy, float iz, float tmin,
                                             float far) {
  const float4 lo = node[0], hi = node[1];
  const float t0x = (lo.x - mox) * ix, t1x = (hi.x - mox) * ix;
  const float t0y = (lo.y - moy) * iy, t1y = (hi.y - moy) * iy;
  const float t0z = (lo.z - moz) * iz, t1z = (hi.z - moz) * iz;
  const float near_t = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fmaxf(fminf(t0z, t1z), tmin));
  const float far_t = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fminf(fmaxf(t0z, t1z), far));
  return far_t >= near_t;
}

// Möller–Trumbore of kmesh_tri4 row `row` (three 16-byte loads) against
// the object-space ray (origin mo, direction md): true on a hit with t in
// [tmin, far), far excluded (the spec's scan keeps a hit only when it is
// strictly nearer than its running best, which starts at t_max).
__device__ __forceinline__ bool mt_row(const float4* mesh_tri, int row, float mox, float moy,
                                       float moz, float mdx, float mdy, float mdz, float tmin,
                                       float far, float& t, float& u, float& v) {
  const float4 p = __ldg(mesh_tri + 3 * row), q = __ldg(mesh_tri + 3 * row + 1),
               w = __ldg(mesh_tri + 3 * row + 2);  // [a, e1, e2, 0, 0, 0]
  const float ax = p.x, ay = p.y, az = p.z, e1x = p.w, e1y = q.x, e1z = q.y;
  const float e2x = q.z, e2y = q.w, e2z = w.x;
  const float qx = mdy * e2z - mdz * e2y, qy = mdz * e2x - mdx * e2z, qz = mdx * e2y - mdy * e2x;
  const float det = e1x * qx + e1y * qy + e1z * qz;
  if (!(fabsf(det) >= kMtEps)) return false;
  const float f = 1.0f / det;
  const float sx = mox - ax, sy = moy - ay, sz = moz - az;
  u = f * (sx * qx + sy * qy + sz * qz);
  if (!(u >= 0.0f)) return false;
  const float rx = sy * e1z - sz * e1y, ry = sz * e1x - sx * e1z, rz = sx * e1y - sy * e1x;
  v = f * (mdx * rx + mdy * ry + mdz * rz);
  t = f * (e2x * rx + e2y * ry + e2z * rz);
  return v >= 0.0f && u + v <= 1.0f && t >= tmin && t < far;
}

// A float's bits as an unsigned key in the float's order (not NaN), and
// back.
__device__ __forceinline__ unsigned ordered_key(float x) {
  const unsigned b = __float_as_uint(x);
  return b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
}
__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float(key ^ ((key >> 31) ? 0x80000000u : 0xffffffffu));
}

// Dense mesh m (packed row X): a stackless preorder walk of the mesh's
// superleaf tree (models/scene.py::superleaf_tree, staged in shared memory),
// with Möller–Trumbore on the 16 kmesh_tri4 rows of each superleaf reached.
// Node k (1-based heap order; the mesh's nodes start at tree row
// 2 * sl_first - m) is entered when the ray meets its box within
// [tmin, min(running best, tmax)]: an inner node goes on to its first child
// 2k; a culled node, or a leaf once scanned, skips its subtree (strip k's
// trailing one bits, add 1), and the walk ends back at the root. A ray
// whose running best lies before the mesh's box costs the root's test alone.
//
// The warp scans leaves together. Each step, every lane still walking tests
// one node; then each lane that reached a leaf has it scanned by the whole
// warp, one leaf after another: its ray and bounds are broadcast, the active
// lanes test the 16 rows (lane rank r takes rows r, r + lanes, ...), and the
// least t wins, the lowest row on ties (two warp reductions). A ray leaving
// the mesh's surface reaches several overlapping superleaves, so one lane
// often holds most of its warp's leaves; scanning them on one lane idled the
// other 31 for 16 rows each (PERF.md, PR 5). The reductions and broadcasts
// use the lanes active on entry (__activemask), which all stay in the loop
// until no lane walks.
//
// The walk scans exactly the superleaves that a flat scan of every
// superleaf box in row order scans, in the same order, so the rows give
// the same bits: preorder meets the leaves in row order, and an ancestor of
// leaf g is tested with a running best no nearer than the one leaf g is
// tested with. Its box contains the leaf's (an exact float32 union), and
// the slab bounds (b - o) * inv are monotone in b, so on every axis its
// interval contains the leaf's: the leaf is never culled by an ancestor
// where it would pass itself. NaN slabs need b == o with a zero direction
// component; since every superleaf box has lo < hi on each axis (the eps
// pad, checked by models/scene.py::superleaf_trees), a leaf that passes
// such an axis has lo < o < hi there, and so has each ancestor. Within a leaf the least t
// against the bound at the leaf's entry, lowest row first, is the row a
// serial scan with strict `<` keeps; rows are met in ascending order, so
// ties keep the lowest row overall.
__device__ __forceinline__ void scan_dense_mesh(const float* X, int m, const float4* mesh_tri,
                                                const float4* tree, float ox, float oy, float oz,
                                                float dx, float dy, float dz, float tmin,
                                                float tmax, Nearest& h) {
  float mox, moy, moz, mdx, mdy, mdz;
  to_object(X, ox, oy, oz, dx, dy, dz, mox, moy, moz, mdx, mdy, mdz);
  const float ix = 1.0f / mdx, iy = 1.0f / mdy, iz = 1.0f / mdz;
  const int s = (int)X[37];
  const float4* nodes = tree + 2 * (2 * (int)X[36] - m - 1);  // node k at nodes[2k], nodes[2k + 1]
  const unsigned warp = __activemask();
  int k = 1;
  bool walking = true;
  do {
    int r0 = -1;  // the first row of a superleaf this lane reached in this step
    if (walking) {
      if (node_reached(nodes + 2 * k, mox, moy, moz, ix, iy, iz, tmin, fminf(h.t, tmax))) {
        if (k < s) {
          k *= 2;  // an inner node: enter its first child
        } else {
          // leaf k is superleaf g: the deepest level, from node `top`, holds the first ones
          const int top = 1 << (31 - __clz(2 * s - 1));
          r0 = (int)X[34] + 16 * (k - top + (k < top ? s : 0));
          k = (k >> (__ffs(~k) - 1)) + 1;
        }
      } else {
        k = (k >> (__ffs(~k) - 1)) + 1;  // past k's subtree: the next sibling of k or of an ancestor
      }
      walking = k != 1;
    }
    for (unsigned pend = __ballot_sync(warp, r0 >= 0); pend; pend &= pend - 1) {
      const int src = __ffs(pend) - 1, lane = threadIdx.x & 31;
      const int rank = __popc(warp & ((1u << lane) - 1u)), lanes = __popc(warp);
      const int sr0 = __shfl_sync(warp, r0, src);
      const float sox = __shfl_sync(warp, mox, src), soy = __shfl_sync(warp, moy, src),
                  soz = __shfl_sync(warp, moz, src), sdx = __shfl_sync(warp, mdx, src),
                  sdy = __shfl_sync(warp, mdy, src), sdz = __shfl_sync(warp, mdz, src);
      const float stmin = __shfl_sync(warp, tmin, src);
      const float sfar = __shfl_sync(warp, fminf(h.t, tmax), src);
      unsigned key = 0xffffffffu, row = 16;
      float bu = 0.0f, bv = 0.0f;
      for (int j = rank; j < 16; j += lanes) {
        float t, u, v;
        if (mt_row(mesh_tri, sr0 + j, sox, soy, soz, sdx, sdy, sdz, stmin, sfar, t, u, v) &&
            ordered_key(t) < key) {
          key = ordered_key(t); row = j; bu = u; bv = v;
        }
      }
      const unsigned kmin = __reduce_min_sync(warp, key);
      if (kmin == 0xffffffffu) continue;  // no row of this leaf hits
      const unsigned jmin = __reduce_min_sync(warp, key == kmin ? row : 16u);
      const int wl = __ffs(__ballot_sync(warp, key == kmin && row == jmin)) - 1;
      const float wu = __shfl_sync(warp, bu, wl), wv = __shfl_sync(warp, bv, wl);
      if (lane == src) {
        h.t = key_value(kmin); h.cls = kClsMesh; h.idx = sr0 + (int)jmin; h.mesh = m; h.u = wu; h.v = wv;
      }
    }
  } while (__any_sync(warp, walking));
}

// A big mesh (its kmesh_xfm row Y, staged), for K1: the ordered walk of the
// mesh's BVH (bvh_walk.cuh; nodes, tris: its bvh_nodes and bvh_tri4 rows in
// device memory) in object space, with this thread's stack entries
// kStride apart from `stack`. The big mesh comes after every other class,
// so a row must be strictly nearer than the running best h.t; with nothing
// hit yet, the window's end t_max is in reach, as in the threaded walk
// (bvh.traverse keeps t <= its best, which starts at t_max). So the walk
// starts at best = min(h.t, tmax), and its tie rule (a row at t == best
// from a larger row) is closed where the best came from another class by
// a first row no row exceeds. An interior root must pass its slab test.
// Within the mesh the winner is K3's: the threaded walk's, but where the
// Möller–Trumbore and slab tests round apart (bvh_traverse.cu).
template <int kStride>
__device__ __forceinline__ void walk_big_mesh(const float* Y, const float4* nodes,
                                              const float4* tris, int2* stack, float ox,
                                              float oy, float oz, float dx, float dy, float dz,
                                              float tmin, float tmax, Nearest& h) {
  BvhRay r;
  to_object(Y + 21, ox, oy, oz, dx, dy, dz, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz);
  r.ix = 1.0f / r.dx, r.iy = 1.0f / r.dy, r.iz = 1.0f / r.dz;
  r.tmin = tmin;
  float best = fminf(h.t, tmax), bu = 0.0f, bv = 0.0f;
  int brow = h.cls < 0 ? -1 : 0x7fffffff;
  const float4 root_lo = __ldg(nodes), root_hi = __ldg(nodes + 1);
  int ref = __float_as_int(root_lo.w), sp = 0;
  float entry;
  if (ref > 0 && !bvh_slab(root_lo, root_hi, r, best, entry)) return;
  do {
    bvh_walk_step<kStride>(nodes, tris, r, stack, ref, sp, best, brow, bu, bv);
  } while (ref != kPop);
  if (brow >= 0 && brow != 0x7fffffff) {
    h.t = best; h.cls = kClsBig; h.idx = brow; h.u = bu; h.v = bv;
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

// Where the superleaf trees start in shared memory, in floats after a
// scene table of `len` floats: the next 16-byte boundary.
__host__ __device__ constexpr int tree_offset(int len) { return (len + 3) & ~3; }

// Bytes of shared memory a block stages: the scene table (`len` floats)
// and the superleaf trees (`tree_len` floats, TREE_ROW = 8 a node).
__host__ __device__ constexpr size_t staged_bytes(int len, int tree_len) {
  return sizeof(float) * (size_t)(tree_offset(len) + tree_len);
}

// Bytes a block stages on a sphere-tree route (K1, K2's tree route): the
// scene table from float `skip` on (past the sphere rows: K1 skips them
// exactly, K2 from its last 16-byte word before their end), the superleaf
// trees, and the sphere tree's header and nodes (4 float4 a leaf).
__host__ __device__ constexpr size_t sph_tree_staged_bytes(int len, int tree_len, int skip,
                                                           int sph_leaves) {
  return staged_bytes(len - skip, tree_len) + 64 * (size_t)sph_leaves;
}

// Stage the scene table (`len` floats), the superleaf trees (`tree_len`
// floats, 16-byte aligned in device memory) and `extra_rows` float4 of
// `extra` after them into shared memory `sm` (16-byte aligned). All threads
// of the block take part; ends with a barrier. Returns the staged trees;
// the extra rows follow them at tree_len / 4.
__device__ __forceinline__ const float4* stage_tables(float* sm, const float* table, int len,
                                                      const float* tree, int tree_len,
                                                      const float4* extra = nullptr,
                                                      int extra_rows = 0) {
  for (int k = threadIdx.x; k < len; k += blockDim.x) sm[k] = table[k];
  float4* dst = reinterpret_cast<float4*>(sm + tree_offset(len));
  const float4* src = reinterpret_cast<const float4*>(tree);
  for (int k = threadIdx.x; k < tree_len / 4; k += blockDim.x) dst[k] = __ldg(src + k);
  for (int k = threadIdx.x; k < extra_rows; k += blockDim.x) dst[tree_len / 4 + k] = __ldg(extra + k);
  __syncthreads();
  return dst;
}

}  // namespace rt
