// One step of the ordered walk of a big mesh's BVH, shared by the big-mesh
// kernel (K3, bvh_traverse.cu: the staged path) and the mega-bounce kernel
// (K1, bounce.cu through intersect.cuh::walk_big_mesh), so the two cannot
// drift apart. Its plain version, step for step, is
// ops/bvh.py::traverse_packed; why it returns the threaded walk's winner is
// set out in bvh_traverse.cu.
//
// The tables (models/scene.py::mesh_kernel_tables, ops/bvh.py::pack_bvh):
// - nodes: one 64-byte row per interior node holding both children as
//   [lo.xyz, ref, hi.xyz, 0], read as four 16-byte loads issued together;
//   ref is the child's row (>= 1) or, for a leaf, ~(first row << 4 |
//   count). Row 0 holds the root in its first slot.
// - tris: the 48-byte rows [a, e1, e2, 0, 0, 0] of tri_verts in BVH order:
//   three 16-byte loads.
// A lane's stack holds (ref, entry bits) pairs, entry k at stack[k * kStride]
// (kStride: the threads of the block, so the lanes of a warp hit distinct
// banks).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace rt {

constexpr float kMtEps = 1e-4f;  // Möller–Trumbore's |det| reject (geometry.rs:335)
constexpr int kPop = 0;  // row 0 is never a child: the lane's next node comes off the stack

// An object-space ray: origin, direction, inverse direction, t_min.
struct BvhRay {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmin;
};

// traverse's slab test of one box against [t_min, best]; entry = the
// interval's start
__device__ __forceinline__ bool bvh_slab(const float4 lo, const float4 hi, const BvhRay& r,
                                         float best, float& entry) {
  const float t0x = (lo.x - r.ox) * r.ix, t1x = (hi.x - r.ox) * r.ix;
  const float t0y = (lo.y - r.oy) * r.iy, t1y = (hi.y - r.oy) * r.iy;
  const float t0z = (lo.z - r.oz) * r.iz, t1z = (hi.z - r.oz) * r.iz;
  const float nx = fmaxf(r.ix < 0.0f ? t1x : t0x, -CUDART_INF_F);
  const float ny = fmaxf(r.iy < 0.0f ? t1y : t0y, -CUDART_INF_F);
  const float nz = fmaxf(r.iz < 0.0f ? t1z : t0z, -CUDART_INF_F);
  const float fx = fminf(r.ix < 0.0f ? t0x : t1x, CUDART_INF_F);
  const float fy = fminf(r.iy < 0.0f ? t0y : t1y, CUDART_INF_F);
  const float fz = fminf(r.iz < 0.0f ? t0z : t1z, CUDART_INF_F);
  entry = fmaxf(fmaxf(fmaxf(nx, ny), nz), r.tmin);
  return fminf(fminf(fminf(fx, fy), fz), best) > entry;
}

// One step of a lane's walk: an interior node (both children's boxes; the
// nearer entered, the farther pushed) or a leaf (its rows in order, a row
// kept at t < best, or at t == best from a row above brow), then the next
// pushed node still in reach. ref == kPop after it: the walk is done.
template <int kStride>
__device__ __forceinline__ void bvh_walk_step(const float4* nodes, const float4* tris,
                                              const BvhRay& r, int2* stack, int& ref, int& sp,
                                              float& best, int& brow, float& bu, float& bv) {
  if (ref > 0) {
    const float4* nd = nodes + 4 * ref;
    const float4 a0 = __ldg(nd), a1 = __ldg(nd + 1), b0 = __ldg(nd + 2), b1 = __ldg(nd + 3);
    float e0, e1;
    const bool h0 = bvh_slab(a0, a1, r, best, e0), h1 = bvh_slab(b0, b1, r, best, e1);
    const int r0 = __float_as_int(a0.w), r1 = __float_as_int(b0.w);
    const bool go0 = h0 || r0 < 0, go1 = h1 || r1 < 0;  // leaves are never culled
    if (go0 && go1) {
      const bool swap = (h1 ? e1 : CUDART_INF_F) < (h0 ? e0 : CUDART_INF_F);
      const int far = swap ? r0 : r1;
      const float far_entry = far < 0 ? -CUDART_INF_F : (swap ? e0 : e1);
      stack[sp * kStride] = make_int2(far, __float_as_int(far_entry));
      ++sp;
      ref = swap ? r1 : r0;
    } else {
      ref = go0 ? r0 : (go1 ? r1 : kPop);
    }
  } else {
    const int code = ~ref;
    const int first = code >> 4, count = code & 15;
    for (int k = 0; k < count; ++k) {
      const int row = first + k;
      const float4* T = tris + 3 * row;
      const float4 q0 = __ldg(T), q1 = __ldg(T + 1), q2 = __ldg(T + 2);
      const float ax = q0.x, ay = q0.y, az = q0.z;
      const float e1x = q0.w, e1y = q1.x, e1z = q1.y;
      const float e2x = q1.z, e2y = q1.w, e2z = q2.x;
      const float qx = r.dy * e2z - r.dz * e2y, qy = r.dz * e2x - r.dx * e2z,
                  qz = r.dx * e2y - r.dy * e2x;
      const float det = e1x * qx + e1y * qy + e1z * qz;
      if (!(fabsf(det) >= kMtEps)) continue;
      const float f = 1.0f / det;
      const float sx = r.ox - ax, sy = r.oy - ay, sz = r.oz - az;
      const float uu = f * (sx * qx + sy * qy + sz * qz);
      const float rx = sy * e1z - sz * e1y, ry = sz * e1x - sx * e1z, rz = sx * e1y - sy * e1x;
      const float vv = f * (r.dx * rx + r.dy * ry + r.dz * rz);
      const float tt = f * (e2x * rx + e2y * ry + e2z * rz);
      if (uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt >= r.tmin &&
          (tt < best || (tt == best && row > brow))) {
        best = tt, brow = row, bu = uu, bv = vv;
      }
    }
    ref = kPop;
  }
  while (ref == kPop && sp > 0) {  // the next pushed node still in reach
    --sp;
    const int2 e = stack[sp * kStride];
    if (best > __int_as_float(e.y)) ref = e.x;
  }
}

}  // namespace rt
