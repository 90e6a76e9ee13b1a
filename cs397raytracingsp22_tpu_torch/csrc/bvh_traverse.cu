// Big-mesh BVH traversal kernel (K3) for NVIDIA Hopper (sm_90a).
//
// Replaces cs397raytracingsp22_tpu/ops/pallas/tri_scan_big.py::
// tri_scan_big_pallas, the TPU's nearest hit in one mesh beyond the dense
// budget (8,192 triangles). It computes what ops/bvh.py::traverse computes,
// the plain version beside it (ops/kernels/tri_scan_big.py): each ray's
// nearest Möller–Trumbore hit in the mesh, in object space, by a stackless
// walk of the mesh's threaded skip-link BVH (models/scene.py builds it with
// rt_bvh_build; node i + 1 is the first child, skip[i] the next node after
// the subtree, NN the end).
//
// The TPU kernel scanned the whole mesh in 1,024-triangle pieces with
// piece- and superleaf-box culling and a root-box window clamp
// (pack_big_tables, intersect.py:648-679), because per-ray gathers and
// divergent loops were slow on its vector unit. On SIMT hardware the
// reference's log-n traversal is the natural shape again, so those tables
// are not ported: one thread walks one ray down the BVH.
//
// Semantics kept from the spec (ops/bvh.py::traverse):
// - interior nodes take the slab test against [t_min, best t], with NaN
//   lanes (0·inf on a face) washed to ±inf by fmaxf/fminf as Rust's
//   f32::max/min do, and a strict `>`; a leaf skips the box test
//   (geometry.rs:95-97) and moves on to skip[node] after its triangles;
// - MT rejects |det| < 1e-4 and divides exactly, and accepts t in
//   [t_min, best t]: `<=`, so a later triangle at an equal t wins (the
//   merge with the other classes uses strict `<`, intersect.py:684);
// - a dead ray (t_max = 0 < t_min) fails the root box and is done at once.
// Built with -fmad=false (ops/kernels/_build.py::EXTRA_FLAGS): every
// multiply and add rounds on its own, as in the plain version's separate
// torch kernels, whose formulas and operation order this file follows.
//
// What bounds it on the H100, and what the design does about it: the walk
// is a chain of dependent loads (node, then its box or triangles), so it is
// bound by load latency and warp divergence rather than by FP32 throughput or
// bandwidth (the ~0.6 MB of nodes and ~1.2 MB of triangles of a
// 32k-triangle mesh stay in the 50 MB L2). Node arrays and triangle
// corners are read through __ldg (the read-only path). Rays that already
// hit something nearer come with a smaller t_max and cull more. The rays
// arrive in the executor's order, unsorted: a warp runs as long as its
// longest walk, which on incoherent rays that hit the mesh keeps it far
// from its bound; a coherence sort paid less than it cost on the scenes
// measured so far (PERF.md).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr float kMtEps = 1e-4f;

struct Params {
  const float* o;      // (N, 3) object-space origins
  const float* d;      // (N, 3) object-space directions (not renormalised)
  const float* t_min;  // (N,)
  const float* t_max;  // (N,)
  int n;
  const float* bmin;        // (NN, 3)
  const float* bmax;        // (NN, 3)
  const int* skip;          // (NN,)
  const int* leaf_start;    // (NN,) -1 for an interior node
  const int* leaf_count;    // (NN,)
  int nn;
  const float* tri_verts;   // (NT, 9) corners a, b, c in BVH order
  unsigned char* hit;
  float* t;
  int* tri;
  float* u;
  float* v;
};

__global__ void __launch_bounds__(kThreads) bvh_traverse_kernel(const Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const float ox = p.o[3 * i], oy = p.o[3 * i + 1], oz = p.o[3 * i + 2];
  const float dx = p.d[3 * i], dy = p.d[3 * i + 1], dz = p.d[3 * i + 2];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  const float tmin = p.t_min[i];
  float best = p.t_max[i], bu = 0.0f, bv = 0.0f;
  int btri = -1;

  int node = 0;
  while (node < p.nn) {
    const int ls = __ldg(p.leaf_start + node);
    if (ls >= 0) {
      const int lc = __ldg(p.leaf_count + node);
      for (int k = 0; k < lc; ++k) {
        const float* T = p.tri_verts + 9 * (ls + k);
        const float ax = __ldg(T + 0), ay = __ldg(T + 1), az = __ldg(T + 2);
        const float e1x = __ldg(T + 3) - ax, e1y = __ldg(T + 4) - ay, e1z = __ldg(T + 5) - az;
        const float e2x = __ldg(T + 6) - ax, e2y = __ldg(T + 7) - ay, e2z = __ldg(T + 8) - az;
        const float qx = dy * e2z - dz * e2y, qy = dz * e2x - dx * e2z, qz = dx * e2y - dy * e2x;
        const float det = e1x * qx + e1y * qy + e1z * qz;
        if (!(fabsf(det) >= kMtEps)) continue;
        const float f = 1.0f / det;
        const float sx = ox - ax, sy = oy - ay, sz = oz - az;
        const float u = f * (sx * qx + sy * qy + sz * qz);
        const float rx = sy * e1z - sz * e1y, ry = sz * e1x - sx * e1z, rz = sx * e1y - sy * e1x;
        const float v = f * (dx * rx + dy * ry + dz * rz);
        const float t = f * (e2x * rx + e2y * ry + e2z * rz);
        if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= tmin && t <= best) {
          best = t; btri = ls + k; bu = u; bv = v;
        }
      }
      node = __ldg(p.skip + node);
      continue;
    }
    const float* lo3 = p.bmin + 3 * node;
    const float* hi3 = p.bmax + 3 * node;
    const float t0x = (__ldg(lo3 + 0) - ox) * ix, t1x = (__ldg(hi3 + 0) - ox) * ix;
    const float t0y = (__ldg(lo3 + 1) - oy) * iy, t1y = (__ldg(hi3 + 1) - oy) * iy;
    const float t0z = (__ldg(lo3 + 2) - oz) * iz, t1z = (__ldg(hi3 + 2) - oz) * iz;
    // near / far per axis by the sign of 1/d; NaN washed to -inf / +inf
    const float nxa = fmaxf(ix < 0.0f ? t1x : t0x, -CUDART_INF_F);
    const float nya = fmaxf(iy < 0.0f ? t1y : t0y, -CUDART_INF_F);
    const float nza = fmaxf(iz < 0.0f ? t1z : t0z, -CUDART_INF_F);
    const float fxa = fminf(ix < 0.0f ? t0x : t1x, CUDART_INF_F);
    const float fya = fminf(iy < 0.0f ? t0y : t1y, CUDART_INF_F);
    const float fza = fminf(iz < 0.0f ? t0z : t1z, CUDART_INF_F);
    const float lo = fmaxf(fmaxf(fmaxf(nxa, nya), nza), tmin);
    const float hi = fminf(fminf(fminf(fxa, fya), fza), best);
    node = hi > lo ? node + 1 : __ldg(p.skip + node);
  }
  p.hit[i] = btri >= 0 ? 1 : 0;
  p.t[i] = best;
  p.tri[i] = btri;
  p.u[i] = bu;
  p.v[i] = bv;
}

}  // namespace

extern "C" {

// Launch K3 on `stream`. Returns cudaGetLastError() after the launch (0 on
// success); the caller raises on anything else.
int rt_bvh_traverse_launch(const float* o, const float* d, const float* t_min,
                           const float* t_max, int n, const float* bmin, const float* bmax,
                           const int* skip, const int* leaf_start, const int* leaf_count, int nn,
                           const float* tri_verts, unsigned char* hit, float* t, int* tri,
                           float* u, float* v, void* stream) {
  if (n <= 0) return 0;
  Params p{o, d, t_min, t_max, n, bmin, bmax, skip, leaf_start, leaf_count, nn, tri_verts,
           hit, t, tri, u, v};
  const int blocks = (n + kThreads - 1) / kThreads;
  bvh_traverse_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Registers per thread and local (spill) bytes of the compiled kernel.
int rt_bvh_traverse_attrs(int* num_regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, bvh_traverse_kernel);
  if (e != cudaSuccess) return (int)e;
  *num_regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

}  // extern "C"
