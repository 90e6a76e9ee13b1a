// Scene-intersection kernel (K2) for NVIDIA Hopper (sm_90a).
//
// Replaces cs397raytracingsp22_tpu/ops/pallas/scene_intersect.py::
// scene_intersect_pallas (the Pallas TPU kernel built by its _make_kernel).
// It computes what ops/kernels/scene_intersect.py::scene_intersect_plain
// computes, the plain version beside it: one bounce's nearest hit of each
// ray over the spheres, planes, standalone triangles, sphere-bounded
// volumes (free flight drawn from the caller's per-ray uniform column) and
// dense meshes of a scene. The staged path merges big meshes (K3) and
// resolves mesh winners around it (ops/intersect.py::intersect_scene_fused).
//
// Shape: one thread per ray. The scene's analytic, material and mesh-row
// tables (kscene, a few hundred bytes) and the dense meshes' superleaf
// trees (ksl_tree, at most 32,736 B) are staged into shared memory once
// per block; the class tests and the dense-mesh walk (the superleaf tree,
// then Möller–Trumbore on the superleaves it reaches) are the device
// functions of intersect.cuh, which K1 runs too. The winner rules are the
// spec's: class order with a running
// best and strict `<`, analytic t in [t_min, t_max], mesh t < t_max
// strictly and in object space (the ray is transformed without
// renormalisation, intersect.py:287-288 in the JAX package). A ray whose
// window is empty (a dead ray carries t_max = 0 < t_min) rejects every
// candidate. Outputs: t (t_max on a miss), code (-1 miss, 0-3 the analytic
// classes, 4 + k dense mesh k), idx (class index; the mesh's own row for a
// mesh winner), mat, u, v, the front-facing normal of an analytic winner
// (zero for volume and mesh winners) and frontface.
//
// The Pallas kernel's Baldwin–Weber rows, approximate reciprocal and
// packed min-key, and the wrapper's exact re-derive of the mesh winner
// (intersect.py:597-625) were op-count tricks for the TPU's vector unit:
// here the dense scan is MT with an exact IEEE divide, as in K1, so t, u
// and v come out exact and need no re-derive. Built with -fmad=false
// (ops/kernels/_build.py::EXTRA_FLAGS): no multiply-add is contracted, so
// every operation rounds on its own as in the plain version's separate
// torch kernels, whose formulas and operation order intersect.cuh follows.
// The ray-sphere quadratic cancels when a ray starts on a sphere, and a
// contracted FMA there moved hit points by 2e-4 against the plain version.
//
// What bounds it on the H100, and what the design does about it:
// - With no dense mesh (the 32k-triangle bench scene, whose teapot is a big
//   mesh), each ray does a few dozen FP32 tests and moves ~70 B of rays,
//   bounds and outputs: memory-bound. Rows are read and written once;
//   outputs are structure-of-arrays, so a warp's stores coalesce.
// - With a dense mesh, the mesh walk, as in K1: a ray tests the tree's root,
//   and the path to each superleaf it reaches. Warp divergence follows ray
//   coherence: camera rays start coherent, later bounces less so.

#include "intersect.cuh"

namespace {

using namespace rt;

constexpr int kThreads = 128;

struct Params {
  const float* o;      // (N, 3)
  const float* d;      // (N, 3)
  const float* t_min;  // (N,)
  const float* t_max;  // (N,)
  const float* u_vol;  // (N, u_ld): column q is volume q's free-flight uniform
  int u_ld;
  int n;
  const float* scene;
  int scene_len;
  int n_sph, n_pln, n_tri, n_vol, n_mat, n_mesh;
  const float4* mesh_tri;  // (TT, 3) float4: kmesh_tri4 [a, e1, e2, 0, 0, 0]
  const float* tree;      // (nodes, 8) superleaf trees [lo, 0, hi, 0]
  int tree_len;           // floats of tree
  float* t;
  int* code;
  int* idx;
  int* mat;
  float* u;
  float* v;
  float* normal;  // (N, 3)
  unsigned char* ff;
};

__global__ void __launch_bounds__(kThreads) scene_intersect_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];
  const float4* tree = stage_tables(sm, p.scene, p.scene_len, p.tree, p.tree_len);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;

  const SceneRows R = scene_rows(sm, p.n_sph, p.n_pln, p.n_tri, p.n_vol, p.n_mat, tree);
  const float ox = p.o[3 * i], oy = p.o[3 * i + 1], oz = p.o[3 * i + 2];
  const float dx = p.d[3 * i], dy = p.d[3 * i + 1], dz = p.d[3 * i + 2];
  const float tmin = p.t_min[i], tmax = p.t_max[i];

  Nearest h = nearest_none();
  const float a2 = dx * dx + dy * dy + dz * dz;
  scan_spheres(R.sph, p.n_sph, ox, oy, oz, dx, dy, dz, a2, tmin, tmax, h);
  scan_planes(R.pln, p.n_pln, ox, oy, oz, dx, dy, dz, tmin, tmax, h);
  scan_triangles(R.tri, p.n_tri, ox, oy, oz, dx, dy, dz, tmin, tmax, h);
  const float* uq = p.u_vol + (size_t)i * p.u_ld;
  for (int q = 0; q < p.n_vol; ++q) {
    test_volume(R.vol + kVol * q, q, uq[q], ox, oy, oz, dx, dy, dz, a2, tmin, tmax, h);
  }
  for (int m = 0; m < p.n_mesh; ++m) {
    scan_dense_mesh(R.msh + kMesh * m, m, p.mesh_tri, R.tree, ox, oy, oz, dx, dy, dz, tmin, tmax, h);
  }

  float t = tmax, u = 0.0f, v = 0.0f, nx = 0.0f, ny = 0.0f, nz = 0.0f;
  int code = -1, idx = 0, mid = 0;
  bool ff = false;
  if (h.cls == kClsMesh) {
    const float* X = R.msh + kMesh * h.mesh;
    t = h.t; u = h.u; v = h.v;
    code = kClsMesh + h.mesh;
    idx = h.idx - (int)X[34];
    mid = (int)X[33];
  } else if (h.cls >= 0) {
    float px, py, pz;
    resolve_analytic(R, h.cls, h.idx, h.t, ox, oy, oz, dx, dy, dz, px, py, pz, nx, ny, nz, ff, mid);
    t = h.t;
    code = h.cls;
    idx = h.idx;
  }
  p.t[i] = t;
  p.code[i] = code;
  p.idx[i] = idx;
  p.mat[i] = mid;
  p.u[i] = u;
  p.v[i] = v;
  p.normal[3 * i] = nx;
  p.normal[3 * i + 1] = ny;
  p.normal[3 * i + 2] = nz;
  p.ff[i] = ff ? 1 : 0;
}

}  // namespace

extern "C" {

// Launch K2 on `stream`. Returns cudaGetLastError() after the launch (0 on
// success); the caller raises on anything else.
int rt_scene_intersect_launch(const float* o, const float* d, const float* t_min,
                              const float* t_max, const float* u_vol, int u_ld, int n,
                              const float* scene, int scene_len, int n_sph, int n_pln, int n_tri,
                              int n_vol, int n_mat, int n_mesh, const float* mesh_tri,
                              const float* tree, int tree_len, float* t, int* code, int* idx,
                              int* mat, float* u, float* v, float* normal, unsigned char* ff,
                              void* stream) {
  if (n <= 0) return 0;
  Params p{o, d, t_min, t_max, u_vol, u_ld, n, scene, scene_len, n_sph, n_pln, n_tri, n_vol,
           n_mat, n_mesh, reinterpret_cast<const float4*>(mesh_tri), tree, tree_len, t, code,
           idx, mat, u, v, normal, ff};
  const size_t smem = staged_bytes(scene_len, tree_len);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(scene_intersect_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  scene_intersect_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Registers per thread and local (spill) bytes of the compiled kernel.
int rt_scene_intersect_attrs(int* num_regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, scene_intersect_kernel);
  if (e != cudaSuccess) return (int)e;
  *num_regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

}  // extern "C"
