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
// and per-ray segment count once. The body of the loop is bounce.cuh::
// bounce_step, which the wavefront kernel (K4, wavefront.cu) runs one
// bounce per launch: the analytic scan (spheres, planes, triangles,
// volumes with free flight) against a running nearest hit, the dense-mesh
// Möller–Trumbore scan with per-ray superleaf culling, the winner resolve,
// Threefry-2x32-20 for the bounce draws, the five-way BSDF and the
// throughput update. A miss ends the ray's loop; the last bounce
// accumulates emission only (its scatter would never be traced) but still
// draws its volume uniforms, whose counters are the spec's.
//
// Semantics kept from the spec: class order spheres → planes → triangles
// → volumes → meshes with the earliest index winning ties (strict `<`
// against the running best); mesh t stays in object space and is compared
// with world t; the plane normal flips with Rust signum; the sphere root is
// t1 when t1 >= t_min, else t2 (geometry.rs:406-410); volume free flight
// draws uniform 4+v of the bounce; a thread past the ray count does
// nothing, so padding never counts as a segment. The class tests, the
// dense-mesh scan and the analytic resolve are the device functions of
// intersect.cuh, which the scene-intersection kernel (K2) shares.
//
// Arithmetic: see bounce.cuh (Threefry bits, sincos_2pi, cbrt_fast).
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
//   lanes idle while the warp's other rays bounce on. On the scenes
//   measured so far this costs little: 99.29% of the bench frame's rays
//   and 99.00% of the Cornell box's are still alive entering the last
//   bounce (PERF.md). The wavefront kernel K4 (wavefront.cu) runs the same
//   bounce_step one bounce per launch and compacts the live rays between
//   launches; on those scenes it is 1.27x slower than this kernel.
// - Register pressure: the whole path state plus the scan's running hit is
//   live across the loop. __launch_bounds__(128, 4) caps the kernel at 128
//   registers (nvcc 12.9 allots it 64, with no spills, so 32 warps fit on
//   an SM); the scene's analytic and material tables (a few KB) sit in
//   shared memory, staged once per block, and the mesh rows (221 KB at
//   6,144 triangles) are read through __ldg from L2.

#include "bounce.cuh"

namespace {

using namespace rt;

constexpr int kThreads = 128;

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

__global__ void __launch_bounds__(kThreads, 4) bounce_kernel(const Params p) {
  extern __shared__ float sm[];
  stage_table(sm, p.scene, p.scene_len);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;

  const SceneRows R = scene_rows(sm, p.n_sph, p.n_pln, p.n_tri, p.n_vol, p.n_mat);

  PathState st;
  st.ox = p.o[3 * i]; st.oy = p.o[3 * i + 1]; st.oz = p.o[3 * i + 2];
  st.dx = p.d[3 * i]; st.dy = p.d[3 * i + 1]; st.dz = p.d[3 * i + 2];
  st.tr = 1.0f; st.tg = 1.0f; st.tb = 1.0f;
  st.rr = 0.0f; st.rg = 0.0f; st.rb = 0.0f;
  int segs = 0;
  const uint32_t uid = (uint32_t)p.uid[i];

  for (int depth = 0; depth < p.depth; ++depth) {
    ++segs;
    if (!bounce_step(p, R, uid, depth, depth == p.depth - 1, st)) break;
  }

  p.rad[3 * i] = st.rr;
  p.rad[3 * i + 1] = st.rg;
  p.rad[3 * i + 2] = st.rb;
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
