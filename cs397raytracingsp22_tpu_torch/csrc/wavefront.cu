// Wavefront path-trace kernel (K4) for NVIDIA Hopper (sm_90a): one bounce
// per launch.
//
// Replaces cs397raytracingsp22_tpu/ops/pallas/bounce.py::_make_step_kernel,
// the step kernel that path_trace_wavefront launches once per bounce. The
// wrapper (ops/kernels/wavefront.py::path_trace_wavefront) runs the host
// loop: per bounce one launch of this kernel, then, between bounces, a
// stable dead-last partition of the ray state in torch (JAX
// bounce.py::_stable_partition, also outside the TPU kernel). Its plain
// version is the same loop with render/integrator.py::_bounce_update as
// the step.
//
// Shape: one thread per ray runs one bounce, the body K1 runs in its loop
// (bounce.cuh::bounce_step), so the two give the same bits for a ray. The
// state lives in device memory between launches, one 64-byte row a ray of
// 16 floats read and written as four float4:
//   (ox oy oz dx) (dy dz tr tg) (tb rr rg rb) (uid idx - -),
// uid and the caller's index stored as int32 bits; `alive` is a separate
// int32 array, so the partition's prefix sum reads 4 bytes a ray. The row
// is updated in place. A thread whose ray is dead returns at once, and a
// block whose rays are all dead returns before staging the scene table
// (__syncthreads_or: the TPU kernel's pl.when(any_alive) block skip); after
// the partition the dead rays sit at the tail, so whole warps and blocks
// leave together. The launch covers the full width with no host read of
// the live count. The `last` variant (template flag) adds emission only, as
// K1's last bounce, still drawing the volume uniforms, and writes back only
// the radiance and alive.
//
// Built with K1's flags (-fmad on), so its rows can be compared with K1's.
//
// What bounds it on the H100, and what the design does about it: the same
// dense-mesh walk as K1 (bounce.cu), plus what the wavefront adds: 64
// bytes a live ray read and 48 written per launch, 4 bytes of `alive` read
// a ray, the scene table and superleaf trees staged once per launch and
// block, and one launch per bounce. Compaction pays only where many rays
// die before the last bounce; on the scenes measured so far over 99% live
// to the end (PERF.md), so this kernel costs more than K1 there.

#include "bounce.cuh"

namespace {

using namespace rt;

constexpr int kThreads = 128;

struct Params {
  float4* rows;  // (N, 4) float4: the state rows above
  int* alive;    // (N,) 1 live, 0 dead
  int n;
  uint32_t k0, k1;
  int depth;  // this bounce's index (RNG site SITE_BOUNCE0 + depth)
  float t_min, t_max;
  const float* scene;
  int scene_len;
  int n_sph, n_pln, n_tri, n_vol, n_mat, n_mesh;
  const float4* mesh_tri;  // (TT, 3) float4: kmesh_tri4 [a, e1, e2, 0, 0, 0]
  const float* mesh_nrm;  // (TT, 9) decoded corner normals n0 n1 n2
  const float* tree;      // (nodes, 8) superleaf trees [lo, 0, hi, 0]
  int tree_len;           // floats of tree
};

template <bool kLast>
__global__ void __launch_bounds__(kThreads, 4) wavefront_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < p.n && p.alive[i] != 0;
  if (!__syncthreads_or(live)) return;  // a block of dead rays skips the bounce
  const float4* tree = stage_tables(sm, p.scene, p.scene_len, p.tree, p.tree_len);
  if (!live) return;

  const SceneRows R = scene_rows(sm, p.n_sph, p.n_pln, p.n_tri, p.n_vol, p.n_mat, tree);
  float4* row = p.rows + 4 * (size_t)i;
  const float4 q0 = row[0], q1 = row[1], q2 = row[2];
  const uint32_t uid = __float_as_uint(reinterpret_cast<const float*>(row)[12]);
  PathState st;
  st.ox = q0.x; st.oy = q0.y; st.oz = q0.z; st.dx = q0.w;
  st.dy = q1.x; st.dz = q1.y; st.tr = q1.z; st.tg = q1.w;
  st.tb = q2.x; st.rr = q2.y; st.rg = q2.z; st.rb = q2.w;

  const bool on = bounce_step(p, R, uid, p.depth, kLast, st);

  if (!kLast) {
    row[0] = make_float4(st.ox, st.oy, st.oz, st.dx);
    row[1] = make_float4(st.dy, st.dz, st.tr, st.tg);
  }
  row[2] = make_float4(st.tb, st.rr, st.rg, st.rb);
  p.alive[i] = on ? 1 : 0;
}

template <bool kLast>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(wavefront_kernel<kLast>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (p.n + kThreads - 1) / kThreads;
  wavefront_kernel<kLast><<<blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one bounce of K4 on `stream` over n rays (rows and alive updated
// in place). Returns cudaGetLastError() after the launch (0 on success);
// the caller raises on anything else.
int rt_wavefront_launch(float* rows, int* alive, int n, int depth, int last, unsigned k0,
                        unsigned k1, float t_min, float t_max, const float* scene,
                        int scene_len, int n_sph, int n_pln, int n_tri, int n_vol, int n_mat,
                        int n_mesh, const float* mesh_tri, const float* mesh_nrm,
                        const float* tree, int tree_len, void* stream) {
  if (n <= 0) return 0;
  Params p{reinterpret_cast<float4*>(rows), alive, n, k0, k1, depth, t_min, t_max, scene,
           scene_len, n_sph, n_pln, n_tri, n_vol, n_mat, n_mesh,
           reinterpret_cast<const float4*>(mesh_tri), mesh_nrm, tree,
           tree_len};
  const size_t smem = staged_bytes(scene_len, tree_len);
  return last ? launch<true>(p, smem, (cudaStream_t)stream)
              : launch<false>(p, smem, (cudaStream_t)stream);
}

// Registers per thread and local (spill) bytes of the compiled kernel
// (last = 1: the emission-only variant).
int rt_wavefront_attrs(int last, int* num_regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e = last ? cudaFuncGetAttributes(&a, wavefront_kernel<true>)
                       : cudaFuncGetAttributes(&a, wavefront_kernel<false>);
  if (e != cudaSuccess) return (int)e;
  *num_regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

}  // extern "C"
