// Mega-bounce path-trace kernel (K1) for NVIDIA Hopper (sm_90a).
//
// Replaces cs397raytracingsp22_tpu/ops/pallas/bounce.py::path_trace_pallas
// (the Pallas TPU kernel built by _make_kernel / _build_bounce). It computes
// what render/integrator.py::path_trace computes — the plain version beside
// it is cs397raytracingsp22_tpu_torch/render/integrator.py::path_trace —
// for scenes that pass scene_is_simple: spheres, planes, standalone
// triangles, sphere-bounded volumes, and dense meshes or one mesh past the
// dense budget (a big mesh) with an explicit material.
//
// Shape: one thread per ray runs every bounce in a loop. Origin,
// direction, throughput, radiance and the segment count stay in
// registers, so device memory sees the camera rays once and the radiance
// and per-ray segment count once. The body of the loop is bounce.cuh::
// bounce_step, which the wavefront kernel (K4, wavefront.cu) runs one
// bounce per launch: the analytic scan (spheres, planes, triangles,
// volumes with free flight) against a running nearest hit, the walk of each
// dense mesh's superleaf tree with Möller–Trumbore on the superleaves it
// reaches, the winner resolve,
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
// - The dense-mesh scan. A flat scan tested every 16-triangle superleaf box
//   of the mesh on every segment (384 for the 6,144-triangle teapot), each
//   box 6 scalar __ldg: 95% of the counted operations and, with the leaf
//   scans, 108 ms of a 512² x 64 spp frame. The scan now walks a binary tree
//   over those boxes (intersect.cuh::scan_dense_mesh), staged into shared
//   memory beside the scene table, one node two 16-byte loads: a segment
//   whose running best lies before the mesh's box tests the root alone, one
//   that reaches the mesh tests the path to each superleaf it enters. The
//   walk scans the same superleaves in the same order as the flat scan, so
//   the rows keep their bits.
// - The superleaf scans. What is left is divergence: a ray leaving the
//   teapot's surface reaches ~4-5 overlapping superleaves, so one lane of a
//   warp often holds most of its warp's leaves, and a leaf scanned on its
//   own lane idles the other 31 for 16 Möller–Trumbore tests. The whole warp
//   scans each reached leaf together (16 lanes, one row each; two warp
//   reductions pick the least t, the lowest row on ties): 46 ms a frame
//   became 32 ms (PERF.md). The rows (kmesh_tri4, 295 KB) stay in device
//   memory, three 16-byte __ldg a row.
// - Divergence from dead rays: a ray that misses leaves the loop and its
//   lanes idle while the warp's other rays bounce on. On the scenes
//   measured so far this costs little: 99.29% of the bench frame's rays
//   and 99.00% of the Cornell box's are still alive entering the last
//   bounce (PERF.md). The wavefront kernel K4 (wavefront.cu) runs the same
//   bounce_step one bounce per launch and compacts the live rays inside each
//   launch: 0.90x this kernel's time on the bench frame, 1.45x on the Cornell
//   chunk, 0.45x on the open teapot frame, where most rays escape early
//   (PERF.md).
// - Occupancy: the whole path state plus the scan's running hit, the
//   walk's node and a leaf's broadcast ray are live together.
//   __launch_bounds__(128, 4) caps the kernel at 128 registers; nvcc 12.9
//   allots 87 with no spills, so 5 blocks of 128 threads (20 warps) fit an
//   SM. Each block stages the scene's analytic and material tables (a few
//   hundred bytes) and the superleaf trees (2S - 1 nodes of 32 bytes for S
//   superleaves: 24,544 B for the teapot, at most 32,736 B under the dense
//   budget). Capped at 64 registers (32 warps) the kernel spills 128 B and
//   runs ~18% faster (PERF.md); it stays spill-free. A scene without a
//   dense mesh launches bounce_kernel<false>, which leaves the walk out and
//   keeps the registers, and occupancy, of the kernel before it.
//   chip_smoke.py prints the resident blocks (rt_bounce_occupancy) and
//   fails on spills or on registers beyond 96, the most that keeps 5
//   blocks.
// - Many spheres. A scene of SPHERE_TREE_MIN (64) spheres or more has a
//   sphere tree (models/scene.py::sphere_tree) and launches
//   bounce_kernel<kDense, true>, which walks it (intersect.cuh::
//   walk_spheres) in place of the sphere scan: on the final scene of The
//   Next Week (1,006 spheres) the scan tested every sphere on every
//   segment, the walk ~30 nodes and ~15 spheres (PERF.md). Each block
//   stages the tree's header and nodes (64 B a leaf of 4 spheres) after
//   the superleaf trees in place of the table's sphere rows; the resolve
//   reads the winner's row, and the walk a leaf's slots and indices, from
//   device memory. Staging the slots too cost 2.6% on that scene's chunk
//   (6.03 against 5.88 ms; the table then took 3 blocks' room less), so
//   they stay in device memory (L1). The walk's registers (101 under
//   __launch_bounds__(128, 4)) kept 4 blocks an SM; the tree
//   instantiations take (128, 5): 96 registers, no spills, 5 blocks, 10%
//   faster (5.29 ms).
// - Big meshes. A mesh past the dense budget (8,192 triangles) has no
//   superleaf tree: its tree would pass what a block stages. A scene with
//   one (and no dense mesh and no sphere tree beside it) launches
//   bounce_kernel_big, which walks the big mesh's BVH
//   (intersect.cuh::walk_big_mesh): the child-pair rows and triangle rows
//   that the big-mesh kernel K3 walks (MeshBlock.bvh_nodes, bvh_tri4), read
//   from device memory through __ldg, by the ordered walk that K3 runs
//   (bvh_walk.cuh::bvh_walk_step), one lane a ray, nearer child first, with
//   a stack of the tree's depth a thread in shared memory after the mesh's
//   staged kmesh_xfm row.
//   The resolve reads the winner's corner normals from kmesh_res. So K1
//   adds no table of its own for them, and the staged path's tables stay
//   as they are. The walk is per lane: a warp runs as long as its longest
//   walk (PERF.md, PR 21).

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
  const float4* mesh_tri;  // (TT, 3) float4: kmesh_tri4 [a, e1, e2, 0, 0, 0]
  const float* mesh_nrm;  // (TT, 9) decoded corner normals n0 n1 n2
  const float* tree;      // (nodes, 8) superleaf trees [lo, 0, hi, 0]
  int tree_len;           // floats of tree
  const float4* sph_table;  // ksph_tree: header, nodes, slots, indices
  int sph_leaves;           // its leaves; 0: no sphere tree
  const float4* big_xfm;    // the big mesh's kmesh_xfm row (9 float4)
  const float* big_res;     // kmesh_res: per triangle [corner normals, uvs, tangent]
  const float4* big_nodes;  // the big mesh's bvh_nodes
  const float4* big_tris;   // and bvh_tri4
  int big_depth;            // stack entries a thread: its BVH's depth; 0: no big mesh
  static constexpr int kStackStride = kThreads;  // a thread's stack entries kThreads apart
};

// The path of ray i of a block that staged the tables, every bounce in a
// loop. kDense: the scene has a dense mesh (the walk is compiled in).
// kSphTree: the scene has a sphere tree; its header and nodes are staged
// after the superleaf trees in place of the scene table's sphere rows,
// which the resolve reads from device memory. kBig: the scene has a big
// mesh; its kmesh_xfm row is staged after the superleaf trees, and each
// thread's stack for its walk after that.
template <bool kDense, bool kSphTree, bool kBig>
__device__ __forceinline__ void trace_paths(const Params& p, float* sm) {
  const int skip = kSphTree ? kSph * p.n_sph : 0;
  const float4* tree = stage_tables(sm, p.scene + skip, p.scene_len - skip, p.tree, p.tree_len,
                                    kBig ? p.big_xfm : p.sph_table,
                                    kBig ? 9 : (kSphTree ? 4 * p.sph_leaves : 0));

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p.n) {
    SceneRows R = scene_rows(sm, kSphTree ? 0 : p.n_sph, p.n_pln, p.n_tri, p.n_vol, p.n_mat, tree);
    if (kSphTree) {
      R.sph = p.scene;
      R.sph_tree = tree + p.tree_len / 4;
    }

    PathState st;
    st.ox = p.o[3 * i]; st.oy = p.o[3 * i + 1]; st.oz = p.o[3 * i + 2];
    st.dx = p.d[3 * i]; st.dy = p.d[3 * i + 1]; st.dz = p.d[3 * i + 2];
    st.tr = 1.0f; st.tg = 1.0f; st.tb = 1.0f;
    st.rr = 0.0f; st.rg = 0.0f; st.rb = 0.0f;
    int segs = 0;
    const uint32_t uid = (uint32_t)p.uid[i];

    for (int depth = 0; depth < p.depth; ++depth) {
      ++segs;
      if (!bounce_step<kDense, kSphTree, kBig>(p, R, uid, depth, depth == p.depth - 1, st)) break;
    }

    p.rad[3 * i] = st.rr;
    p.rad[3 * i + 1] = st.rg;
    p.rad[3 * i + 2] = st.rb;
    p.segs[i] = segs;
  }
}

template <bool kDense, bool kSphTree>
__global__ void __launch_bounds__(kThreads, kSphTree ? 5 : 4) bounce_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];
  trace_paths<kDense, kSphTree, false>(p, sm);
}

// A scene with one big mesh, no dense mesh and no sphere tree: the big
// mesh's BVH walk after the analytic classes.
__global__ void __launch_bounds__(kThreads, 4) bounce_kernel_big(const Params p) {
  extern __shared__ __align__(16) float sm[];
  trace_paths<false, false, true>(p, sm);
}

// Bytes of shared memory a block stages: staged_bytes without a sphere
// tree; with one, the scene table less its sphere rows, the superleaf
// trees, and the sphere tree's header and nodes (4 float4 a leaf); with a
// big mesh (big_depth > 0), staged_bytes, its kmesh_xfm row (144 B) and
// the threads' stacks (8 B an entry).
size_t k1_staged_bytes(int scene_len, int tree_len, int n_sph, int sph_leaves, int big_depth) {
  if (big_depth > 0) {
    return staged_bytes(scene_len, tree_len) + 144 + sizeof(int2) * kThreads * (size_t)big_depth;
  }
  if (sph_leaves == 0) return staged_bytes(scene_len, tree_len);
  return sph_tree_staged_bytes(scene_len, tree_len, kSph * n_sph, sph_leaves);
}

template <class Kernel>
cudaError_t prepare_one(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The instantiation for a scene with (dense) or without dense meshes and
// with (sph_tree) or without a sphere tree, or for one with a big mesh (big:
// then neither), its dynamic shared memory allowed up to `smem` bytes;
// `fn` receives the kernel.
template <class Fn>
cudaError_t with_kernel(bool dense, bool sph_tree, bool big, size_t smem, Fn fn) {
  const auto run = [&](auto kernel) {
    const cudaError_t e = prepare_one(kernel, smem);
    return e != cudaSuccess ? e : fn(kernel);
  };
  if (big) return run(bounce_kernel_big);
  if (dense && sph_tree) return run(bounce_kernel<true, true>);
  if (dense) return run(bounce_kernel<true, false>);
  if (sph_tree) return run(bounce_kernel<false, true>);
  return run(bounce_kernel<false, false>);
}

}  // namespace

extern "C" {

// Launch K1 on `stream`. big_depth > 0: the scene has a big mesh (and no
// dense mesh or sphere tree), whose tables the big_ pointers give. Returns
// cudaGetLastError() after the launch (0 on success); the caller raises on
// anything else.
int rt_bounce_launch(const float* o, const float* d, const int* uid, int n, float* rad,
                     int* segs, unsigned k0, unsigned k1, int depth, float t_min,
                     float t_max, const float* scene, int scene_len, int n_sph, int n_pln,
                     int n_tri, int n_vol, int n_mat, int n_mesh, const float* mesh_tri,
                     const float* mesh_nrm, const float* tree, int tree_len,
                     const float* sph_table, int sph_leaves, const float* big_xfm,
                     const float* big_res, const float* big_nodes, const float* big_tris,
                     int big_depth, void* stream) {
  if (n <= 0) return 0;
  if (big_depth < 0 || (big_depth > 0 && (n_mesh > 0 || sph_leaves > 0))) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{o, d, uid, n, rad, segs, k0, k1, depth, t_min, t_max, scene, scene_len,
           n_sph, n_pln, n_tri, n_vol, n_mat, n_mesh, reinterpret_cast<const float4*>(mesh_tri),
           mesh_nrm, tree, tree_len, reinterpret_cast<const float4*>(sph_table), sph_leaves,
           reinterpret_cast<const float4*>(big_xfm), big_res,
           reinterpret_cast<const float4*>(big_nodes), reinterpret_cast<const float4*>(big_tris),
           big_depth};
  const size_t smem = k1_staged_bytes(scene_len, tree_len, n_sph, sph_leaves, big_depth);
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaError_t e = with_kernel(n_mesh > 0, sph_leaves > 0, big_depth > 0, smem, [&](auto kernel) {
    kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(p);
    return cudaGetLastError();
  });
  return (int)e;
}

// Registers per thread and local (spill) bytes of the compiled kernel for a
// scene with (dense != 0) or without dense meshes and with (sph_tree != 0)
// or without a sphere tree, or with a big mesh (big != 0: then neither).
int rt_bounce_attrs(int dense, int sph_tree, int big, int* num_regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = with_kernel(dense != 0, sph_tree != 0, big != 0, 0, [&](auto kernel) {
    return cudaFuncGetAttributes(&a, kernel);
  });
  if (e != cudaSuccess) return (int)e;
  *num_regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

// Blocks of the kernel resident on one SM when each stages the tables of a
// scene with `scene_len` and `tree_len` floats, `n_mesh` dense meshes,
// `n_sph` spheres, a sphere tree of `sph_leaves` leaves (0: none) and a
// big mesh whose walk needs `big_depth` stack entries (0: none).
int rt_bounce_occupancy(int scene_len, int tree_len, int n_mesh, int n_sph, int sph_leaves,
                        int big_depth, int* blocks) {
  const size_t smem = k1_staged_bytes(scene_len, tree_len, n_sph, sph_leaves, big_depth);
  return (int)with_kernel(n_mesh > 0, sph_leaves > 0, big_depth > 0, smem, [&](auto kernel) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, smem);
  });
}

}  // extern "C"
