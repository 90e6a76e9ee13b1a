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
// Shape: one thread per ray; persistent blocks of 256 threads that stage
// the scene once; warps that take 32-ray tiles, up to half of a launch's by
// a fixed rule and the rest from a ticket. The grid is as many blocks
// as stay resident on the card (the occupancy query times the SM count;
// fewer when the rays fill fewer), computed by the wrapper
// (ops/kernels/scene_intersect.py::launch_config). Each block copies the
// scene's analytic, material and mesh-row tables (kscene, a few hundred
// bytes) and the dense meshes' superleaf trees (ksl_tree, up to a few tens
// of KB) into shared memory once, with Hopper's bulk asynchronous copy
// (cp.async.bulk global -> shared, completing on an mbarrier): one thread
// issues it, and each warp loads its first tile's rays before it waits for
// the copy to land. Warp w of the grid's W takes tiles w, w + W, ... below
// n_static; beyond, each warp draws its next tile from an atomic ticket
// while it works on the current one, so the end of the launch goes to
// whichever warp is free. Without a dense mesh every ray costs about the
// same and n_static covers every tile (no atomic). The ticket (ticket[0])
// and a count of the warps done (ticket[1]) start at zero, and the last
// warp to finish puts both back to zero, so a launch needs no memset. The
// lanes of a last, partial tile run a dead ray (an empty window), so every
// warp enters the walk whole, and store nothing. The class tests are the
// device functions of intersect.cuh, which K1 and K4 run too; the
// dense-mesh walk is K2's own variant of intersect.cuh::scan_dense_mesh
// (scan_dense_mesh_k2: the same superleaf tree and leaf order, the leaves
// a warp reaches in a step scanned two at a time), so the rows are bit for
// bit those of the earlier design, which ran the shared walk in 128-ray
// blocks that each staged the tables.
//
// The winner rules are the spec's: class order with a running
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
// A scene of SPHERE_TREE_MIN spheres or more (The Next Week's final scene:
// 1,006) launches a second kernel, scene_intersect_tree_kernel, which walks
// the scene's sphere tree with K1's device function (intersect.cuh::
// walk_spheres) in place of the sphere scan: the same rows, bit for bit
// (ties to the lowest index), for tests a ray that grow with the tree's
// depth and not with the spheres. Both kernels run one body
// (intersect_tiles); the scan's instantiations compile as before.
//
// What bounds it on the H100, and what the design does about it (PERF.md):
// - With no dense mesh (the 32k-triangle bench scene, whose teapot is a big
//   mesh), each ray does a few dozen FP32 tests and moves ~70 B of rays,
//   bounds and outputs: memory-bound. Rows are read and written once;
//   outputs are structure-of-arrays, so a warp's stores coalesce.
// - With a dense mesh, the walk: a ray tests the tree's root and the path
//   to each superleaf it reaches (2-8 nodes a lane on the measured inputs),
//   and the warp scans every superleaf its lanes reach, 2.5-18 a warp, each
//   a chain of global row loads, an exact division and warp reductions. The
//   leaf scans are the time, so K2 scans two leaves at once, 16 lanes each.
//   The earlier design also copied the trees (24-32 KB) into every 128-ray
//   block, 7-10% of a launch; here they are copied once a resident block.

#include <type_traits>

#include "intersect.cuh"

namespace {

using namespace rt;

constexpr int kThreads = 256;  // a block: eight warps, each taking its own tiles (PERF.md)
constexpr int kWarps = kThreads / 32;

struct Params {
  const float* o;      // (N, 3)
  const float* d;      // (N, 3)
  const float* t_min;  // (N,)
  const float* t_max;  // (N,)
  const float* u_vol;  // (N, u_ld): column q is volume q's free-flight uniform
  int u_ld;
  int n;
  int n_tiles;   // ceil(n / 32)
  int n_static;  // tiles taken by a fixed rule; the rest come from the ticket
  int n_warps;   // warps in the grid
  int* ticket;  // [0] tiles taken, [1] warps done: zero before and after a launch
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

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One bulk asynchronous copy of `bytes` (a multiple of 16; both addresses
// 16-byte aligned) from device memory into shared memory, completing on
// the mbarrier at `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(shared_addr(dst)), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Wait until the mbarrier at `bar` has completed its first phase.
__device__ __forceinline__ void wait_staged(uint32_t bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  }
}

// K2's walk of dense mesh m: intersect.cuh::scan_dense_mesh, whose leaves a
// warp scans two at a time. In each step every lane still walking tests one
// node, as there; then the leaves reached in the step (at most one a lane)
// are scanned in pairs, the lower 16 lanes one leaf and the upper 16 the
// next, one row a lane, so a warp pays one row's latency for two leaves. A
// ray's leaves are still scanned in its walk's order, each against its own
// running best, and the least t wins, the lowest row on ties (the lowest
// lane of the half): the rows are scan_dense_mesh's, bit for bit. Needs the
// whole warp (the kernel runs dead rays on lanes past the last ray).
__device__ __forceinline__ void scan_dense_mesh_k2(const float* X, int m, const float4* mesh_tri,
                                                   const float4* tree, float ox, float oy,
                                                   float oz, float dx, float dy, float dz,
                                                   float tmin, float tmax, Nearest& h) {
  constexpr unsigned kAll = 0xffffffffu;
  float mox, moy, moz, mdx, mdy, mdz;
  to_object(X, ox, oy, oz, dx, dy, dz, mox, moy, moz, mdx, mdy, mdz);
  const float ix = 1.0f / mdx, iy = 1.0f / mdy, iz = 1.0f / mdz;
  const int s = (int)X[37];
  const float4* nodes = tree + 2 * (2 * (int)X[36] - m - 1);  // node k at nodes[2k], nodes[2k + 1]
  const int lane = threadIdx.x & 31, half = lane >> 4, j = lane & 15;
  int k = 1;
  bool walking = true;
  do {
    int r0 = -1;  // the first row of a superleaf this lane reached in this step
    if (walking) {
      if (node_reached(nodes + 2 * k, mox, moy, moz, ix, iy, iz, tmin, fminf(h.t, tmax))) {
        if (k < s) {
          k *= 2;  // an inner node: enter its first child
        } else {
          const int top = 1 << (31 - __clz(2 * s - 1));
          r0 = (int)X[34] + 16 * (k - top + (k < top ? s : 0));
          k = (k >> (__ffs(~k) - 1)) + 1;
        }
      } else {
        k = (k >> (__ffs(~k) - 1)) + 1;  // past k's subtree
      }
      walking = k != 1;
    }
    unsigned pend = __ballot_sync(kAll, r0 >= 0);
    while (pend) {
      const int a = __ffs(pend) - 1;
      pend &= pend - 1;
      const int b = pend ? __ffs(pend) - 1 : -1;  // the pair's second leaf, if any
      pend &= pend - 1;
      const int src = half && b >= 0 ? b : a;
      const int sr0 = __shfl_sync(kAll, r0, src);
      const float sox = __shfl_sync(kAll, mox, src), soy = __shfl_sync(kAll, moy, src),
                  soz = __shfl_sync(kAll, moz, src), sdx = __shfl_sync(kAll, mdx, src),
                  sdy = __shfl_sync(kAll, mdy, src), sdz = __shfl_sync(kAll, mdz, src);
      const float stmin = __shfl_sync(kAll, tmin, src);
      const float sfar = __shfl_sync(kAll, fminf(h.t, tmax), src);
      unsigned key = 0xffffffffu;
      float bu = 0.0f, bv = 0.0f;
      float t, u, v;
      if ((half == 0 || b >= 0) &&
          mt_row(mesh_tri, sr0 + j, sox, soy, soz, sdx, sdy, sdz, stmin, sfar, t, u, v)) {
        key = ordered_key(t); bu = u; bv = v;
      }
      const unsigned ka = __reduce_min_sync(kAll, half ? 0xffffffffu : key);
      const unsigned kb = __reduce_min_sync(kAll, half ? key : 0xffffffffu);
      // the winning row of each half: its lowest lane holding the least key
      const unsigned wins = __ballot_sync(kAll, key == (half ? kb : ka) && key != 0xffffffffu);
      const int wa = __ffs(wins & 0xffffu) - 1, wb = __ffs(wins >> 16) - 1;
      const int wl = lane == b ? 16 + wb : wa;
      const float wu = __shfl_sync(kAll, bu, wl & 31), wv = __shfl_sync(kAll, bv, wl & 31);
      const unsigned kw = lane == b ? kb : ka;
      if ((lane == a || lane == b) && kw != 0xffffffffu) {
        h.t = key_value(kw); h.cls = kClsMesh; h.idx = r0 + (wl & 15); h.mesh = m;
        h.u = wu; h.v = wv;
      }
    }
  } while (__any_sync(kAll, walking));
}

// A scene of SPHERE_TREE_MIN spheres or more (models/scene.py::sphere_tree)
// launches scene_intersect_tree_kernel: these fields beside Params'.
struct TreeParams : Params {
  const float4* sph_table;  // ksph_tree: header, nodes, slots, indices
  int sph_leaves;           // its leaves G
};

// The body of both kernels. Warps take the tiles of a launch: the first
// n_static by a fixed rule (warp w of the grid's W takes tiles w, w + W,
// w + 2W, ... below n_static), the rest from the ticket, each drawn while
// the warp's current tile runs. With a dense mesh the walk's length varies
// from tile to tile, and the ticket gives the end of the launch to
// whichever warp is free; without one every ray costs about the same, and
// n_static covers every tile: one atomic a tile on one word costs more
// than it balances (PERF.md).
//
// kSphTree (scene_intersect_tree_kernel): the scene's sphere tree in place
// of its sphere scan, as K1 walks it (intersect.cuh::walk_spheres, the
// scan's (t, index) on every ray, ties to the lowest index). The block
// stages the table from its first 16-byte word past the sphere rows, then
// the superleaf trees, then the tree's header and nodes (64 B a leaf), each
// by bulk copy; the walk reads the leaves' slots and indices, and the
// resolve a sphere winner's row, from device memory. rtnw's 1,006 spheres
// take 256 leaves: 16 KiB of nodes where the rows were 20 KiB.
template <bool kWalk, bool kSphTree, class P>
__device__ __forceinline__ void intersect_tiles(const P& p, float* sm, unsigned long long* staged) {
  const int lane = threadIdx.x & 31;
  const uint32_t bar = shared_addr(staged);
  // the staged table starts at float `base` of the scene table, 16-byte
  // aligned: the sphere rows' end rounded down on the tree route
  int base = 0;
  if constexpr (kSphTree) base = (kSph * p.n_sph) & ~3;
  const int len = p.scene_len - base;
  float4* tree = reinterpret_cast<float4*>(sm + tree_offset(len));
  // The table's whole 16-byte words and the trees go by one bulk copy each;
  // the table's last 0-3 floats by plain loads.
  const int head = len & ~3;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    uint32_t bytes = 4u * (uint32_t)(head + p.tree_len);
    if constexpr (kSphTree) bytes += 64u * (uint32_t)p.sph_leaves;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
                 : "memory");
    if (head > 0) bulk_copy(sm, p.scene + base, 4u * head, bar);
    if (p.tree_len > 0) bulk_copy(tree, p.tree, 4u * p.tree_len, bar);
    if constexpr (kSphTree) {
      bulk_copy(tree + p.tree_len / 4, p.sph_table, 64u * (uint32_t)p.sph_leaves, bar);
    }
  }
  if (threadIdx.x < len - head) sm[head + threadIdx.x] = p.scene[base + head + threadIdx.x];
  __syncthreads();  // the barrier is initialised and the table's tail stored

  SceneRows R;
  if constexpr (kSphTree) {
    // the rows after the spheres, staged; the sphere rows in device memory
    R = scene_rows(sm + (kSph * p.n_sph - base), 0, p.n_pln, p.n_tri, p.n_vol, p.n_mat, tree);
    R.sph = p.scene;
    R.sph_tree = tree + p.tree_len / 4;
  } else {
    R = scene_rows(sm, p.n_sph, p.n_pln, p.n_tri, p.n_vol, p.n_mat, tree);
  }
  const bool ticketed = p.n_static < p.n_tiles;  // uniform over the launch
  int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tile >= p.n_static && ticketed) {
    tile = lane == 0 ? p.n_static + atomicAdd(p.ticket, 1) : 0;
    tile = __shfl_sync(0xffffffffu, tile, 0);
  }
  bool waited = false;
  while (tile < p.n_tiles) {
    int next = tile + p.n_warps;
    if (next >= p.n_static && ticketed) {  // drawn now, it lands during the tile
      next = lane == 0 ? p.n_static + atomicAdd(p.ticket, 1) : 0;
    }
    const int i = tile * 32 + lane;
    const bool in = i < p.n;
    // a lane past the last ray runs a dead ray: an empty window, no store
    const float ox = in ? p.o[3 * i] : 0.0f, oy = in ? p.o[3 * i + 1] : 0.0f,
                oz = in ? p.o[3 * i + 2] : 0.0f;
    const float dx = in ? p.d[3 * i] : 1.0f, dy = in ? p.d[3 * i + 1] : 1.0f,
                dz = in ? p.d[3 * i + 2] : 1.0f;
    const float tmin = in ? p.t_min[i] : 1.0f, tmax = in ? p.t_max[i] : 0.0f;
    if (!waited) {  // the first tile's rays are in flight: now the tables
      wait_staged(bar);
      waited = true;
    }

    Nearest h = nearest_none();
    const float a2 = dx * dx + dy * dy + dz * dz;
    if constexpr (kSphTree) {
      const float4* slots = p.sph_table + 4 * p.sph_leaves;  // after the header and nodes
      walk_spheres(R.sph_tree, p.sph_leaves, slots,
                   reinterpret_cast<const float*>(slots + kSphLeaf * p.sph_leaves), ox, oy, oz,
                   dx, dy, dz, a2, tmin, tmax, h);
    } else {
      scan_spheres(R.sph, p.n_sph, ox, oy, oz, dx, dy, dz, a2, tmin, tmax, h);
    }
    scan_planes(R.pln, p.n_pln, ox, oy, oz, dx, dy, dz, tmin, tmax, h);
    scan_triangles(R.tri, p.n_tri, ox, oy, oz, dx, dy, dz, tmin, tmax, h);
    const float* uq = p.u_vol + (size_t)i * p.u_ld;
    for (int q = 0; q < p.n_vol; ++q) {
      test_volume(R.vol + kVol * q, q, in ? uq[q] : 1.0f, ox, oy, oz, dx, dy, dz, a2, tmin, tmax,
                  h);
    }
    if (kWalk) {
      for (int m = 0; m < p.n_mesh; ++m) {
        scan_dense_mesh_k2(R.msh + kMesh * m, m, p.mesh_tri, R.tree, ox, oy, oz, dx, dy, dz, tmin,
                           tmax, h);
      }
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
      resolve_analytic(R, h.cls, h.idx, h.t, ox, oy, oz, dx, dy, dz, px, py, pz, nx, ny, nz, ff,
                       mid);
      t = h.t;
      code = h.cls;
      idx = h.idx;
    }
    if (in) {
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
    tile = ticketed ? __shfl_sync(0xffffffffu, next, 0) : next;
  }
  if (!waited) wait_staged(bar);  // no block leaves while its copy is in flight
  if (ticketed && lane == 0 && atomicAdd(p.ticket + 1, 1) == p.n_warps - 1) {
    // every other warp has drawn its last ticket: reset for the next launch
    p.ticket[0] = 0;
    p.ticket[1] = 0;
  }
}

template <bool kWalk>
__global__ void __launch_bounds__(kThreads) scene_intersect_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];
  __shared__ __align__(8) unsigned long long staged;  // the mbarrier of the staging copy
  intersect_tiles<kWalk, false>(p, sm, &staged);
}

template <bool kWalk>
__global__ void __launch_bounds__(kThreads) scene_intersect_tree_kernel(const TreeParams p) {
  extern __shared__ __align__(16) float sm[];
  __shared__ __align__(8) unsigned long long staged;  // the mbarrier of the staging copy
  intersect_tiles<kWalk, true>(p, sm, &staged);
}

// Bytes of shared memory a block stages: staged_bytes, or on the tree route
// (sph_leaves > 0) the table from its first 16-byte word past the n_sph
// sphere rows, the superleaf trees and the sphere tree's header and nodes.
size_t k2_staged_bytes(int scene_len, int tree_len, int n_sph, int sph_leaves) {
  if (sph_leaves == 0) return staged_bytes(scene_len, tree_len);
  return sph_tree_staged_bytes(scene_len, tree_len, (kSph * n_sph) & ~3, sph_leaves);
}

// Run fn on the kernel a scene launches: with (dense) or without the
// dense-mesh walk, with (sph_tree) or without the sphere tree; its dynamic
// shared memory raised to smem first where that passes 48 KiB.
template <class Fn>
cudaError_t with_kernel(bool dense, bool sph_tree, size_t smem, Fn fn) {
  auto run = [&](auto kernel) -> cudaError_t {
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    return fn(kernel);
  };
  if (sph_tree) {
    return dense ? run(scene_intersect_tree_kernel<true>) : run(scene_intersect_tree_kernel<false>);
  }
  return dense ? run(scene_intersect_kernel<true>) : run(scene_intersect_kernel<false>);
}

}  // namespace

extern "C" {

// Launch K2 on `stream` in `grid` blocks (launch_config: at most the
// resident blocks of the card, at least 1), the first n_static of its
// ceil(n / 32) tiles by the fixed rule and the rest from the ticket (two
// int32 on the device, zero before the launch; the kernel leaves them
// zero); with sph_leaves > 0 the sphere tree sph_table (ksph_tree, 16-byte
// aligned) in place of the sphere scan. Returns cudaGetLastError() after
// the launch (0 on success); the caller raises on anything else.
int rt_scene_intersect_launch(const float* o, const float* d, const float* t_min,
                              const float* t_max, const float* u_vol, int u_ld, int n, int grid,
                              int n_static, int* ticket, const float* scene, int scene_len,
                              int n_sph, int n_pln, int n_tri, int n_vol, int n_mat, int n_mesh,
                              const float* mesh_tri, const float* tree, int tree_len,
                              const float* sph_table, int sph_leaves, float* t, int* code,
                              int* idx, int* mat, float* u, float* v, float* normal,
                              unsigned char* ff, void* stream) {
  if (n <= 0) return 0;
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  TreeParams p{{o, d, t_min, t_max, u_vol, u_ld, n, (n + 31) / 32, n_static, grid * kWarps, ticket,
                scene, scene_len, n_sph, n_pln, n_tri, n_vol, n_mat, n_mesh,
                reinterpret_cast<const float4*>(mesh_tri), tree, tree_len, t, code, idx, mat, u,
                v, normal, ff},
               reinterpret_cast<const float4*>(sph_table), sph_leaves};
  const size_t smem = k2_staged_bytes(scene_len, tree_len, n_sph, sph_leaves);
  const cudaError_t e = with_kernel(n_mesh > 0, sph_leaves > 0, smem, [&](auto kernel) {
    if constexpr (std::is_same_v<decltype(kernel), void (*)(TreeParams)>) {
      kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
    } else {
      kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(static_cast<const Params&>(p));
    }
    return cudaSuccess;
  });
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Threads a block, and blocks resident on one SM of the instantiation a
// scene with `n_mesh` dense meshes and a sphere tree of `sph_leaves`
// leaves (0: none; n_sph spheres) launches, when each block stages a scene
// table of `scene_len` floats and superleaf trees of `tree_len` floats.
int rt_scene_intersect_occupancy(int scene_len, int tree_len, int n_mesh, int n_sph,
                                 int sph_leaves, int* blocks, int* threads) {
  const size_t smem = k2_staged_bytes(scene_len, tree_len, n_sph, sph_leaves);
  *threads = kThreads;
  return (int)with_kernel(n_mesh > 0, sph_leaves > 0, smem, [&](auto kernel) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, smem);
  });
}

// Registers per thread and local (spill) bytes of the compiled kernel for a
// scene with (dense != 0) or without dense meshes, with (sph_tree != 0) or
// without a sphere tree.
int rt_scene_intersect_attrs(int dense, int sph_tree, int* num_regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = with_kernel(dense != 0, sph_tree != 0, 0, [&](auto kernel) {
    return cudaFuncGetAttributes(&a, kernel);
  });
  if (e != cudaSuccess) return (int)e;
  *num_regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

}  // extern "C"
