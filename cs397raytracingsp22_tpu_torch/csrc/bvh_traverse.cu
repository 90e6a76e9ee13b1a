// Big-mesh BVH traversal kernel (K3) for NVIDIA Hopper (sm_90a).
//
// Replaces cs397raytracingsp22_tpu/ops/pallas/tri_scan_big.py::
// tri_scan_big_pallas, the TPU's nearest hit in one mesh beyond the dense
// budget (8,192 triangles). It computes what ops/bvh.py::traverse computes,
// the spec it is held to on the card: each ray's nearest Möller–Trumbore
// hit in the mesh, in object space, over the mesh's BVH (rt_bvh_build's
// median-split tree). Its plain version, step for step, is
// ops/bvh.py::traverse_packed.
//
// The TPU kernel scanned the whole mesh in 1,024-triangle pieces with
// piece- and superleaf-box culling, because per-ray gathers and divergent
// loops were slow on its vector unit. On SIMT hardware the reference's
// log-n traversal is the natural shape again, so those tables are not
// ported: a thread walks a ray down the BVH.
//
// Layout (models/scene.py::mesh_kernel_tables, ops/bvh.py::pack_bvh):
// - nodes: the same tree, one 64-byte row per interior node holding both
//   children as [lo.xyz, ref, hi.xyz, 0], read as four 16-byte loads issued
//   together; ref is the child's row (>= 1) or, for a leaf, ~(first row << 4
//   | count). Row 0 holds the root.
// - tris: the 48-byte rows [a, e1, e2, 0, 0, 0] of tri_verts in BVH order,
//   edges formed in float32 as traverse forms them: three 16-byte loads.
//
// The walk: at an interior node both children take the slab test against
// [t_min, best t]; the nearer is entered and the farther pushed with its
// entry onto a per-thread stack in shared memory (depth = the tree's, from
// the host). A pushed node is re-culled when popped (dropped unless best t
// > its entry: the slab test against the best t of that moment). The step
// is bvh_walk.cuh::bvh_walk_step, which the mega-bounce kernel (K1) runs
// too, for a big mesh of a scene it takes.
//
// Why it returns the threaded walk's winner (traverse visits nodes in
// preorder, left child first, and skips a subtree whose box fails):
// - leaves are never culled by their own box (geometry.rs:95-97: flat
//   axis-aligned leaves would fail the strict test); the box only orders
//   the two children. So a leaf is reached whenever its parent is entered,
//   as in the threaded walk;
// - interior boxes use traverse's slab formula, NaN lanes (0·inf on a
//   face) washed to ±inf by fmaxf/fminf, and a strict `>`. The running best
//   only ever falls towards the final t, and the test passes for a larger
//   best whenever it passes for a smaller one, so every box that holds the
//   winner is entered by both walks. The exception is where MT and the
//   slab test round apart: a hit can land an ulp before its own box's
//   entry, and a walk that already holds a best between the two culls that
//   box. Both walks then return a hit within an ulp of t, but not the same
//   triangle (a ray on the edge two triangles share; PERF.md counts them);
// - MT rejects |det| < 1e-4, divides exactly, in traverse's operation
//   order (-fmad=false, ops/kernels/_build.py::EXTRA_FLAGS). Leaves meet
//   the rows in increasing order in preorder (pack_bvh checks it), so the
//   threaded walk's `<=` keeps the largest row among equal t; this walk
//   keeps it by accepting t < best || (t == best && row > best row);
// - a dead ray (t_max = 0 < t_min) fails the root box and is done.
//
// What bounds it on the H100, and what the design does about it: the work
// is small (the threaded walk's box and triangle tests bound it at
// 0.157 ms for 4,194,304 rays aimed at the 32k teapot, FP32), so the time
// goes to latency and divergence: each step is a chain of dependent loads,
// and a warp runs as long as its longest lane. Against that:
// - four or three 16-byte loads per node or triangle, issued together,
//   where the threaded kernel made up to 9 dependent scalar loads;
// - the ordered walk tightens best t early, so fewer boxes and triangles
//   are tested;
// - a screen first: a kernel of a thread a ray tests the root box and
//   writes the misses (most camera rays) at once. A warp whose rays inside
//   form a packet (two or more, origins within 1/16 of the root box's size
//   and unit directions within 1/16 of the first one's: camera rays) walks
//   them itself, since their walks differ little; any other warp lists its
//   rays inside, in ray order;
// - the listed rays' walk in persistent blocks (as many as stay resident)
//   whose warps take them from a global counter, kBatch (32) at a time,
//   and give a new ray to each idle lane once kRefill (8) lanes are idle:
//   lanes that finish early work on instead of waiting for the warp's
//   longest walk, which scattered rays (later bounces, rays aimed at the
//   mesh) make long. Small batches keep the warps even when few rays are
//   listed;
// - the two overlap: a screen block lists its rays before it walks its
//   packets, and the walk is a programmatic launch that starts once every
//   screen block has listed. A phase ends with its longest walk (up to
//   ~200 steps of dependent loads); one after the other, the two tails
//   added up (PERF.md's variant table);
// - occupancy: the stacks (14 entries of 8 B a thread for the 32k teapot)
//   are all the shared memory a block of either kernel needs. Staging the
//   top of the tree in shared memory as well cost resident blocks and was
//   slower than reading it through L1 (PERF.md's variant table).
// Tensor cores have no role: box tests are min/max of differences, not
// products, and the P5 probe (tools/bench_mxu_scan.py) found an mma.sync
// triangle scan only 1.14x the scalar one.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "bvh_walk.cuh"

namespace {

using namespace rt;

constexpr int kThreads = 256;                  // a block of either kernel
constexpr int kBatch = 32;                     // rays a warp takes from the counter at once
constexpr int kRefill = 8;                     // idle lanes that send a warp for new rays
constexpr float kCoherent = 1.0f / 16.0f;      // a packet's spread: directions, origins / box
constexpr int kPacket = 2;                     // rays inside the root box that make a packet
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* o;      // (N, 3) object-space origins
  const float* d;      // (N, 3) object-space directions (not renormalised)
  const float* t_min;  // (N,)
  const float* t_max;  // (N,)
  int n;
  const float4* nodes;  // (rows, 4) child-pair rows, row 0 the root
  int depth;            // stack entries a thread
  const float4* tris;   // (NT, 3) [a, e1, e2, 0, 0, 0] in BVH order
  int* counts;          // [rays the walk has taken, rays listed, screen blocks that
                        // have listed theirs], zeroed first
  int screen_blocks;
  int* inside;          // (N,) the listed rays, in screen order
  unsigned char* hit;
  float* t;
  int* tri;
  float* u;
  float* v;
};

__device__ __forceinline__ void load_ray(const Params& p, int i, BvhRay& r) {
  r.ox = p.o[3 * i], r.oy = p.o[3 * i + 1], r.oz = p.o[3 * i + 2];
  r.dx = p.d[3 * i], r.dy = p.d[3 * i + 1], r.dz = p.d[3 * i + 2];
  r.ix = 1.0f / r.dx, r.iy = 1.0f / r.dy, r.iz = 1.0f / r.dz;
  r.tmin = p.t_min[i];
}

__device__ __forceinline__ void store_hit(const Params& p, int i, int row, float t, float u,
                                          float v) {
  p.hit[i] = row >= 0 ? 1 : 0;
  p.t[i] = t;
  p.tri[i] = row;
  p.u[i] = u;
  p.v[i] = v;
}

// The screen: a thread tests one ray against the root box (an interior
// root; a leaf root lets every ray in). A miss is written at once. A warp
// whose rays inside form a packet (at least kPacket, origins and unit
// directions within kCoherent of its first such ray's) walks them itself;
// any other warp appends its rays inside to p.inside, in ray order, for
// the persistent walk.
__global__ void __launch_bounds__(kThreads) bvh_screen_kernel(const Params p) {
  extern __shared__ int2 smem[];
  int2* stack = smem + threadIdx.x;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  const float4 root_lo = __ldg(p.nodes), root_hi = __ldg(p.nodes + 1);
  bool in = false;
  BvhRay r{};
  float t_max = 0.0f;
  if (i < p.n) {
    load_ray(p, i, r);
    t_max = p.t_max[i];
    float entry;
    in = __float_as_int(root_lo.w) < 0 || bvh_slab(root_lo, root_hi, r, t_max, entry);
    if (!in) store_hit(p, i, -1, t_max, 0.0f, 0.0f);
  }
  const unsigned ins = __ballot_sync(kFull, in);
  const float len = rsqrtf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz);
  const float nx = r.dx * len, ny = r.dy * len, nz = r.dz * len;
  const int lead = __ffs(ins) - 1;
  const float size = fmaxf(fmaxf(root_hi.x - root_lo.x, root_hi.y - root_lo.y),
                           root_hi.z - root_lo.z);
  const float lox = __shfl_sync(kFull, r.ox, lead), loy = __shfl_sync(kFull, r.oy, lead),
              loz = __shfl_sync(kFull, r.oz, lead);
  const float lnx = __shfl_sync(kFull, nx, lead), lny = __shfl_sync(kFull, ny, lead),
              lnz = __shfl_sync(kFull, nz, lead);
  const bool near = !in || (fabsf(r.ox - lox) <= kCoherent * size &&
                            fabsf(r.oy - loy) <= kCoherent * size &&
                            fabsf(r.oz - loz) <= kCoherent * size && fabsf(nx - lnx) <= kCoherent &&
                            fabsf(ny - lny) <= kCoherent && fabsf(nz - lnz) <= kCoherent);
  const bool here = ins != 0u && __popc(ins) >= kPacket && __all_sync(kFull, near);
  if (ins != 0u && !here) {
    int base = 0;
    if ((threadIdx.x & 31) == 0) base = atomicAdd(p.counts + 1, __popc(ins));
    base = __shfl_sync(kFull, base, 0);
    if (in) p.inside[base + __popc(ins & below)] = i;
  }
  // The block's list is complete: count it, then let the walk start (its
  // programmatic launch starts it once every screen block has got here), so
  // that the packets' walks below run beside the listed rays' walk.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(p.counts + 2, 1);
  asm volatile("griddepcontrol.launch_dependents;");
  if (!here || !in) return;
  int ref = __float_as_int(root_lo.w), sp = 0, brow = -1;
  float best = t_max, bu = 0.0f, bv = 0.0f;
  do {
    bvh_walk_step<kThreads>(p.nodes, p.tris, r, stack, ref, sp, best, brow, bu, bv);
  } while (ref != kPop);
  store_hit(p, i, brow, best, bu, bv);
}

// The walk of the listed rays, in persistent blocks.
__global__ void __launch_bounds__(kThreads) bvh_traverse_kernel(const Params p) {
  extern __shared__ int2 smem[];
  // this thread's stack: entry k (ref, entry bits) at stack[k * kThreads]
  int2* stack = smem + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int root = __float_as_int(__ldg(p.nodes).w);
  if (threadIdx.x == 0) {
    // Every screen block has listed its rays before this grid starts; the
    // count, read here, orders the lists before this block's reads of them
    // (it never spins long: a stuck count traps rather than hangs).
    const volatile int* done = p.counts + 2;
    for (long long spin = 0; *done < p.screen_blocks; ++spin) {
      if (spin > (1ll << 24)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
  const int n_inside = *static_cast<const volatile int*>(p.counts + 1);

  int next = 0, end = 0;  // the warp's batch of p.inside not yet handed out (warp-uniform)
  bool drained = false;   // the batches have passed n_inside (warp-uniform)
  int idx = -1;           // the lane's ray, -1 when idle
  int ref = kPop, sp = 0, brow = -1;
  float best = 0.0f, bu = 0.0f, bv = 0.0f;
  BvhRay r{};

  while (true) {
    // idle lanes take the next rays of the warp's batch
    unsigned need = __ballot_sync(kFull, idx < 0);
    while (need != 0u && !drained) {
      if (next >= end) {
        int base = 0;
        if (lane == 0) base = atomicAdd(p.counts, kBatch);
        base = __shfl_sync(kFull, base, 0);
        if (base >= n_inside) {
          drained = true;
          break;
        }
        next = base;
        end = min(base + kBatch, n_inside);
      }
      const int rank = __popc(need & below);
      const int take = min(__popc(need), end - next);
      if (((need >> lane) & 1u) && rank < take) {
        idx = p.inside[next + rank];
        load_ray(p, idx, r);
        best = p.t_max[idx], bu = 0.0f, bv = 0.0f, brow = -1, sp = 0, ref = root;
      }
      next += take;
      need = __ballot_sync(kFull, idx < 0);
    }
    if (need == kFull) return;  // drained, and every lane is idle

    // walk until enough lanes are idle to take new rays (once drained,
    // until every lane is done)
    while (true) {
      if (idx >= 0) {
        bvh_walk_step<kThreads>(p.nodes, p.tris, r, stack, ref, sp, best, brow, bu, bv);
        if (ref == kPop) {
          store_hit(p, idx, brow, best, bu, bv);
          idx = -1;
        }
      }
      const unsigned idle = __ballot_sync(kFull, idx < 0);
      if (idle == kFull || (!drained && __popc(idle) >= kRefill)) break;
    }
  }
}

// dynamic shared memory of a block of either kernel: the stacks
size_t smem_bytes(int depth) { return static_cast<size_t>(kThreads) * depth * sizeof(int2); }

// resident blocks of the walk an SM at stack `depth` (0 when none fits)
int blocks_per_sm(int depth) {
  if (cudaFuncSetAttribute(bvh_traverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_bytes(depth))) != cudaSuccess ||
      cudaFuncSetAttribute(bvh_screen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_bytes(depth))) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bvh_traverse_kernel, kThreads,
                                                    smem_bytes(depth)) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return blocks;
}

}  // namespace

extern "C" {

// The launch's shape for stack `depth`: shared bytes a block, resident
// blocks an SM, threads a block.
int rt_bvh_traverse_config(int depth, int* smem, int* blocks, int* threads) {
  *smem = static_cast<int>(smem_bytes(depth));
  *blocks = blocks_per_sm(depth);
  *threads = kThreads;
  return *blocks > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

// Launch K3 on `stream`: the screen over every ray (which walks the
// packets), then, programmatically, the walk of the listed rays in as many
// blocks as stay resident (no more than the rays need). scratch holds
// n + 3 ints. Returns the first CUDA error of the launches (0 on success);
// the caller raises on anything else.
int rt_bvh_traverse_launch(const float* o, const float* d, const float* t_min,
                           const float* t_max, int n, const float* nodes, int depth,
                           const float* tris, int* scratch, unsigned char* hit, float* t, int* tri,
                           float* u, float* v, void* stream) {
  if (n <= 0) return 0;
  const int per_sm = blocks_per_sm(depth);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int screen_blocks = (n + kThreads - 1) / kThreads;
  const int blocks = per_sm * sms < screen_blocks ? per_sm * sms : screen_blocks;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(scratch, 0, 3 * sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  Params p{o, d, t_min, t_max, n, reinterpret_cast<const float4*>(nodes), depth,
           reinterpret_cast<const float4*>(tris), scratch, screen_blocks, scratch + 3,
           hit, t, tri, u, v};
  bvh_screen_kernel<<<screen_blocks, kThreads, smem_bytes(depth), s>>>(p);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(depth);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t l = cudaLaunchKernelEx(&cfg, bvh_traverse_kernel, p);
  if (l != cudaSuccess) return static_cast<int>(l);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread and local (spill) bytes of the compiled kernels:
// the larger of the screen's and the walk's.
int rt_bvh_traverse_attrs(int* num_regs, int* local_bytes) {
  cudaFuncAttributes a, b;
  cudaError_t e = cudaFuncGetAttributes(&a, bvh_traverse_kernel);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&b, bvh_screen_kernel);
  if (e != cudaSuccess) return (int)e;
  *num_regs = a.numRegs > b.numRegs ? a.numRegs : b.numRegs;
  *local_bytes = (int)(a.localSizeBytes > b.localSizeBytes ? a.localSizeBytes : b.localSizeBytes);
  return 0;
}

}  // extern "C"
