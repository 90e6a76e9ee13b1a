// Wavefront path-trace kernel (K4) for NVIDIA Hopper (sm_90a): one bounce
// per launch, the live rays compacted inside the launch.
//
// Replaces cs397raytracingsp22_tpu/ops/pallas/bounce.py::_make_step_kernel,
// the step kernel that path_trace_wavefront launches once per bounce, and
// the stable dead-last partition that JAX runs between the steps
// (bounce.py::_stable_partition). The wrapper
// (ops/kernels/wavefront.py::path_trace_wavefront) runs the host loop: one
// launch a bounce, no host read. Its plain version is
// path_trace_wavefront_plain (the step render/integrator.py::_bounce_update,
// the partition in torch); step_model is this launch step for step in
// torch (compact_plain: tile ranks and tile offsets in reservation order).
//
// Shape: one thread per ray runs one bounce, the body K1 runs in its loop
// (bounce.cuh::bounce_step), so the two give the same bits for a ray. The
// state of a live ray is one 64-byte row of 16 floats, read and written as
// four float4:
//   (ox oy oz dx) (dy dz tr tg) (tb rr rg rb) (uid idx alive -),
// the last three int32 bits. Rows live in two buffers: a launch reads the
// live rows of one (the first launch reads the camera rays o, d, uid
// instead) and writes the rays that stay alive into the other, compacted. A
// ray that dies writes its 12 bytes of radiance straight into the (N, 3)
// output at its caller index, so no dead row is carried on and nothing is
// un-permuted at the end; on the last launch every ray writes its radiance.
//
// Compaction in one pass. A tile is a warp's 32 rays in a scene with a
// dense mesh and a block's 128 in one without (below). A live ray's output
// position is its tile's offset plus its rank in the tile: the rank from a
// warp ballot and __popc (and in a block's tile the warps' offsets in shared
// memory), so the tile's live rays keep their order; the offset from one
// atomicAdd of the tile's live count on live[depth + 1], taken once the
// tile's bounce is done. So tiles take their places in the order they
// finish, not in tile order: the live rows are _stable_partition's,
// permuted tile by tile. Each ray's draws follow its uid, so radiance and
// segments cannot tell the orders apart. The stable order (a decoupled
// look-back over per-tile counts, Merrill & Garland 2016) was built and
// measured: a tile must wait for every earlier tile's bounce before it
// knows its offset, and that wait cost 10 ms of the bench frame and doubled
// the open teapot frame (PERF.md).
//
// Only the live tiles are walked: the grid is persistent (as many blocks as
// stay resident, from the occupancy query), and tiles are taken from an
// atomic ticket up to the live count, which the previous launch left in
// live[depth] on the device. The next ticket is taken before a tile is
// stepped, so it arrives during the bounce; a block that finds no tile
// returns before staging anything, and a block stages the scene table and
// superleaf trees once a launch, not once a tile. The tile's size follows
// the cost of a bounce. With the dense-mesh walk a bounce is long and its
// length varies from warp to warp, so each warp takes its own tiles and
// never waits at a block barrier for a sibling (bench frame 40.4 -> 30.9
// ms). Without it a bounce is cheap and the two atomics a tile (ticket,
// offset) on one word each become the limit, so a block takes 128 rays a
// tile (Cornell chunk 15.8 -> 8.9 ms). With compact = 0 every ray stays at
// its own index: the rows are updated in place, a dead row keeps alive = 0
// and is skipped, and warps add their live rays to the count. tiles[depth]
// counts the tiles each launch processed.
//
// Four instantiations: with or without the dense-mesh walk (kDense, chosen
// as K1 chooses, n_mesh > 0) and the emission-only last bounce (kLast,
// which still draws its volume uniforms and writes only radiance). The
// launch bounds hold 5 blocks an SM with the walk (K1's occupancy) and 8
// without; nvcc 12.9 allots 89 and 50 registers, no spills (PERF.md).
//
// Built with K1's flags (-fmad on), so its rows can be compared with K1's.
//
// What bounds it on the H100: the bounce itself, K1's work (the dense-mesh
// walk; see bounce.cu), and the state: 64 bytes read for every ray entering
// a bounce after the first and 64 written for every ray that lives on, 12
// bytes of radiance a ray, a few bytes of counts. A launch over 1% live rays
// walks 1% of the tiles. What it adds to K1: one launch a bounce, the
// state's bytes, and two atomics a tile; what it saves: the lanes that K1
// keeps idle in a warp once their rays have ended.

#include "bounce.cuh"

namespace {

using namespace rt;

constexpr int kThreads = 128;  // a block: one ray a thread
constexpr int kWarps = kThreads / 32;

struct Params {
  const float* o;     // (n, 3) camera rays: the first launch's input
  const float* d;     // (n, 3)
  const int* uid;     // (n,)
  const float4* src;  // (n, 4) float4 rows in: the other launches' input
  float4* dst;        // rows out (dst == src when compact == 0)
  float* rad;         // (n, 3) radiance, by caller index
  const int* live_in;  // rays entering this bounce: live[depth]
  int* live_out;       // rays entering the next: live[depth + 1]
  int* ticket;         // this launch's tile ticket
  int* tiles;          // tiles this launch processed
  int n;               // rays in the render
  int first, compact;
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

template <bool kDense, bool kLast>
__global__ void __launch_bounds__(kThreads, kDense ? 5 : 8) wavefront_kernel(const Params p) {
  // Rays a tile: with the dense-mesh walk a warp's 32, and the warps of a
  // block take tiles on their own, so no warp waits at a block barrier for
  // a sibling's long walk; without it a block's 128, where a bounce is cheap
  // and a warp's two atomics a tile would cost more than the barrier.
  constexpr int kTile = kDense ? 32 : kThreads;
  constexpr int kGroups = kThreads / kTile;  // tiles a block steps at once
  extern __shared__ __align__(16) float sm[];
  __shared__ int s_tile[kGroups], s_base;
  __shared__ int s_next[2][kGroups];  // the next tile's ticket, by the parity of the tiles walked
  __shared__ int s_warp[kWarps];      // live rays of each warp, then the warps' offsets
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = threadIdx.x / kTile;
  const bool leader = threadIdx.x % kTile == 0;
  const int n_in = p.compact ? __ldg(p.live_in) : p.n;
  const int n_tiles = (n_in + kTile - 1) / kTile;

  if (leader) s_tile[group] = atomicAdd(p.ticket, 1);
  __syncthreads();
  int tile = s_tile[group];
  if (!__syncthreads_or(tile < n_tiles)) return;  // no live tile left: nothing staged
  const float4* tree = stage_tables(sm, p.scene, p.scene_len, p.tree, p.tree_len);
  const SceneRows R = scene_rows(sm, p.n_sph, p.n_pln, p.n_tri, p.n_vol, p.n_mat, tree);

  int walked = 0;
  while (tile < n_tiles) {
    if (leader) s_next[walked & 1][group] = atomicAdd(p.ticket, 1);
    const int r = tile * kTile + threadIdx.x % kTile;
    bool valid = r < n_in;
    PathState st;
    uint32_t uid = 0;
    int idx = r;
    if (valid && p.first) {
      st.ox = p.o[3 * r]; st.oy = p.o[3 * r + 1]; st.oz = p.o[3 * r + 2];
      st.dx = p.d[3 * r]; st.dy = p.d[3 * r + 1]; st.dz = p.d[3 * r + 2];
      st.tr = 1.0f; st.tg = 1.0f; st.tb = 1.0f;
      st.rr = 0.0f; st.rg = 0.0f; st.rb = 0.0f;
      uid = (uint32_t)p.uid[r];
    } else if (valid) {
      const float4* row = p.src + 4 * (size_t)r;
      const float4 q0 = row[0], q1 = row[1], q2 = row[2], q3 = row[3];
      st.ox = q0.x; st.oy = q0.y; st.oz = q0.z; st.dx = q0.w;
      st.dy = q1.x; st.dz = q1.y; st.tr = q1.z; st.tg = q1.w;
      st.tb = q2.x; st.rr = q2.y; st.rg = q2.z; st.rb = q2.w;
      uid = __float_as_uint(q3.x);
      idx = __float_as_int(q3.y);
      valid = p.compact || __float_as_int(q3.z) != 0;
    }
    const bool on = valid && bounce_step<kDense>(p, R, uid, p.depth, kLast, st);
    if (valid && !on) {  // the ray ends here: its radiance to the caller's index
      p.rad[3 * (size_t)idx] = st.rr;
      p.rad[3 * (size_t)idx + 1] = st.rg;
      p.rad[3 * (size_t)idx + 2] = st.rb;
    }
    if (!kLast) {
      const unsigned live = __ballot_sync(0xffffffffu, on);
      const int rank = __popc(live & ((1u << lane) - 1u));  // live lanes before this one
      int pos = r;  // in place
      if (p.compact && kTile == 32) {
        const int base = lane == 0 && live ? atomicAdd(p.live_out, __popc(live)) : 0;
        pos = __shfl_sync(0xffffffffu, base, 0) + rank;
      } else if (p.compact) {
        if (lane == 0) s_warp[warp] = __popc(live);
        __syncthreads();
        if (threadIdx.x == 0) {
          int agg = 0;
          for (int w = 0; w < kWarps; ++w) {
            const int c = s_warp[w];
            s_warp[w] = agg;
            agg += c;
          }
          s_base = atomicAdd(p.live_out, agg);
        }
        __syncthreads();
        pos = s_base + s_warp[warp] + rank;
      } else if (lane == 0 && live) {
        atomicAdd(p.live_out, __popc(live));
      }
      if (p.compact ? on : valid) {
        float4* row = p.dst + 4 * (size_t)pos;
        row[0] = make_float4(st.ox, st.oy, st.oz, st.dx);
        row[1] = make_float4(st.dy, st.dz, st.tr, st.tg);
        row[2] = make_float4(st.tb, st.rr, st.rg, st.rb);
        row[3] = make_float4(__uint_as_float(uid), __int_as_float(idx),
                             __int_as_float(on ? 1 : 0), 0.0f);
      }
    }
    if (kTile == 32) {
      __syncwarp();
    } else {
      __syncthreads();  // every thread is done with this tile's shared words
    }
    tile = s_next[walked++ & 1][group];
  }
  if (leader && walked) atomicAdd(p.tiles, walked);
}

template <bool kDense, bool kLast>
cudaError_t occupancy(size_t smem, int* blocks) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(wavefront_kernel<kDense, kLast>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, wavefront_kernel<kDense, kLast>,
                                                       kThreads, smem);
}

// Launch the persistent grid: resident blocks an SM times the SMs, at most
// a block a tile of the render.
template <bool kDense, bool kLast>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = staged_bytes(p.scene_len, p.tree_len);
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = occupancy<kDense, kLast>(smem, &per_sm);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles = (p.n + kThreads - 1) / kThreads;
  const int blocks = per_sm * sms < tiles ? per_sm * sms : tiles;
  wavefront_kernel<kDense, kLast><<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch bounce `depth` of K4 on `stream`. The first launch (first = 1)
// reads the camera rays o, d, uid, the others the rows of src; rows that
// live on go to dst (compacted, or at their own index when compact = 0,
// where dst must be src after the first launch). live (depth + 1 counts,
// live[0] = n), ticket and tiles point into the render's zeroed workspace
// (ops/kernels/wavefront.py::Workspace). Returns cudaGetLastError() after
// the launch (0 on success); the caller raises on anything else.
int rt_wavefront_launch(const float* o, const float* d, const int* uid, const float* src,
                        float* dst, float* rad, int* live, int* ticket, int* tiles, int n,
                        int first, int compact, int depth, int last, unsigned k0, unsigned k1,
                        float t_min, float t_max, const float* scene, int scene_len, int n_sph,
                        int n_pln, int n_tri, int n_vol, int n_mat, int n_mesh,
                        const float* mesh_tri, const float* mesh_nrm, const float* tree,
                        int tree_len, void* stream) {
  if (n <= 0) return 0;
  Params p{o, d, uid, reinterpret_cast<const float4*>(src), reinterpret_cast<float4*>(dst),
           rad, live + depth, live + depth + 1, ticket + depth, tiles + depth, n, first,
           compact, k0, k1, depth, t_min, t_max, scene, scene_len, n_sph, n_pln, n_tri, n_vol,
           n_mat, n_mesh, reinterpret_cast<const float4*>(mesh_tri), mesh_nrm, tree, tree_len};
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (n_mesh > 0) {
    e = last ? launch<true, true>(p, s) : launch<true, false>(p, s);
  } else {
    e = last ? launch<false, true>(p, s) : launch<false, false>(p, s);
  }
  return (int)e;
}

// Registers per thread and local (spill) bytes of the instantiation for a
// scene with (dense != 0) or without dense meshes, the emission-only last
// bounce when last != 0.
int rt_wavefront_attrs(int dense, int last, int* num_regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e;
  if (dense) {
    e = last ? cudaFuncGetAttributes(&a, wavefront_kernel<true, true>)
             : cudaFuncGetAttributes(&a, wavefront_kernel<true, false>);
  } else {
    e = last ? cudaFuncGetAttributes(&a, wavefront_kernel<false, true>)
             : cudaFuncGetAttributes(&a, wavefront_kernel<false, false>);
  }
  if (e != cudaSuccess) return (int)e;
  *num_regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

// Blocks of an instantiation resident on one SM when each stages a scene
// table of `scene_len` floats and superleaf trees of `tree_len` floats: the
// persistent grid's blocks an SM.
int rt_wavefront_occupancy(int dense, int last, int scene_len, int tree_len, int* blocks) {
  const size_t smem = staged_bytes(scene_len, tree_len);
  cudaError_t e;
  if (dense) {
    e = last ? occupancy<true, true>(smem, blocks) : occupancy<true, false>(smem, blocks);
  } else {
    e = last ? occupancy<false, true>(smem, blocks) : occupancy<false, false>(smem, blocks);
  }
  return (int)e;
}

}  // extern "C"
