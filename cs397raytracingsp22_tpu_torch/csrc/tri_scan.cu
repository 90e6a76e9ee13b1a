// Dense single-mesh triangle scan kernel (K5) for NVIDIA Hopper (sm_90a).
//
// Replaces cs397raytracingsp22_tpu/ops/pallas/tri_scan.py::tri_scan_pallas:
// each ray's nearest Möller–Trumbore hit over every row of one mesh's
// tri_table (T, 9) [a, e1 = b - a, e2 = c - a], in object space. The plain
// version beside it is ops/kernels/tri_scan.py::tri_scan_plain, the same
// test on the same rows; ops/intersect.py::intersect_mesh calls this kernel
// for the dense meshes of CUDA tensors.
//
// Semantics kept from the TPU kernel: no culling, every row is tested; a
// running best with a strict `<` that starts at the ray's t_max, so the
// earliest row wins ties and a hit needs t < t_max; MT rejects |det| <
// 1e-4 (geometry.rs:335) and divides exactly, and needs u >= 0, v >= 0,
// u + v <= 1 and t >= t_min. A ray without a hit gets t = inf, tri = -1,
// u = v = 0. Built with -fmad=false (ops/kernels/_build.py::EXTRA_FLAGS):
// every multiply and add rounds on its own, in the plain version's
// operation order, so a row can match it bit for bit.
//
// Layout: the rows come as tri_table4 (models/scene.py::
// mesh_kernel_tables), tri_table's rows padded to 48 bytes [a, e1, e2, 0,
// 0, 0], so a row is three 16-byte loads.
//
// What bounds it on the H100, and what the design does about it: FP32
// issue. A test is 53 FP32 operations (rays × rows × 53 over 67 TFLOP/s is
// the row's bound), but without contraction each is an instruction of its
// own, the exact division several more, and the H100 issues 128 lanes of
// instructions an SM a clock: the SASS count of a test over that rate is
// the issue floor that chip_smoke.py prints beside the bound. Against it:
// - loads off that path. The previous kernel read each row as nine scalar
//   uniform __ldg in every thread, about 4.2 FMA issue slots a load by the
//   P3 probe (tools/vpu_peak_smem.py). Here a block stages tiles of
//   kTile rows into shared memory with cp.async, double-buffered, and
//   each thread holds kRays rays in registers and tests every row, read
//   by three 16-byte shared-memory broadcasts, against all of them: 3 /
//   kRays loads a test. A block reads the whole table from L2 once
//   (4,194,304 rays × 6,144 rows: 8,192 blocks × 295 KB = 2.4 GB, well
//   under a millisecond of L2 traffic);
// - fewer instructions a test: det, s·q and d·r come first, and a test
//   whose |det| < 1e-4, or whose u or v is surely negative, ends before the
//   division (about nine tests in ten on camera rays). "Surely": the
//   numerator and a finite det differ in sign and the numerator is at
//   least 2^-20, so f · numerator cannot round to -0 for any f = 1/det the
//   division could give (|f| >= 2.9e-39). The rows that pass compute u, v,
//   t from the same values in the same order, so every output is the bit
//   the full test gives.
// Tensor cores are not used: the test's exact division and its rounding
// order have no matrix form, and the P5 probe (tools/bench_mxu_scan.py)
// found an mma.sync scan of the Baldwin–Weber form (which moves winners
// near edges) only 1.14x the scalar one.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRays = 4;    // rays a thread
constexpr int kTile = 128;  // rows a stage
constexpr float kMtEps = 1e-4f;
// |x| at which f * x cannot round to zero for any f = 1 / det of a finite
// det (|f| >= 2.9e-39): 2^-20 * 2.9e-39 > 2^-149, the least subnormal
constexpr float kNoUnderflow = 0x1p-20f;

// u = f * su (or v = f * sv) is negative, whatever f = 1 / det rounds to,
// when su and a finite det differ in sign and su is too large for the
// product to round to -0: then the test fails without the division
__device__ __forceinline__ bool surely_negative(float su, float det) {
  return ((__float_as_uint(su) ^ __float_as_uint(det)) >> 31) && fabsf(su) >= kNoUnderflow &&
         fabsf(det) < CUDART_INF_F;
}

struct Params {
  const float* o;      // (N, 3) object-space origins
  const float* d;      // (N, 3) object-space directions (not renormalised)
  const float* t_min;  // (N,)
  const float* t_max;  // (N,)
  int n;
  const float4* tri;   // (T, 3) [a, e1, e2, 0, 0, 0]
  int nt;
  unsigned char* hit;
  float* t;
  int* tri_id;
  float* u;
  float* v;
};

__device__ __forceinline__ void stage(float4* dst, const float4* src, int rows) {
  for (int i = threadIdx.x; i < 3 * rows; i += kThreads) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src + i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kThreads) tri_scan_kernel(const Params p) {
  __shared__ float4 tiles[2][3 * kTile];
  const int base = blockIdx.x * kThreads * kRays + threadIdx.x;
  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float tmin[kRays], best[kRays], bu[kRays], bv[kRays];
  int bid[kRays];
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const int i = base + j * kThreads;
    const bool in = i < p.n;  // a ray past the end takes no hit and is not written
    ox[j] = in ? p.o[3 * i] : 0.0f, oy[j] = in ? p.o[3 * i + 1] : 0.0f;
    oz[j] = in ? p.o[3 * i + 2] : 0.0f;
    dx[j] = in ? p.d[3 * i] : 0.0f, dy[j] = in ? p.d[3 * i + 1] : 0.0f;
    dz[j] = in ? p.d[3 * i + 2] : 0.0f;
    tmin[j] = in ? p.t_min[i] : CUDART_INF_F;
    best[j] = in ? p.t_max[i] : 0.0f;
    bu[j] = 0.0f, bv[j] = 0.0f, bid[j] = -1;
  }

  const int n_tiles = (p.nt + kTile - 1) / kTile;
  stage(tiles[0], p.tri, min(kTile, p.nt));
  for (int k = 0; k < n_tiles; ++k) {
    const int row0 = k * kTile;
    const int rows = min(kTile, p.nt - row0);
    if (k + 1 < n_tiles) {
      stage(tiles[(k + 1) & 1], p.tri + 3 * (row0 + kTile), min(kTile, p.nt - row0 - kTile));
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float4* tile = tiles[k & 1];
#pragma unroll 1
    for (int r = 0; r < rows; ++r) {
      const float4 q0 = tile[3 * r], q1 = tile[3 * r + 1], q2 = tile[3 * r + 2];
      const float ax = q0.x, ay = q0.y, az = q0.z;
      const float e1x = q0.w, e1y = q1.x, e1z = q1.y;
      const float e2x = q1.z, e2y = q1.w, e2z = q2.x;
      const int row = row0 + r;
#pragma unroll
      for (int j = 0; j < kRays; ++j) {
        const float qx = dy[j] * e2z - dz[j] * e2y, qy = dz[j] * e2x - dx[j] * e2z,
                    qz = dx[j] * e2y - dy[j] * e2x;
        const float det = e1x * qx + e1y * qy + e1z * qz;
        const float sx = ox[j] - ax, sy = oy[j] - ay, sz = oz[j] - az;
        const float su = sx * qx + sy * qy + sz * qz;
        const float rx = sy * e1z - sz * e1y, ry = sz * e1x - sx * e1z, rz = sx * e1y - sy * e1x;
        const float sv = dx[j] * rx + dy[j] * ry + dz[j] * rz;
        if (!(fabsf(det) >= kMtEps) || surely_negative(su, det) || surely_negative(sv, det)) {
          continue;  // the test fails whatever the division gives
        }
        const float f = 1.0f / det;
        const float u = f * su;
        const float v = f * sv;
        const float t = f * (e2x * rx + e2y * ry + e2z * rz);
        if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= tmin[j] && t < best[j]) {
          best[j] = t, bid[j] = row, bu[j] = u, bv[j] = v;
        }
      }
    }
    __syncthreads();  // the next stage overwrites this tile
  }
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const int i = base + j * kThreads;
    if (i >= p.n) continue;
    p.hit[i] = bid[j] >= 0 ? 1 : 0;
    p.t[i] = bid[j] >= 0 ? best[j] : CUDART_INF_F;
    p.tri_id[i] = bid[j];
    p.u[i] = bu[j];
    p.v[i] = bv[j];
  }
}

}  // namespace

extern "C" {

// Launch K5 on `stream`. Returns cudaGetLastError() after the launch (0 on
// success); the caller raises on anything else.
int rt_tri_scan_launch(const float* o, const float* d, const float* t_min, const float* t_max,
                       int n, const float* tri4, int nt, unsigned char* hit, float* t,
                       int* tri_id, float* u, float* v, void* stream) {
  if (n <= 0) return 0;
  Params p{o, d, t_min, t_max, n, reinterpret_cast<const float4*>(tri4), nt, hit, t, tri_id, u, v};
  const int blocks = (n + kThreads * kRays - 1) / (kThreads * kRays);
  tri_scan_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Registers per thread and local (spill) bytes of the compiled kernel.
int rt_tri_scan_attrs(int* num_regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, tri_scan_kernel);
  if (e != cudaSuccess) return (int)e;
  *num_regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

}  // extern "C"
