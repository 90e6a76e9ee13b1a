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
// What bounds it on the H100, and what the design does about it: FP32 issue,
// 53 operations per ray and triangle (rays × triangles × 53 over 67
// TFLOP/s; 4,194,304 rays against 6,144 triangles is 20.4 ms). One thread
// per ray keeps its ray and running best in registers and loops over the
// rows; all threads of a warp read the same row at the same time, so the
// nine __ldg loads of a row are broadcasts from L1/L2 (a mesh at the dense
// limit, 8,192 × 36 B = 295 KB, stays in L2). The rows are not staged into
// shared memory: a broadcast load costs the same there, and the table can
// exceed a block's 227 KB.

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
  const float* tri;    // (T, 9) [a, e1, e2]
  int nt;
  unsigned char* hit;
  float* t;
  int* tri_id;
  float* u;
  float* v;
};

__global__ void __launch_bounds__(kThreads) tri_scan_kernel(const Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const float ox = p.o[3 * i], oy = p.o[3 * i + 1], oz = p.o[3 * i + 2];
  const float dx = p.d[3 * i], dy = p.d[3 * i + 1], dz = p.d[3 * i + 2];
  const float tmin = p.t_min[i];
  float best = p.t_max[i], bu = 0.0f, bv = 0.0f;
  int bid = -1;

#pragma unroll 4
  for (int k = 0; k < p.nt; ++k) {
    const float* T = p.tri + 9 * k;
    const float ax = __ldg(T + 0), ay = __ldg(T + 1), az = __ldg(T + 2);
    const float e1x = __ldg(T + 3), e1y = __ldg(T + 4), e1z = __ldg(T + 5);
    const float e2x = __ldg(T + 6), e2y = __ldg(T + 7), e2z = __ldg(T + 8);
    const float qx = dy * e2z - dz * e2y, qy = dz * e2x - dx * e2z, qz = dx * e2y - dy * e2x;
    const float det = e1x * qx + e1y * qy + e1z * qz;
    const float f = 1.0f / det;
    const float sx = ox - ax, sy = oy - ay, sz = oz - az;
    const float u = f * (sx * qx + sy * qy + sz * qz);
    const float rx = sy * e1z - sz * e1y, ry = sz * e1x - sx * e1z, rz = sx * e1y - sy * e1x;
    const float v = f * (dx * rx + dy * ry + dz * rz);
    const float t = f * (e2x * rx + e2y * ry + e2z * rz);
    if (fabsf(det) >= kMtEps && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= tmin &&
        t < best) {
      best = t; bid = k; bu = u; bv = v;
    }
  }
  p.hit[i] = bid >= 0 ? 1 : 0;
  p.t[i] = bid >= 0 ? best : CUDART_INF_F;
  p.tri_id[i] = bid;
  p.u[i] = bu;
  p.v[i] = bv;
}

}  // namespace

extern "C" {

// Launch K5 on `stream`. Returns cudaGetLastError() after the launch (0 on
// success); the caller raises on anything else.
int rt_tri_scan_launch(const float* o, const float* d, const float* t_min, const float* t_max,
                       int n, const float* tri, int nt, unsigned char* hit, float* t,
                       int* tri_id, float* u, float* v, void* stream) {
  if (n <= 0) return 0;
  Params p{o, d, t_min, t_max, n, tri, nt, hit, t, tri_id, u, v};
  const int blocks = (n + kThreads - 1) / kThreads;
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
