// Baldwin–Weber nearest-hit scan probe P5 for NVIDIA Hopper (sm_90a): the
// same scan on the SIMT cores and on the tensor cores.
//
// Replaces the JAX package's tools/bench_mxu_scan.py::scalar_kernel and
// ::mxu_kernel. Each ray's nearest hit over G triangles given as
// Baldwin–Weber rows (models/scene.py::baldwin_weber_rows, 12 floats a
// triangle: n, n·a, ū, -ū·a, v̄, -v̄·a). Per ray and triangle:
//     den = n·d,  num = n·a - n·o,  t = num * rcp(den)
//     u = ū·(o + t d) - ū·a,  v = v̄·(o + t d) - v̄·a
// rejected when u, v, 1 - u - v or t - 1e-3 is negative (sign bits ORed)
// or |den| < 1e-4 (by the bits), and the key is the least candidate
// over the triangles, from the bits of 1e9:
//   bw_scalar_kernel: candidate = bits(t), as scalar_kernel;
//   bw_mma_kernel:    candidate = (bits(t) & -4096) | triangle index, as
//                     mxu_kernel (t keeps 11 mantissa bits).
// The reciprocal is MUFU's approximate one (rcp.approx.ftz.f32), as the
// TPU kernels' pl.reciprocal(approx=True) is an approximation. The plain
// versions beside them are ops/kernels/bw_scan.py::bw_scan_plain (exact
// reciprocal) and ::bw_mma_plain (optionally with the inputs rounded to
// TF32 as the tensor cores see them).
//
// bw_scalar_kernel: one thread a ray, the rows in shared memory (uniform
// broadcast reads), a loop over the triangles in the JAX kernel's
// operation order. Bound: FP32 issue, 34 operations a test.
//
// bw_mma_kernel: mma.sync.aligned.m16n8k4 in TF32 (1×TF32: inputs rounded
// with cvt.rna, products summed in f32), with fragments written by hand.
// A is a 16-triangle set of one of six coefficient tiles, num, u0, v0 from
// [o; 1] and den, ud, vd from [d; 0]; B holds 8 rays; K = 4 is the shape's
// own depth. (m16n8k8 with K padded to 8 needed zero registers beside each
// A pair, and nvcc rebuilt that quad with four register moves before every
// HMMA.) The six A tiles share one layout, so each thread's four
// accumulator elements of every tile belong to the same (triangle, ray)
// pairs: triangles g and g + 8 of the set (g = lane / 4), rays 2 (lane % 4)
// and 2 (lane % 4) + 1 of the tile. The reject test, the key and a running
// min then run on those registers; a shuffle-min over the 8 lanes that
// share a ray column finishes. A warp takes 32 rays (4 tiles of 8) and
// reads each set's A fragments once from shared memory, where the block
// stages them already rounded and in fragment order. Bound: the 9 FP32
// operations of the epilogue a test on the SIMT cores (the products'
// 48 operations a test at 495 TFLOP/s take less).
//
// Built with -fmad on: a rate probe, held to its plain versions by
// tolerance, not by bits.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kScalarThreads = 256;
constexpr int kWarps = 4;       // mma kernel: warps a block
constexpr int kRaysWarp = 32;   // 4 tiles of 8 rays
constexpr int kTiles = kRaysWarp / 8;
constexpr int kGroup = 64;      // the JAX layout's triangles a group (GSTEP)
constexpr float kTmin = 1e-3f;
constexpr int kEpsBits = 0x38D1B717;  // bits of 1e-4f
constexpr int kFarBits = 0x4E6E6B28;  // bits of 1e9f

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ int bits(float x) { return __float_as_int(x); }

// The reject word: negative when the candidate is rejected.
__device__ __forceinline__ int reject(float t, float u, float v, float den) {
  int rej = (bits(u) | bits(v)) | (bits((1.0f - u) - v) | bits(t - kTmin));
  return rej | ((bits(den) & 0x7FFFFFFF) - kEpsBits);
}

// bw: (g, 12) rows; o, d: (3, n) planes. key: (n,) int32.
__global__ void __launch_bounds__(kScalarThreads)
    bw_scalar_kernel(const float* __restrict__ bw, int g, const float* __restrict__ o,
                     const float* __restrict__ d, int n, int* __restrict__ key) {
  extern __shared__ float s_bw[];
  for (int i = threadIdx.x; i < g * 12; i += kScalarThreads) s_bw[i] = bw[i];
  __syncthreads();
  const int r = blockIdx.x * kScalarThreads + threadIdx.x;
  if (r >= n) return;
  const float ox = o[r], oy = o[n + r], oz = o[2 * n + r];
  const float dx = d[r], dy = d[n + r], dz = d[2 * n + r];
  int best = kFarBits;
#pragma unroll 16
  for (int i = 0; i < g; ++i) {
    const float* b = s_bw + 12 * i;
    const float b0 = b[0], b1 = b[1], b2 = b[2];
    const float den = b0 * dx + b1 * dy + b2 * dz;
    const float num = b[3] - (b0 * ox + b1 * oy + b2 * oz);
    const float t = num * rcp_approx(den);
    const float px = ox + t * dx, py = oy + t * dy, pz = oz + t * dz;
    const float u = b[4] * px + b[5] * py + b[6] * pz + b[7];
    const float v = b[8] * px + b[9] * py + b[10] * pz + b[11];
    const int cand = reject(t, u, v, den) < 0 ? INT_MAX : bits(t);
    best = min(best, cand);
  }
  key[r] = best;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// D = A (16 × 4) × B (4 × 8), in f32: a0 = A[grp][tig], a1 = A[grp + 8][tig],
// b0 = B[tig][grp]; D's four elements as described above.
__device__ __forceinline__ void mma_k4(uint32_t a0, uint32_t a1, uint32_t b0, float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%7, %7, %7, %7};"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0), "f"(0.0f));
}

// lhs_o, lhs_d: (3g, 4) in the JAX tool's layout (per group of 64
// triangles: 64 num (or den) rows, 64 u0 (ud) rows, 64 v0 (vd) rows);
// o4 = [o; 1], d4 = [d; 0]: (4, n). key: (n,) int32.
__global__ void __launch_bounds__(kWarps * 32)
    bw_mma_kernel(const float* __restrict__ lhs_o, const float* __restrict__ lhs_d, int g,
                  const float* __restrict__ o4, const float* __restrict__ d4, int n,
                  int* __restrict__ key) {
  // s_a[(set * 6 + tile) * 32 + lane] = (A[g'][c], A[g' + 8][c]) rounded to
  // TF32, g' = set * 16 + lane / 4, c = lane % 4: lane's a0 and a1
  extern __shared__ uint2 s_a[];
  const int n_sets = g / 16;
  for (int i = threadIdx.x; i < n_sets * 6 * 32; i += kWarps * 32) {
    const int lane = i % 32, tile = (i / 32) % 6, set = i / (32 * 6);
    const float* src = tile < 3 ? lhs_o : lhs_d;
    const int kind = tile % 3, c = lane % 4;
    uint32_t a[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tri = set * 16 + lane / 4 + 8 * h;
      const int row = 3 * kGroup * (tri / kGroup) + kind * kGroup + tri % kGroup;
      a[h] = tf32(src[4 * row + c]);
    }
    s_a[i] = make_uint2(a[0], a[1]);
  }
  __syncthreads();

  const int lane = threadIdx.x % 32, grp = lane / 4, tig = lane % 4;
  const int base = (blockIdx.x * kWarps + threadIdx.x / 32) * kRaysWarp;
  uint32_t bo[kTiles], bd[kTiles];
  int kmin[kTiles][2];
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const int r = base + 8 * j + grp;  // B column grp holds ray r; row tig its component
    bo[j] = r < n ? tf32(o4[tig * n + r]) : 0u;
    bd[j] = r < n ? tf32(d4[tig * n + r]) : 0u;
    kmin[j][0] = kmin[j][1] = kFarBits;
  }
  for (int set = 0; set < n_sets; ++set) {
    uint2 a[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) a[k] = s_a[(set * 6 + k) * 32 + lane];
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      float num[4], u0[4], v0[4], den[4], ud[4], vd[4];
      mma_k4(a[0].x, a[0].y, bo[j], num);
      mma_k4(a[1].x, a[1].y, bo[j], u0);
      mma_k4(a[2].x, a[2].y, bo[j], v0);
      mma_k4(a[3].x, a[3].y, bd[j], den);
      mma_k4(a[4].x, a[4].y, bd[j], ud);
      mma_k4(a[5].x, a[5].y, bd[j], vd);
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // element e: triangle grp + 8 (e / 2), ray 2 tig + e % 2
        const float t = num[e] * rcp_approx(den[e]);
        const float u = u0[e] + t * ud[e];
        const float v = v0[e] + t * vd[e];
        const int tri = set * 16 + grp + 8 * (e / 2);
        const int cand = reject(t, u, v, den[e]) < 0 ? INT_MAX : ((bits(t) & -4096) | tri);
        kmin[j][e % 2] = min(kmin[j][e % 2], cand);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      int m = kmin[j][c];
      m = min(m, __shfl_xor_sync(0xFFFFFFFFu, m, 4));
      m = min(m, __shfl_xor_sync(0xFFFFFFFFu, m, 8));
      m = min(m, __shfl_xor_sync(0xFFFFFFFFu, m, 16));
      const int r = base + 8 * j + 2 * tig + c;
      if (grp == 0 && r < n) key[r] = m;
    }
  }
}

}  // namespace

extern "C" {

// Launch the scalar scan on `stream`: bw (g, 12), o and d (3, n) planes,
// key (n,). g: a multiple of 16, at most 4096. Returns cudaGetLastError()
// after the launch (0 on success).
int rt_bw_scalar_launch(const float* bw, int g, const float* o, const float* d, int n, int* key,
                        void* stream) {
  if (g <= 0 || g % 16 != 0 || g > 4096) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int smem = g * 12 * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(bw_scalar_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  bw_scalar_kernel<<<(n + kScalarThreads - 1) / kScalarThreads, kScalarThreads, smem,
                     (cudaStream_t)stream>>>(bw, g, o, d, n, key);
  return (int)cudaGetLastError();
}

// Launch the mma scan on `stream`: lhs_o, lhs_d (3g, 4), o4, d4 (4, n), key
// (n,). g: a multiple of 64, at most 2048. Returns cudaGetLastError() after
// the launch (0 on success).
int rt_bw_mma_launch(const float* lhs_o, const float* lhs_d, int g, const float* o4,
                     const float* d4, int n, int* key, void* stream) {
  if (g <= 0 || g % kGroup != 0 || g > 2048) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int smem = (g / 16) * 6 * 32 * (int)sizeof(uint2);
  cudaError_t e = cudaFuncSetAttribute(bw_mma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int rays_block = kWarps * kRaysWarp;
  bw_mma_kernel<<<(n + rays_block - 1) / rays_block, kWarps * 32, smem,
                  (cudaStream_t)stream>>>(lhs_o, lhs_d, g, o4, d4, n, key);
  return (int)cudaGetLastError();
}

// Registers per thread and local (spill) bytes: mma = 0 the scalar
// kernel, 1 the mma kernel.
int rt_bw_attrs(int mma, int* num_regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e = mma ? cudaFuncGetAttributes(&a, bw_mma_kernel)
                      : cudaFuncGetAttributes(&a, bw_scalar_kernel);
  if (e != cudaSuccess) return (int)e;
  *num_regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

}  // extern "C"
