// Element-wise rate probe P4 for NVIDIA Hopper (sm_90a): bf16 against f32.
//
// Replaces the JAX package's tools/profile_split.py::main.make_k, the
// Pallas kernel that runs `iters` rounds of
//     y = y*y + c1;  y = y - y*x        (c1 = 1, y starts at x)
// over one (512, 128) block in float32 and in bfloat16. The plain version
// beside it is ops/kernels/dtype_rate.py::dtype_rate_plain.
//
// Each round is two fused multiply-adds on this card: y = fma(y, y, 1) and
// y = fma(y, -x, y), in float32 one thread an element (FFMA), in bfloat16
// one thread per pair of elements as packed __nv_bfloat162 (__hfma2, HFMA2
// in SASS: two lanes' FMAs an instruction). Both count 4 operations an
// element a round, as the JAX tool does. In float32 the plain version
// fuses the same way; in bfloat16 it rounds the multiply and the add
// apart (as XLA does), so there the two agree within 2 units in the last
// place, not bit for bit.
//
// What bounds it: issue, with one dependent chain a thread. The tool's
// shape (65,536 elements) launches 65,536 threads in f32 and 32,768 in
// bf16, a quarter and an eighth of the card's 132 × 2,048 resident
// threads, so at that shape the chain's latency, not the issue rate,
// limits it; the tool also runs a shape that fills the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ __nv_bfloat162 fma_(__nv_bfloat162 a, __nv_bfloat162 b,
                                               __nv_bfloat162 c) {
  return __hfma2(a, b, c);
}
__device__ __forceinline__ float neg_(float a) { return -a; }
__device__ __forceinline__ __nv_bfloat162 neg_(__nv_bfloat162 a) { return __hneg2(a); }
template <typename T>
__device__ __forceinline__ T one_();
template <>
__device__ __forceinline__ float one_<float>() { return 1.0f; }
template <>
__device__ __forceinline__ __nv_bfloat162 one_<__nv_bfloat162>() {
  return __float2bfloat162_rn(1.0f);
}

// T = float: one element a thread; T = __nv_bfloat162: two.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dtype_rate(const T* __restrict__ x, T* __restrict__ out, int n, int iters) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const T xv = x[i];
  const T nx = neg_(xv);
  const T one = one_<T>();
  T y = xv;
#pragma unroll 8
  for (int k = 0; k < iters; ++k) {
    y = fma_(y, y, one);
    y = fma_(y, nx, y);
  }
  out[i] = y;
}

template <typename T>
int launch(const void* x, void* out, int n, int iters, cudaStream_t s) {
  if (n <= 0) return 0;
  dtype_rate<T><<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, iters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch P4 on `stream`: bf16 = 0 runs float32 over n elements, bf16 = 1
// runs packed bfloat16 over n elements (n even; n / 2 threads). Returns
// cudaGetLastError() after the launch (0 on success).
int rt_dtype_rate_launch(const void* x, void* out, int n, int iters, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (iters < 0 || (bf16 && n % 2 != 0)) return (int)cudaErrorInvalidValue;
  return bf16 ? launch<__nv_bfloat162>(x, out, n / 2, iters, s) : launch<float>(x, out, n, iters, s);
}

// Registers per thread and local (spill) bytes of the f32 (bf16 = 0) or
// bf16 (bf16 = 1) kernel.
int rt_dtype_rate_attrs(int bf16, int* num_regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e = bf16 ? cudaFuncGetAttributes(&a, dtype_rate<__nv_bfloat162>)
                       : cudaFuncGetAttributes(&a, dtype_rate<float>);
  if (e != cudaSuccess) return (int)e;
  *num_regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

}  // extern "C"
