// Issue-rate probes P1, P2 and P3 for NVIDIA Hopper (sm_90a): one kernel
// template, chain<Mix, U, Coef>.
//
// Replaces the JAX package's roofline probes tools/vpu_peak.py::make_kernel
// (P1: straight-line chains), tools/vpu_peak_shape.py::make_kernel (P2: the
// FMA rate against the size of a loop body) and tools/vpu_peak_smem.py::
// make_kernel (P3: an FMA chain whose every step reads a fresh table
// coefficient). The plain versions beside it are ops/kernels/vpu_peak.py::
// chain_plain, looped_plain and table_plain.
//
// One thread per element of x (the tools' 131,072 × 128 = 16,777,216
// elements). Each thread runs 8 independent chains, started from
// x * (1 + 0.001 k), with the tools' exact expressions and constants:
//   fma   v = v*v + 0.4                        (one FFMA a step)
//   mul   v = v*v                              (one FMUL)
//   i32   v = (v & 0x7FFFFFF1) + 12345         (two integer ops)
//   both  4 chains of v*v + 0.4 and 4 of (v ^ 0x5A5A5A5) + 12345
// The i32 chains start from x truncated to int32 plus k. The f32 chains
// are summed in order, the i32 chains XORed, into out. `v*v + 0.4` is not
// affine, so no compiler can fold the chain (trap 1 of tools/vpu_peak.py).
// U rounds of the 8 chains are unrolled into the body of a `#pragma unroll
// 1` loop of `steps` iterations: P1 is steps = 1 with U = unroll, P2 the
// tool's (u, steps) pairs, P3 U = 1 with 512 steps. Coef says where the
// addend of an FMA step comes from: the constant 0.4 (kConst), or the
// table coefs[(step * U + round) * 8 + chain] of 4,096 floats, uniform
// across the warp, held in shared memory (kShared, staged once a block),
// in __constant__ memory (kConstant, copied in by the launch) or read
// through the read-only cache (kLdg).
//
// Built with -fmad=true (ops/kernels/_build.py::EXTRA_FLAGS): the FFMA is
// what the probe measures. What bounds it: issue, FP32 at 67 TFLOP/s for
// the fma mix (8 FMAs a step, 2 operations each); the integer mixes have no
// published peak. Memory moves 4 bytes in and 4 out per thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;  // one table staging per 1,024 elements
constexpr int kChains = 8;
constexpr int kTable = 4096;

enum { kFma = 0, kMul = 1, kI32 = 2, kBoth = 3 };
enum { kConst = 0, kShared = 1, kConstant = 2, kLdg = 3 };

__constant__ float c_coefs[kTable];

template <int C>
__device__ __forceinline__ float addend(const float* s, const float* __restrict__ g, int i) {
  if constexpr (C == kShared) {
    return s[i];
  } else if constexpr (C == kConstant) {
    return c_coefs[i];
  } else if constexpr (C == kLdg) {
    return __ldg(g + i);
  } else {
    return 0.4f;
  }
}

template <int M, int U, int C>
__global__ void __launch_bounds__(kThreads)
    chain(const float* __restrict__ x, const float* __restrict__ coefs, float* __restrict__ out,
          int n, int steps) {
  __shared__ float s_coefs[C == kShared ? kTable : 1];
  if constexpr (C == kShared) {
    for (int i = threadIdx.x; i < kTable; i += kThreads) s_coefs[i] = coefs[i];
    __syncthreads();
  }
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float xv = x[i];
  if constexpr (M == kFma || M == kMul) {
    float v[kChains];
#pragma unroll
    for (int k = 0; k < kChains; ++k) v[k] = xv * (float)(1.0 + 0.001 * k);
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int r = 0; r < U; ++r) {
#pragma unroll
        for (int k = 0; k < kChains; ++k) {
          if constexpr (M == kFma) {
            v[k] = v[k] * v[k] + addend<C>(s_coefs, coefs, (s * U + r) * kChains + k);
          } else {
            v[k] = v[k] * v[k];
          }
        }
      }
    }
    float acc = v[0];
#pragma unroll
    for (int k = 1; k < kChains; ++k) acc = acc + v[k];
    out[i] = acc;
  } else if constexpr (M == kI32) {
    const int xi = (int)xv;  // truncation, as astype(int32)
    uint32_t v[kChains];  // unsigned: the adds wrap, as int32 adds do in XLA
#pragma unroll
    for (int k = 0; k < kChains; ++k) v[k] = (uint32_t)(xi + k);
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int r = 0; r < U; ++r) {
#pragma unroll
        for (int k = 0; k < kChains; ++k) v[k] = (v[k] & 0x7FFFFFF1u) + 12345u;
      }
    }
    uint32_t acc = v[0];
#pragma unroll
    for (int k = 1; k < kChains; ++k) acc ^= v[k];
    out[i] = (float)(int32_t)acc;
  } else {  // kBoth: do float and integer ops dual-issue?
    constexpr int kHalf = kChains / 2;
    float vf[kHalf];
    uint32_t vi[kHalf];
    const int xi = (int)xv;
#pragma unroll
    for (int k = 0; k < kHalf; ++k) {
      vf[k] = xv * (float)(1.0 + 0.001 * k);
      vi[k] = (uint32_t)(xi + k);
    }
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int r = 0; r < U; ++r) {
#pragma unroll
        for (int k = 0; k < kHalf; ++k) {
          vf[k] = vf[k] * vf[k] + 0.4f;
          vi[k] = (vi[k] ^ 0x5A5A5A5u) + 12345u;
        }
      }
    }
    float acc = vf[0];
    uint32_t ai = vi[0];
#pragma unroll
    for (int k = 1; k < kHalf; ++k) {
      acc = acc + vf[k];
      ai ^= vi[k];
    }
    out[i] = acc + (float)(int32_t)ai;
  }
}

using ChainFn = void (*)(const float*, const float*, float*, int, int);

struct Variant {
  int mix, u, coef;
  ChainFn fn;
};

#define RT_CHAIN(M, U, C) {M, U, C, chain<M, U, C>}
// P1: every mix at the tool's unrolls 256 and 1024 (unroll // 4 and unroll)
// and at 4 and 12, where the chains are still finite and the card check
// compares values; P2: the tool's body sizes and 2 (the tests' pair);
// P3: one round a step, each table.
const Variant kVariants[] = {
    RT_CHAIN(kFma, 4, kConst),     RT_CHAIN(kFma, 12, kConst),   RT_CHAIN(kFma, 256, kConst),
    RT_CHAIN(kFma, 1024, kConst),  RT_CHAIN(kMul, 4, kConst),    RT_CHAIN(kMul, 12, kConst),
    RT_CHAIN(kMul, 256, kConst),   RT_CHAIN(kMul, 1024, kConst), RT_CHAIN(kI32, 4, kConst),
    RT_CHAIN(kI32, 12, kConst),    RT_CHAIN(kI32, 256, kConst),  RT_CHAIN(kI32, 1024, kConst),
    RT_CHAIN(kBoth, 4, kConst),    RT_CHAIN(kBoth, 12, kConst),  RT_CHAIN(kBoth, 256, kConst),
    RT_CHAIN(kBoth, 1024, kConst), RT_CHAIN(kFma, 1, kConst),    RT_CHAIN(kFma, 2, kConst),
    RT_CHAIN(kFma, 8, kConst),     RT_CHAIN(kFma, 48, kConst),   RT_CHAIN(kFma, 176, kConst),
    RT_CHAIN(kFma, 512, kConst),   RT_CHAIN(kFma, 1, kShared),   RT_CHAIN(kFma, 1, kConstant),
    RT_CHAIN(kFma, 1, kLdg),
};
#undef RT_CHAIN

ChainFn find(int mix, int u, int coef) {
  for (const Variant& v : kVariants) {
    if (v.mix == mix && v.u == u && v.coef == coef) return v.fn;
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Launch chain<mix, u, coef> over x[0:n] into out on `stream`. coefs: 4,096
// floats on the device for a table variant (copied into __constant__ memory
// first for kConstant), else unused; a table variant needs steps * u * 8 <=
// 4096. Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a variant that is not built or a table too
// short; the caller raises on anything but 0.
int rt_vpu_chain_launch(const float* x, const float* coefs, float* out, int n, int mix, int u,
                        int coef, int steps, void* stream) {
  ChainFn fn = find(mix, u, coef);
  if (fn == nullptr || steps < 0 || (coef != kConst && (long long)steps * u * kChains > kTable)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (coef == kConstant) {
    cudaError_t e = cudaMemcpyToSymbolAsync(c_coefs, coefs, kTable * sizeof(float), 0,
                                            cudaMemcpyDeviceToDevice, s);
    if (e != cudaSuccess) return (int)e;
  }
  void* args[] = {(void*)&x, (void*)&coefs, (void*)&out, (void*)&n, (void*)&steps};
  cudaError_t e = cudaLaunchKernel((const void*)fn, dim3((n + kThreads - 1) / kThreads),
                                   dim3(kThreads), args, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Registers per thread and local (spill) bytes of chain<mix, u, coef>.
int rt_vpu_chain_attrs(int mix, int u, int coef, int* num_regs, int* local_bytes) {
  ChainFn fn = find(mix, u, coef);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, (const void*)fn);
  if (e != cudaSuccess) return (int)e;
  *num_regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

}  // extern "C"
