// The merged resolve (R1) for NVIDIA Hopper (sm_90a): a mesh winner's world
// point, shading normal, front face, texels and material, one launch a call.
//
// Replaces no Pallas kernel: the JAX package's merged resolve
// (ops/intersect.py::_resolve_mesh_winners_merged) is jnp code that XLA
// fuses. Its plain version here, ops/intersect.py::resolve_mesh_winners,
// launches one torch kernel per operation: ~200 for a scene with three
// meshes, textures and normal maps, ~60 for one untextured mesh, plus the
// object rays of every dense mesh. Here each call is one launch, one thread
// a ray, held to the plain version bit for bit.
//
// Per ray (the plain version's order of operations throughout):
// - a mesh winner (code in [kCodeMesh0, kCodeMesh0 + M)): its triangle
//   index clamped to its mesh, the triangle's kmesh_res row, the object-space
//   ray from the world ray and the mesh's inverse transform (in
//   apply_mat4_point's and apply_mat4_vector's order), the smooth normal and
//   uv by barycentric weights, normalised with eps 1e-30, the front face
//   against the object-space direction, the bound texture slots' nearest
//   texels (texel_index), the normal map (_normal_mapped), the normal matrix
//   and the forward transform, then the mesh's material row or the material
//   synthesized from its slots 0-3 (_synthesized_material);
// - any other ray: its incoming point, normal and front face, and the
//   material row of its id clipped to the table (_table_ids).
//
// Bound: bytes. A ray reads ~76 B of inputs, a mesh winner the words of its
// kmesh_res row it needs (36 B, 60 with a texel to sample, 72 with a normal
// map) and 3 B a texel it samples, and every ray writes 65 B: ~0.3 ms at
// 4,194,304 rays and 3.35 TB/s. A mesh's kmesh_xfm row ([normal matrix, R,
// t, inverse R, inverse t, first kmesh_res row, triangles, material id]) and
// kmesh_tex row and the material rows (kscene's) are staged into shared
// memory once a block of a persistent grid, since a warp's rays index
// different meshes and materials (divergent __constant__ loads measured
// +431%, PERF.md). Meshes and materials past the staged counts are read
// from device memory.
//
// Arithmetic: built with -fmad=false, so each float multiply and add rounds on
// its own, as in the plain version's separate torch kernels; divides and
// square roots are correctly rounded (no fast math). torch's CUDA division
// by a Python scalar is a multiply by the float32 reciprocal, so a texel is
// its byte times 1.0f / 255.0f; a float-to-int cast truncates (cvt.rzi, as
// torch's), and torch.clamp passes NaN through.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "intersect.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCodeMesh0 = 4;       // ops/intersect.py::CODE_MESH0
constexpr int kParameterized = 3;   // models/materials.py::PARAMETERIZED
constexpr int kXfm = 36, kTex = 15, kRes = 18;
// columns of a kmesh_xfm row
constexpr int kFwd = 9, kFwdT = 18, kInvR = 21, kInvT = 30, kFirst = 33, kTris = 34, kMatId = 35;
constexpr int kMeshStaged = 64;     // meshes staged a block (13 KB)
constexpr int kMatStaged = 512;     // material rows staged a block (20 KB)
constexpr float kInv255 = 1.0f / 255.0f;
constexpr float kEps = 1e-30f;

// Pointers of a launch (ops/kernels/resolve.py::POINTERS, in this order).
struct Ptrs {
  const float *o, *d;
  const int* code;
  const float* t;
  const int* idx;
  const float *u, *v, *point_in, *normal_in;
  const bool* ff_in;
  const int* mat_in;
  const float *res, *xfm;
  const int* tex;
  const float* kscene;
  const uint8_t* pixels;
  float *point, *normal;
  bool* ff;
  int* mtype;
  float *albedo, *emission, *roughness, *metallic, *ior;
};

// Ints of a launch (ops/kernels/resolve.py::INTS, in this order).
struct Ints {
  int n, n_mesh, n_sph, n_pln, n_tri, n_vol, n_mat;
};

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// vecmath.normalize(v, eps=1e-30): v / sqrt(|v|^2 + eps)
__device__ __forceinline__ void normalize3(float* a) {
  const float s = sqrtf(dot3(a, a) + kEps);
  a[0] = a[0] / s;
  a[1] = a[1] / s;
  a[2] = a[2] / s;
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// Row k of a row-major 3x3 matrix m times p (mat3 / apply_mat4_vector).
__device__ __forceinline__ float row3(const float* m, int k, const float* p) {
  return (m[3 * k] * p[0] + m[3 * k + 1] * p[1]) + m[3 * k + 2] * p[2];
}

// torch.clamp(x, 0.0, 0.999) on the card: NaN passes through.
__device__ __forceinline__ float clamp_uv(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.0f), 0.999f);
}

// The nearest texel of atlas slot (off, w, h) at uv (texel_index,
// sample_texture_dyn), as float rgb in [0, 1].
__device__ __forceinline__ void texel(const uint8_t* __restrict__ pixels, const int* slot,
                                      const float* uv, float* rgb) {
  const int w = slot[1], h = slot[2];
  const float uc = clamp_uv(uv[0]), vc = clamp_uv(uv[1]);
  const int x = min((int)(uc * (float)w), w - 1);
  const int y = min((int)((1.0f - vc) * (float)h), h - 1);
  const uint8_t* p = pixels + 3 * (size_t)(unsigned)((slot[0] + y * w) + x);
  rgb[0] = (float)__ldg(p) * kInv255;
  rgb[1] = (float)__ldg(p + 1) * kInv255;
  rgb[2] = (float)__ldg(p + 2) * kInv255;
}

__device__ __forceinline__ void write3(float* out, int i, const float* a) {
  out[3 * i] = a[0];
  out[3 * i + 1] = a[1];
  out[3 * i + 2] = a[2];
}

// A material row [type, albedo, emission, roughness, metallic, ior].
__device__ __forceinline__ void write_material(const Ptrs& p, int i, const float* m) {
  p.mtype[i] = (int)m[0];
  write3(p.albedo, i, m + 1);
  write3(p.emission, i, m + 4);
  p.roughness[i] = m[7];
  p.metallic[i] = m[8];
  p.ior[i] = m[9];
}

// kFull: some mesh binds a texture slot or has its material synthesized from
// its textures (the uv, the texels and the synthesized material are then
// formed where a winner's mesh needs them); otherwise a winner reads its
// normals and its mesh's material row alone.
template <bool kFull>
__global__ void __launch_bounds__(kThreads) resolve_kernel(const Ptrs p, const Ints q) {
  extern __shared__ __align__(16) float smem[];
  const int ms = min(q.n_mesh, kMeshStaged), ts = min(q.n_mat, kMatStaged);
  float* s_xfm = smem;
  int* s_tex = reinterpret_cast<int*>(s_xfm + kXfm * ms);
  float* s_mat = reinterpret_cast<float*>(s_tex + kTex * ms);
  const float* g_mat = rt::scene_rows(p.kscene, q.n_sph, q.n_pln, q.n_tri, q.n_vol, q.n_mat,
                                      nullptr).mat;
  for (int k = threadIdx.x; k < kXfm * ms; k += blockDim.x) s_xfm[k] = p.xfm[k];
  for (int k = threadIdx.x; k < kTex * ms; k += blockDim.x) s_tex[k] = p.tex[k];
  for (int k = threadIdx.x; k < rt::kMat * ts; k += blockDim.x) s_mat[k] = g_mat[k];
  __syncthreads();

  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < q.n; i += stride) {
    const int j = p.code[i] - kCodeMesh0;
    if (j < 0 || j >= q.n_mesh) {  // not a mesh winner: its own fields
      for (int k = 0; k < 3; ++k) {
        p.point[3 * i + k] = p.point_in[3 * i + k];
        p.normal[3 * i + k] = p.normal_in[3 * i + k];
      }
      p.ff[i] = p.ff_in[i];
      const int mid = min(max(p.mat_in[i], 0), q.n_mat - 1);
      write_material(p, i, mid < ts ? s_mat + rt::kMat * mid : g_mat + rt::kMat * mid);
      continue;
    }
    const bool staged = j < ms;
    const float* xf = (staged ? s_xfm : p.xfm) + kXfm * j;
    const int* tx = (staged ? s_tex : p.tex) + kTex * j;
    const int mat_id = (int)xf[kMatId];
    const int tri = min(max(p.idx[i], 0), (int)xf[kTris] - 1);
    // what this winner's mesh samples: the normal map (slot 4), and slots
    // 0-3 where its material is synthesized
    const bool nmap = kFull && tx[12] >= 0;
    const bool synth = kFull && mat_id < 0;
    const bool sample = nmap || (synth && (tx[0] >= 0 || tx[3] >= 0 || tx[6] >= 0 || tx[9] >= 0));

    // the triangle's row, in 8-byte loads: corner normals, then the corner
    // uvs where a texel is sampled, then the tangent under a normal map
    float r[kRes];
    const float2* r2 =
        reinterpret_cast<const float2*>(p.res + (size_t)((int)xf[kFirst] + tri) * kRes);
    const int pairs = nmap ? 9 : (sample ? 8 : 5);
    for (int k = 0; k < 9; ++k) {
      if (k < pairs) {
        const float2 w2 = __ldg(r2 + k);
        r[2 * k] = w2.x;
        r[2 * k + 1] = w2.y;
      }
    }

    // the object-space ray (object_rays)
    const float ow[3] = {p.o[3 * i], p.o[3 * i + 1], p.o[3 * i + 2]};
    const float dw[3] = {p.d[3 * i], p.d[3 * i + 1], p.d[3 * i + 2]};
    float oo[3], dd[3];
    for (int k = 0; k < 3; ++k) {
      oo[k] = row3(xf + kInvR, k, ow) + xf[kInvT + k];
      dd[k] = row3(xf + kInvR, k, dw);
    }

    // smooth normal and front face (_barycentric: u b + v c + (1 - u - v) a)
    const float u = p.u[i], v = p.v[i];
    const float w = (1.0f - u) - v;
    float n[3];
    for (int k = 0; k < 3; ++k) n[k] = (u * r[3 + k] + v * r[6 + k]) + w * r[k];
    normalize3(n);
    const bool front = dot3(n, dd) < 0.0f;
    if (!front) {
      n[0] = -n[0];
      n[1] = -n[1];
      n[2] = -n[2];
    }
    float uv[2] = {0.0f, 0.0f};
    if (sample) {
      for (int k = 0; k < 2; ++k) uv[k] = (u * r[11 + k] + v * r[13 + k]) + w * r[9 + k];
    }

    // the normal map (_normal_mapped)
    if (nmap) {
      float rgb[3], bt[3], tg[3];
      texel(p.pixels, tx + 12, uv, rgb);
      const float nm[3] = {2.0f * rgb[0] - 1.0f, 2.0f * rgb[1] - 1.0f, 2.0f * rgb[2] - 1.0f};
      cross3(n, r + 15, bt);
      normalize3(bt);
      cross3(bt, n, tg);
      normalize3(tg);
      for (int k = 0; k < 3; ++k) n[k] = (tg[k] * nm[0] + bt[k] * nm[1]) + n[k] * nm[2];
    }

    // world normal and point (the normal matrix, R and t)
    float nw[3], po[3], pw[3];
    for (int k = 0; k < 3; ++k) nw[k] = row3(xf, k, n);
    normalize3(nw);
    const float t = p.t[i];
    for (int k = 0; k < 3; ++k) po[k] = oo[k] + t * dd[k];
    for (int k = 0; k < 3; ++k) pw[k] = row3(xf + kFwd, k, po) + xf[kFwdT + k];
    write3(p.point, i, pw);
    write3(p.normal, i, nw);
    p.ff[i] = front;

    // the material: the mesh's row, or synthesized from slots 0-3
    if (synth) {
      float m[rt::kMat] = {(float)kParameterized, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                           1.0f, 0.0f, 1.5f};
      float rgb[3];
      if (tx[0] >= 0) {  // albedo
        texel(p.pixels, tx, uv, rgb);
        m[1] = rgb[0], m[2] = rgb[1], m[3] = rgb[2];
      }
      if (tx[3] >= 0) {  // emission
        texel(p.pixels, tx + 3, uv, rgb);
        m[4] = rgb[0], m[5] = rgb[1], m[6] = rgb[2];
      }
      if (tx[9] >= 0) {  // roughness: the red channel
        texel(p.pixels, tx + 9, uv, rgb);
        m[7] = rgb[0];
      }
      if (tx[6] >= 0) {  // metallic: the red channel
        texel(p.pixels, tx + 6, uv, rgb);
        m[8] = rgb[0];
      }
      write_material(p, i, m);
    } else {
      const int mid = min(max(mat_id, 0), q.n_mat - 1);
      write_material(p, i, mid < ts ? s_mat + rt::kMat * mid : g_mat + rt::kMat * mid);
    }
  }
}

typedef void (*Kernel)(const Ptrs, const Ints);

// instantiation 0 bare, 1 full (kFull)
const Kernel kKernels[2] = {resolve_kernel<false>, resolve_kernel<true>};

}  // namespace

extern "C" {

// Shared memory a block stages for n_mesh meshes and n_mat materials.
int rt_resolve_smem_bytes(int n_mesh, int n_mat) {
  const int ms = n_mesh < kMeshStaged ? n_mesh : kMeshStaged;
  const int ts = n_mat < kMatStaged ? n_mat : kMatStaged;
  return (int)sizeof(float) * ((kXfm + kTex) * ms + rt::kMat * ts);
}

// One launch of instantiation `variant` over ints[0] rays with `grid` blocks
// of kThreads, on `stream`; returns cudaGetLastError() after it (0 on
// success). Nothing is launched for 0 rays.
int rt_resolve_launch(const void* const* ptrs, const int* ints, int variant, int grid,
                      void* stream) {
  Ptrs p;
  Ints q;
  memcpy(&p, ptrs, sizeof p);
  memcpy(&q, ints, sizeof q);
  if (q.n <= 0) return 0;
  if (variant < 0 || variant > 1) return (int)cudaErrorInvalidValue;
  kKernels[variant]<<<grid, kThreads, rt_resolve_smem_bytes(q.n_mesh, q.n_mat),
                      (cudaStream_t)stream>>>(p, q);
  return (int)cudaGetLastError();
}

// Blocks of instantiation `variant` resident on one SM with the shared
// memory of n_mesh meshes and n_mat materials, and the threads a block.
int rt_resolve_occupancy(int variant, int n_mesh, int n_mat, int* blocks, int* threads) {
  if (variant < 0 || variant > 1) return (int)cudaErrorInvalidValue;
  *threads = kThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kKernels[variant], kThreads, rt_resolve_smem_bytes(n_mesh, n_mat));
}

// Registers per thread and local (spill) bytes of instantiation `variant`.
int rt_resolve_attrs(int variant, int* num_regs, int* local_bytes) {
  if (variant < 0 || variant > 1) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kKernels[variant]);
  if (e != cudaSuccess) return (int)e;
  *num_regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

// The layout and constants the wrapper checks its own against: pointers and
// ints a launch takes, the first mesh code, the synthesized material's type.
int rt_resolve_constants(int* n_ptrs, int* n_ints, int* code_mesh0, int* parameterized) {
  *n_ptrs = (int)(sizeof(Ptrs) / sizeof(void*));
  *n_ints = (int)(sizeof(Ints) / sizeof(int));
  *code_mesh0 = kCodeMesh0;
  *parameterized = kParameterized;
  return 0;
}

}  // extern "C"
