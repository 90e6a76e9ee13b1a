// The draws layer (D1) for NVIDIA Hopper (sm_90a): camera rays, a bounce's
// draws and NEE's draws, one launch each.
//
// Replaces no Pallas kernel: the JAX package computes these draws with jnp
// ops (utils/threefry.py, models/camera.py, utils/sampling.py) and XLA fuses
// them. The port's plain versions emulate uint32 Threefry-2x32-20 in int64
// torch tensors, every add, shift and xor masked and launched on its own:
// some 350 launches for four uniforms, some 500 for a chunk's camera rays.
// Here each call is one launch, one thread per ray, no shared memory.
//
// Entry points (the plain version each is held to, bit for bit):
// - camera_rays_kernel: models/camera.py::Camera.generate_rays_plain, the
//   SITE_CAMERA blocks, the lattice jitter, the subpixel grid, the thin lens
//   (or the orthographic origin) and the rotation, as (N, spp, 3) origins
//   and directions;
// - bounce_draws_kernel: ops/kernels/draws.py::bounce_draws_plain, the
//   16-bit halves of block 0 (ball vector and branch uniform) and the 24-bit
//   volume uniforms from block 1 on;
// - counter_uniforms_kernel: utils/threefry.py::counter_uniforms.
//
// Bound: bytes. A ray reads at most 4 bytes and writes 16-24 (camera 24),
// against ~200 integer operations for a Threefry block, so a launch of
// 4,194,304 rays moves ~100 MB: ~30 us at 3.35 TB/s.
//
// Arithmetic: Threefry, sincos_2pi and cbrt_fast are bounce.cuh's (K1's).
// Built with -fmad=false, so each float multiply and add rounds on its own,
// as the plain version's separate torch kernels do; divides and square
// roots are correctly rounded (no fast math); the disk's sinf and cosf are
// the CUDA math library's, as torch.sin and torch.cos on the card. The
// camera's scalars are folded on the host exactly as the plain version
// folds them (ops/kernels/draws.py::camera_args), and a division by a
// Python scalar is a multiply by the float reciprocal, as torch's CUDA
// division by a scalar computes it.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "bounce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kTwo16 = 1.52587890625e-05f;      // 2^-16
constexpr float kTwo24 = 5.9604644775390625e-08f;  // 2^-24

// ints of the camera launch (ops/kernels/draws.py::CAMERA_INTS)
struct CameraInts {
  int width, aa, rootn_i, sample_offset, ortho;
};

// floats of the camera launch, as the plain version rounds them
// (ops/kernels/draws.py::CAMERA_FLOATS)
struct CameraFloats {
  float n, half_rootn, pixel_size, inv_rootn, half_n, inv_n, half_w, half_h_plus, neg_focal,
      two_pi, lens_radius, focus_dist, eye[3], rot[9], ortho_dir[3];
};

// Python's floor division and remainder, as torch's on int32.
__device__ __forceinline__ void floor_divmod(int a, int b, int& q, int& r) {
  q = a / b;
  r = a - q * b;
  if (r != 0 && ((r < 0) != (b < 0))) {
    r += b;
    q -= 1;
  }
}

__device__ __forceinline__ float u24(uint32_t w) { return (float)(w >> 8) * kTwo24; }

__global__ void __launch_bounds__(kThreads)
    camera_rays_kernel(const int* __restrict__ pixel_ids, int n_rays, int spp, uint32_t k0,
                       uint32_t k1, CameraInts ci, CameraFloats cf, float* __restrict__ o,
                       float* __restrict__ d) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_rays) return;
  const int pid = __ldg(pixel_ids + t / spp);
  const int sid = ci.sample_offset + t % spp;
  // uid = pixel_id * aa_sample_count + sample_id, int32 arithmetic read as uint32
  const uint32_t uid = (uint32_t)pid * (uint32_t)ci.aa + (uint32_t)sid;
  uint32_t a0, a1, b0, b1;
  rt::threefry2x32(k0, k1, uid, 0u, a0, a1);  // SITE_CAMERA, blocks 0 and 1
  rt::threefry2x32(k0, k1, uid, 1u, b0, b1);

  int q, r;
  floor_divmod(pid, ci.width, q, r);
  const float x = (float)r, y = (float)q;
  const float rand_x = floorf(u24(a0) * cf.n);
  const float rand_y = floorf(u24(a1) * cf.n);
  floor_divmod(sid, ci.rootn_i, q, r);
  const float sub_x = (float)q, sub_y = (float)r;

  const float off_x = (sub_x - cf.half_rootn) * cf.pixel_size * cf.inv_rootn +
                      (rand_x - cf.half_n) * cf.pixel_size * cf.inv_n;
  const float off_y = (sub_y - cf.half_rootn) * cf.pixel_size * cf.inv_rootn +
                      (rand_y - cf.half_n) * cf.pixel_size * cf.inv_n;
  const float cx = cf.pixel_size * (x - cf.half_w + 0.5f) + off_x;
  const float cy = cf.pixel_size * (cf.half_h_plus - y) + off_y;
  const float cz = cf.neg_focal;
  const float* R = cf.rot;  // row-major camera-to-world rotation
  float* O = o + 3 * (size_t)t;
  float* D = d + 3 * (size_t)t;

  if (ci.ortho) {
    O[0] = cx; O[1] = cy; O[2] = 0.0f;
    D[0] = cf.ortho_dir[0]; D[1] = cf.ortho_dir[1]; D[2] = cf.ortho_dir[2];
    return;
  }
  // thin lens: a lens point aimed at the focus plane
  const float theta = cf.two_pi * u24(b0);
  const float rl = sqrtf(u24(b1));
  const float lx = cf.lens_radius * (rl * cosf(theta));
  const float ly = cf.lens_radius * (rl * sinf(theta));
  const float lz = cf.lens_radius * 0.0f;
  const float cl = sqrtf(cx * cx + cy * cy + cz * cz);
  const float fx = cx / cl * cf.focus_dist, fy = cy / cl * cf.focus_dist,
              fz = cz / cl * cf.focus_dist;
  for (int j = 0; j < 3; ++j) {
    O[j] = cf.eye[j] + (R[3 * j] * lx + R[3 * j + 1] * ly + R[3 * j + 2] * lz);
  }
  const float wx = fx - lx, wy = fy - ly, wz = fz - lz;
  const float wl = sqrtf(wx * wx + wy * wy + wz * wz);
  const float nx = wx / wl, ny = wy / wl, nz = wz / wl;
  for (int j = 0; j < 3; ++j) D[j] = R[3 * j] * nx + R[3 * j + 1] * ny + R[3 * j + 2] * nz;
}

__global__ void __launch_bounds__(kThreads)
    bounce_draws_kernel(const uint32_t* __restrict__ uids, int n, uint32_t k0, uint32_t k1,
                        uint32_t site, int n_vol, float* __restrict__ ball,
                        float* __restrict__ u_choice, float* __restrict__ u_vol) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t uid = __ldg(uids + i);
  uint32_t x0, x1;
  rt::threefry2x32(k0, k1, uid, site, x0, x1);
  const float u0 = (float)(x0 >> 16) * kTwo16, u1 = (float)(x0 & 0xFFFFu) * kTwo16;
  const float u2 = (float)(x1 >> 16) * kTwo16;
  const float zb = 2.0f * u0 - 1.0f;
  float cphi, sphi;
  rt::sincos_2pi(u1, cphi, sphi);
  const float rad = rt::cbrt_fast(u2);
  const float sb = sqrtf(fmaxf(1.0f - zb * zb, 0.0f));
  ball[3 * (size_t)i] = rad * (sb * cphi);
  ball[3 * (size_t)i + 1] = rad * (sb * sphi);
  ball[3 * (size_t)i + 2] = rad * zb;
  u_choice[i] = (float)(x1 & 0xFFFFu) * kTwo16;
  float* V = u_vol + (size_t)i * n_vol;
  for (int q = 0; q < n_vol; q += 2) {  // draw 4 + q: block 1 + q / 2
    rt::threefry2x32(k0, k1, uid, site + 1u + (uint32_t)(q >> 1), x0, x1);
    V[q] = u24(x0);
    if (q + 1 < n_vol) V[q + 1] = u24(x1);
  }
}

__global__ void __launch_bounds__(kThreads)
    counter_uniforms_kernel(const uint32_t* __restrict__ uids, int n, uint32_t k0, uint32_t k1,
                            uint32_t site, int m, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t uid = __ldg(uids + i);
  float* U = out + (size_t)i * m;
  for (int j = 0; j < m; j += 2) {  // draw j: block j / 2
    uint32_t x0, x1;
    rt::threefry2x32(k0, k1, uid, site + (uint32_t)(j >> 1), x0, x1);
    U[j] = u24(x0);
    if (j + 1 < m) U[j + 1] = u24(x1);
  }
}

int grid(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// Each launch returns cudaGetLastError() after it (0 on success); the
// caller raises on anything else. `site` is the draw site's counter base,
// site << 16 (utils/threefry.py::_site_base). Nothing is launched for 0 rays.

int rt_camera_rays_launch(const int* pixel_ids, int n_px, int spp, unsigned k0, unsigned k1,
                          const int* ints, const float* floats, float* o, float* d,
                          void* stream) {
  const int n_rays = n_px * spp;
  if (n_rays <= 0) return 0;
  CameraInts ci;
  CameraFloats cf;
  memcpy(&ci, ints, sizeof ci);
  memcpy(&cf, floats, sizeof cf);
  camera_rays_kernel<<<grid(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
      pixel_ids, n_rays, spp, k0, k1, ci, cf, o, d);
  return (int)cudaGetLastError();
}

int rt_bounce_draws_launch(const unsigned* uids, int n, unsigned k0, unsigned k1, unsigned site,
                           int n_vol, float* ball, float* u_choice, float* u_vol, void* stream) {
  if (n <= 0) return 0;
  bounce_draws_kernel<<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(uids, n, k0, k1, site,
                                                                       n_vol, ball, u_choice,
                                                                       u_vol);
  return (int)cudaGetLastError();
}

int rt_counter_uniforms_launch(const unsigned* uids, int n, unsigned k0, unsigned k1,
                               unsigned site, int m, float* out, void* stream) {
  if (n <= 0) return 0;
  counter_uniforms_kernel<<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(uids, n, k0, k1, site,
                                                                           m, out);
  return (int)cudaGetLastError();
}

// Sizes of the two parameter blocks, for the caller's check of its layout.
int rt_camera_param_counts(int* n_ints, int* n_floats) {
  *n_ints = (int)(sizeof(CameraInts) / sizeof(int));
  *n_floats = (int)(sizeof(CameraFloats) / sizeof(float));
  return 0;
}

// Registers per thread and local (spill) bytes of entry point `which`
// (0 camera rays, 1 bounce draws, 2 counter uniforms).
int rt_draws_attrs(int which, int* num_regs, int* local_bytes) {
  cudaFuncAttributes a;
  const void* f = which == 0   ? (const void*)camera_rays_kernel
                  : which == 1 ? (const void*)bounce_draws_kernel
                               : (const void*)counter_uniforms_kernel;
  cudaError_t e = cudaFuncGetAttributes(&a, f);
  if (e != cudaSuccess) return (int)e;
  *num_regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

}  // extern "C"
