"""Camera model and batched ray generation.

Mirrors `cs397raytracingsp22_tpu/models/camera.py` (the reference camera,
tracing.rs:137-209) field for field. Rays are generated for a batch of
pixels at once, (N_pix, spp) rays per call, on the device of `pixel_ids`.

Replicated reference quirks:
- the subpixel grid index divides by ⌊√n⌋ while the offset scale uses
  the float √n (tracing.rs:169-173);
- the jitter is a discrete lattice sample `gen_range(0..n)/n - 0.5`
  (tracing.rs:167-168,172-173);
- orthographic origins ignore the eyepoint and the rotation, and the
  direction is the rotated view_dir (tracing.rs:196,200,204);
- the basis is [normalize(view_dir × up), up, -view_dir] with up and
  view_dir not renormalized (tracing.rs:187-191).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Tuple

import torch

from cs397raytracingsp22_tpu_torch.ops.kernels import draws
from cs397raytracingsp22_tpu_torch.utils import rng as rnglib
from cs397raytracingsp22_tpu_torch.utils import sampling
from cs397raytracingsp22_tpu_torch.utils import threefry
from cs397raytracingsp22_tpu_torch.utils import vecmath as vm


class CameraProjectionMode(enum.Enum):
    ORTHOGRAPHIC = "orthographic"
    PERSPECTIVE = "perspective"


class ShadingMode(enum.Enum):
    PHONG = "phong"
    PATH_TRACE = "path_trace"


@dataclasses.dataclass(frozen=True)
class Camera:
    """Static camera configuration (reference tracing.rs:137-155)."""

    eyepoint: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    view_dir: Tuple[float, float, float] = (0.0, 0.0, -1.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    projection_mode: CameraProjectionMode = CameraProjectionMode.PERSPECTIVE
    shading_mode: ShadingMode = ShadingMode.PATH_TRACE
    path_depth: int = 10
    path_samples: int = 1
    screen_width: int = 100
    screen_height: int = 100
    focal_length: float = 0.6
    focus_dist: float = 5.0
    lens_radius: float = 0.0
    aa_sample_count: int = 100
    max_trace_dist: float = 100.0
    gamma: float = 2.0
    # next-event estimation (render/nee.py): an opt-in estimator beyond the
    # reference's, the same image at equal depth with less noise
    nee: bool = False

    def rotation(self, device) -> torch.Tensor:
        """Camera→world rotation, columns [normalize(view×up), up, -view]."""
        view = torch.tensor(self.view_dir, dtype=torch.float32, device=device)
        up = torch.tensor(self.up, dtype=torch.float32, device=device)
        right = vm.normalize(vm.cross(view, up))
        return torch.stack([right, up, -view], dim=-1)

    def generate_rays(
        self,
        rng_key,
        pixel_ids: torch.Tensor,
        spp: int | None = None,
        sample_offset: int = 0,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Multi-jittered AA camera rays for a batch of pixels.

        Args:
          rng_key: int seed or (2,) key words (utils.threefry.key_words).
          pixel_ids: (N,) int32 flat pixel indices (y * width + x); the
            rays are made on its device.
          spp: samples generated in this call (default aa_sample_count).
          sample_offset: global index of the first sample, so chunked
            calls draw what one full-spp call would.

        Returns (origins, directions), each (N, spp, 3) float32. CUDA
        tensors take one launch of the draws kernel
        (ops/kernels/draws.py::camera_rays), other tensors
        generate_rays_plain; both give the same bits.
        """
        if spp is None:
            spp = self.aa_sample_count
        if pixel_ids.is_cuda:
            return draws.camera_rays(self, rng_key, pixel_ids.to(torch.int32), spp,
                                     sample_offset)
        return self.generate_rays_plain(rng_key, pixel_ids, spp, sample_offset)

    def generate_rays_plain(
        self,
        rng_key,
        pixel_ids: torch.Tensor,
        spp: int | None = None,
        sample_offset: int = 0,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """generate_rays in torch ops on pixel_ids' device: the plain
        version of the draws kernel's camera rays."""
        if spp is None:
            spp = self.aa_sample_count
        if isinstance(rng_key, int):
            rng_key = threefry.key_words(rng_key)
        dev = pixel_ids.device
        n_px = pixel_ids.shape[0]
        pixel_ids = pixel_ids.to(torch.int32)
        x = (pixel_ids % self.screen_width).to(torch.float32)
        y = torch.div(pixel_ids, self.screen_width, rounding_mode="floor").to(
            torch.float32
        )

        pixel_size = 1.0 / float(self.screen_height)
        n = float(self.aa_sample_count)
        rootn = math.sqrt(n)
        rootn_i = int(rootn)  # `rootn as u32` (tracing.rs:169-170)

        sample_ids = sample_offset + torch.arange(spp, dtype=torch.int32, device=dev)
        uids = pixel_ids[:, None] * self.aa_sample_count + sample_ids[None, :]
        u4 = threefry.counter_uniforms(
            rng_key, uids.reshape(-1), rnglib.SITE_CAMERA, 4
        )
        rand_x = torch.floor(u4[:, 0] * n).reshape(n_px, spp)
        rand_y = torch.floor(u4[:, 1] * n).reshape(n_px, spp)

        i = sample_ids[None, :]
        subpixel_x = torch.div(i, rootn_i, rounding_mode="floor").to(torch.float32)
        subpixel_y = (i % rootn_i).to(torch.float32)

        off_x = (subpixel_x - 0.5 * rootn) * pixel_size / rootn + (
            rand_x - 0.5 * n
        ) * pixel_size / n
        off_y = (subpixel_y - 0.5 * rootn) * pixel_size / rootn + (
            rand_y - 0.5 * n
        ) * pixel_size / n

        # camera-space pixel centre plus jitter (tracing.rs:177-181)
        cx = pixel_size * (x[:, None] - 0.5 * self.screen_width + 0.5) + off_x
        cy = pixel_size * (0.5 + 0.5 * self.screen_height - y[:, None]) + off_y
        cz = torch.full_like(cx, -self.focal_length)
        center = torch.stack([cx, cy, cz], dim=-1)

        rotation = self.rotation(dev)

        if self.projection_mode is CameraProjectionMode.ORTHOGRAPHIC:
            origins = torch.stack([cx, cy, torch.zeros_like(cx)], dim=-1)
            view = torch.tensor(self.view_dir, dtype=torch.float32, device=dev)
            d = vm.apply_mat3(rotation, view)
            return origins, torch.broadcast_to(d, origins.shape).contiguous()

        # thin lens: a lens point aimed at the focus plane (tracing.rs:182-201)
        disk = sampling.disk_vec_from_uniform(u4[:, 2:4])
        lens_origin = self.lens_radius * disk.reshape(n_px, spp, 3)
        focus_center = vm.normalize(center) * self.focus_dist
        eye = torch.tensor(self.eyepoint, dtype=torch.float32, device=dev)
        origins = eye + vm.apply_mat3(rotation, lens_origin)
        directions = vm.apply_mat3(rotation, vm.normalize(focus_center - lens_origin))
        return origins, directions
