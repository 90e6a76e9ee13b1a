"""Pixel and sample sharding over a ("dp", "sp") device mesh.

Mirrors `cs397raytracingsp22_tpu/parallel/sharding.py` on torch.distributed.
One process is one rank and drives one device; every rank of the process
group renders. The mesh is a `torch.distributed.device_mesh.DeviceMesh` of
shape (n_dp, n_sp), ranks laid out row-major (rank = dp·n_sp + sp, so an sp
group is a run of adjacent ranks):

- "dp" splits each chunk's pixel ids: rank (dp, sp) takes the dp-th of
  n_dp equal slices of the (padded) chunk;
- "sp" splits the chunk's samples: it takes the sample range
  sample_offset + sp·spp/n_sp, of spp/n_sp samples.

Each rank renders its shard with the driver's own `render_chunk`, which
routes it as on one device: to K1, to the staged executor
`path_trace_shrink`, to NEE or to Phong. Nothing inside a chunk talks to
another rank (the staged executor's per-bounce host reads stay local).

Collectives are only `all_reduce` and `broadcast`: gloo implements just
those on CUDA tensors, and several gloo ranks sharing one card is how the
multi-rank logic runs on a machine with one. The chunk's result is
assembled by one all_reduce(SUM) of a zero-filled buffer into which each
rank wrote its own slot: every element has one writer and exact zeros
elsewhere, so the sum changes no bit (NaN and inf pass through). The
segment counts are summed once a render, at its end (render.driver).

The JAX package's `make_sharded_staged_render_chunk` exists only to run its
static-width staged executor (`path_trace_static`) inside `shard_map`. The
port does not have that executor (ROADMAP §A, "not to port"): each rank's
`render_chunk` runs the staged and NEE executors on its own shard with no
extra code, so the function has no counterpart here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from cs397raytracingsp22_tpu_torch.models.camera import Camera
from cs397raytracingsp22_tpu_torch.utils import profiling


def make_device_mesh(n_dp: Optional[int] = None, n_sp: int = 1):
    """A ("dp", "sp") DeviceMesh over the ranks of the initialized process
    group (multihost.initialize, or torchrun with `--distributed`).

    n_dp defaults to the ranks left after n_sp. The mesh must cover every
    rank: each rank of the group renders its shard."""
    if not dist.is_initialized():
        raise RuntimeError(
            "a device mesh needs a torch.distributed process group: call "
            "parallel.multihost.initialize first (or start under torchrun with --distributed)"
        )
    world = dist.get_world_size()
    if n_sp <= 0:
        raise ValueError(f"n_sp must be positive, got {n_sp}")
    if n_dp is None:
        n_dp = world // n_sp
    if n_dp <= 0 or n_dp * n_sp > world:
        raise ValueError(
            f"mesh {n_dp}x{n_sp} needs {n_dp * n_sp} devices, have "
            f"{world} (is n_sp larger than the device count?)"
        )
    if n_dp * n_sp < world:
        raise ValueError(
            f"mesh {n_dp}x{n_sp} covers {n_dp * n_sp} of the group's {world} ranks: every "
            "rank renders a shard, so the mesh must cover them all"
        )
    from torch.distributed.device_mesh import init_device_mesh

    # init_device_mesh also makes a process group for each axis; none is
    # used: every collective runs on the world group, and the mesh only
    # gives each rank its (dp, sp) place (mesh_axes)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_dp, n_sp), mesh_dim_names=("dp", "sp"))


def mesh_axes(mesh) -> tuple[int, int, int, int]:
    """(n_dp, n_sp, dp, sp): the mesh's shape and this rank's place in it."""
    if tuple(mesh.mesh_dim_names or ()) != ("dp", "sp"):
        raise ValueError(f"the mesh's axes must be ('dp', 'sp'), not {mesh.mesh_dim_names}")
    coord = mesh.get_coordinate()
    if coord is None or mesh.size() != dist.get_world_size():
        raise ValueError("the mesh must cover every rank of the process group")
    n_dp, n_sp = mesh.shape
    return n_dp, n_sp, coord[0], coord[1]


def sum_over_ranks(buf: torch.Tensor) -> torch.Tensor:
    """buf summed over every rank, in place (one all_reduce); returns it."""
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf


def make_sharded_render_chunk(mesh, camera: Camera, spp: int, n_chains: int = 1):
    """A chunk renderer over `mesh` for a fixed camera and spp.

    Returns fn(scene_data, pixel_ids, rng_key, sample_offset) →
    (partials (n_sp, n_px, 3), segments): partials[s] is the per-pixel sum
    of sp rank s's samples over the whole chunk, the same on every rank, so
    the caller adds them in sp order; segments is this rank's own count of
    its shard (the driver sums the ranks' counts once, at the end of the
    render, so a chunk makes one collective). len(pixel_ids) must divide by
    the mesh's dp size. The local render runs under the driver's retry,
    before the chunk's collective, so every rank reaches it in step."""
    from cs397raytracingsp22_tpu_torch.render import driver

    n_dp, n_sp, dp, sp = mesh_axes(mesh)
    if spp % n_sp:
        # user input: a remainder would drop samples while the finalize
        # still divides by the full spp
        raise ValueError(f"spp {spp} not divisible by sp axis {n_sp}")
    spp_local = spp // n_sp

    def chunk(scene, pixel_ids: torch.Tensor, rng_key, sample_offset: int):
        n_px = pixel_ids.shape[0]
        if n_px % n_dp:
            raise ValueError(f"{n_px} pixel ids do not split over the dp axis {n_dp}")
        lo, hi = dp * (n_px // n_dp), (dp + 1) * (n_px // n_dp)
        # module attribute lookups, so a test can patch render_chunk
        rad, segs = driver._dispatch_with_retry(driver.render_chunk, (
            scene, camera, pixel_ids[lo:hi], rng_key, sample_offset + sp * spp_local,
            spp_local, n_chains))
        with profiling.span("render.allreduce"):
            parts = torch.zeros((n_sp, n_px, 3), dtype=rad.dtype, device=rad.device)
            parts[sp, lo:hi] = rad
            return sum_over_ranks(parts), segs

    return chunk


def render_to_image_sharded(scene, mesh, seed: int = 0, verbose: bool = True, **kw):
    """Full sharded render: the multi-device render_to_image.

    A thin wrapper over render.driver.render_to_image(mesh=...): the same
    chunk loop, accumulation, checkpoint and resume, retry, progress and
    steady-state stats as on one device. Every rank returns the same
    (H, W, 3) u8 image; with n_sp = 1 it equals the one-device render bit
    for bit, with n_sp > 1 the one-device render at spp_chunk / n_sp."""
    from cs397raytracingsp22_tpu_torch.render.driver import render_to_image

    return render_to_image(scene, seed=seed, verbose=verbose, mesh=mesh, **kw)
