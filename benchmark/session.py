"""One process's part of a run: set-up, the window, the traced images.

Set-up builds the cell's scene through the renderer's public API, compiles
it with `Scene.compile` (the kernels load from build/torch_kernels/ inside
the checkout, and build there with nvcc the first time) and renders one
warm image of the cell's own shapes. The window is a closed loop of whole
images through `render_to_image`, one at a time, each with its own seed;
each ends as a host u8 image. Under a device mesh every rank runs the same
loop, rank 0 deciding by a broadcast flag whether another image follows.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from benchmark import cells, check, port_scene

WARM_INDEX = (1 << 20) - 1  # the warm image's index: no timed image has it


class Session:
    def __init__(self, cell: cells.Cell, device: torch.device, mesh=None):
        self.cell, self.device, self.mesh = cell, device, mesh
        self.scene = self.data = None
        self.setup_peak = 0  # bytes allocated at most during set-up

    def setup(self, seed: int) -> None:
        """Build, compile, render the warm image; then reset the card's
        peak-memory count for the window."""
        files = cells.files_of(self.cell.config)
        self.scene = port_scene.build(self.cell.config, self.cell.camera, files)
        self.data = self.scene.compile(device=self.device)
        self.image(seed, WARM_INDEX)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def peaks(self) -> tuple[int, int]:
        """(the window's peak bytes, set-up's), the largest rank's on a mesh;
        on a mesh every rank then passes a last barrier and leaves the
        group."""
        peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
        if self.mesh is None:
            return peak, self.setup_peak
        import torch.distributed as dist

        t = torch.tensor([float(peak), float(self.setup_peak)], dtype=torch.float64,
                         device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        dist.barrier()
        dist.destroy_process_group()
        return int(t[0].item()), int(t[1].item())

    def image(self, seed: int, index: int):
        from cs397raytracingsp22_tpu_torch.render.driver import render_to_image

        with record_function("bench.image"):
            img, _ = render_to_image(self.scene, device=self.device,
                                     seed=check.image_seed(seed, index), verbose=False,
                                     scene_data=self.data, mesh=self.mesh)
        return img

    def free(self) -> None:
        self.scene = self.data = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def flag(value: int, device) -> int:
    """Rank 0's value, on every rank (a broadcast of one int64)."""
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.broadcast(t, src=0)
    return int(t.item())


def window(sess: Session, seed: int, seconds: float):
    """The timed closed loop: images 0, 1, ... until the first one that
    ends after `seconds`. Returns (window seconds, per-image seconds,
    {index: image})."""
    times, images = [], {}
    start = time.perf_counter()
    index = 0
    while True:
        if sess.mesh is not None:
            flag(index + 1, sess.device)
        a = time.perf_counter()
        images[index] = sess.image(seed, index)
        end = time.perf_counter()
        times.append(end - a)
        index += 1
        if end - start >= seconds:
            break
    if sess.mesh is not None:
        flag(0, sess.device)
    return end - start, times, images


def follow(sess: Session, seed: int) -> None:
    """A rank other than 0: render each image rank 0 announces, until it
    announces none."""
    while True:
        index = flag(0, sess.device) - 1
        if index < 0:
            return
        sess.image(seed, index)


def traced(sess: Session, seed: int, n_images: int):
    """Images 0 .. n_images - 1 under torch.profiler; (Trace, {index:
    image})."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace

    images = {}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if sess.device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        for index in range(n_images):
            if sess.mesh is not None:
                flag(index + 1, sess.device)
            images[index] = sess.image(seed, index)
        if sess.device.type == "cuda":
            torch.cuda.synchronize(sess.device)
    if sess.mesh is not None:
        flag(0, sess.device)
    return trace.read(prof, n_images), images
