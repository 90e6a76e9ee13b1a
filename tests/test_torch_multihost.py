"""Multi-process rendering in the torch port (parallel/multihost.py) on the
CPU: the process-group set-up's refusals, and checkpoints under a mesh of
gloo ranks spawned on 127.0.0.1.

Only rank 0 writes the checkpoint, and a resume reads rank 0's file on
every rank (broadcast_checkpoint): here each rank is given a directory of
its own, and only rank 0's holds the file. Refusals of a checkpoint are
raised after that broadcast, so on every rank: no rank is left waiting in
a collective, and every process ends with an error well inside its
timeout. Each package resumes the other's `.npz` under a mesh: the port's
sharded resume of a JAX checkpoint equals its one-device resume bit for
bit (at spp_chunk / n_sp), and both packages' resumes are within 1 u8 of
the JAX package's uninterrupted render on every subpixel (the bound of
tests/test_torch_checkpoint.py).
"""

import os
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cs397raytracingsp22_tpu.parallel import sharding as jsharding
from cs397raytracingsp22_tpu.render import driver as jdriver
from cs397raytracingsp22_tpu_torch.parallel import multihost
from cs397raytracingsp22_tpu_torch.render import driver as tdriver
from tests.test_torch_checkpoint import HALF, SIDE, SPP, killed_render, render, scenes
from tests.test_torch_sharding import (
    RANK_TIMEOUT, assert_ranks_ok, checkpoint_accum, load_rank, run_ranks,
)

torch.set_num_threads(1)  # several test workers share the cores

MESH = (1, 2)  # two ranks, each half of every chunk's samples
CHUNKS = 4  # pixel chunks of an spp chunk (64 pixels in chunks of 16)


def job(name, **extra):
    """A WORKER job: the checkpoint tests' Cornell config 3 (8x8, 4 spp,
    depth 2, seed 5) at spp_chunk HALF over MESH, its checkpoint in
    <out>/ckpt/r<rank>/c.npz."""
    return dict(name=name, scene=["cornell", "build_config3",
                                  dict(width=SIDE, height=SIDE, spp=SPP, path_depth=2)],
                nee=False, render=dict(seed=5, spp_chunk=HALF, pixel_chunk=SIDE * SIDE // CHUNKS,
                                       checkpoint_path="{out}/ckpt/r{{rank}}/c.npz"), **extra)


def run_jobs(out, jobs):
    for j in jobs:
        j["render"]["checkpoint_path"] = j["render"]["checkpoint_path"].format(out=out)
    return run_ranks(out, MESH, jobs)


def rank_ckpt(out, rank):
    return os.path.join(out, "ckpt", f"r{rank}", "c.npz")


def test_initialize_argument_checks():
    """The JAX package's refusal of a topology without a coordinator, a
    coordinator without a topology, a CUDA device without a card; the
    default backend for the CPU is gloo."""
    with pytest.raises(ValueError, match="require coordinator_address"):
        multihost.initialize(num_processes=2, device="cpu")
    with pytest.raises(ValueError, match="require coordinator_address"):
        multihost.initialize(process_id=0, device="cpu")
    with pytest.raises(ValueError, match="needs num_processes and process_id"):
        multihost.initialize("127.0.0.1:1", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            multihost.initialize("127.0.0.1:1", 1, 0)
    assert not dist.is_initialized()
    assert multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0,
                                device="cpu") == (0, 1)
    try:
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


def test_two_rank_checkpoint_resume(tmp_path):
    """A 2-rank render killed at the first chunk of its second spp chunk
    leaves rank 0's checkpoint at HALF spp (rank 1's directory stays
    empty); the resume reads it on both ranks and equals the uninterrupted
    render, bit for bit in the image and the accumulator."""
    assert_ranks_ok(run_jobs(tmp_path, [job("killed", kill_after=CHUNKS), job("resumed")]))
    assert not os.path.exists(rank_ckpt(tmp_path, 1))
    _, scene = scenes(False)
    one, _ = tdriver.render_to_image(scene, device="cpu", seed=5, spp_chunk=HALF // MESH[1],
                                     checkpoint_path=str(tmp_path / "one_sp.npz"), verbose=False)
    for rank in range(2):
        img, stats = load_rank(tmp_path, "resumed", rank)
        np.testing.assert_array_equal(img, one)
        assert stats["primary_rays"] == SIDE * SIDE * (SPP - HALF)
    np.testing.assert_array_equal(checkpoint_accum(rank_ckpt(tmp_path, 0)),
                                  checkpoint_accum(str(tmp_path / "one_sp.npz")))


def test_misaligned_checkpoint_refused_on_both_ranks(tmp_path):
    """A checkpoint at spp_done 1 under a mesh whose sp axis is 2: both
    ranks raise after the broadcast and exit non-zero, well inside the
    timeout."""
    os.makedirs(os.path.dirname(rank_ckpt(tmp_path, 0)))
    np.savez(rank_ckpt(tmp_path, 0), accum=np.zeros((SIDE * SIDE, 3)), spp_done=np.int64(1),
             seed=np.int64(5), nee=np.int64(0))
    results, seconds = run_jobs(tmp_path, [job("refused")])
    for rank, (rc, log) in enumerate(results):
        assert rc != 0, f"rank {rank} did not fail:\n{log[-2000:]}"
        assert "spp_done=1 is not divisible by this mesh's sp axis (2)" in log, log[-2000:]
    assert seconds < RANK_TIMEOUT / 2


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_resumes_the_others_checkpoint_under_a_mesh(writer, tmp_path, monkeypatch):
    jscene, tscene = scenes(False)
    whole, _ = render(jdriver, jscene)
    if writer == "jax":
        # the JAX package's render killed at HALF spp; the port resumes it
        # over MESH, and on one device at spp_chunk / n_sp
        ckpt = str(tmp_path / "jax.npz")
        killed_render(jdriver, jscene, ckpt, monkeypatch)
        os.makedirs(os.path.dirname(rank_ckpt(tmp_path, 0)))
        shutil.copy(ckpt, rank_ckpt(tmp_path, 0))
        assert_ranks_ok(run_jobs(tmp_path, [job("resumed")]))
        resumed, stats = load_rank(tmp_path, "resumed", 0)
        one, _ = tdriver.render_to_image(tscene, device="cpu", seed=5, spp_chunk=HALF // MESH[1],
                                         checkpoint_path=ckpt, verbose=False)
        np.testing.assert_array_equal(resumed, one)
        np.testing.assert_array_equal(checkpoint_accum(rank_ckpt(tmp_path, 0)),
                                      checkpoint_accum(ckpt))
        assert stats["primary_rays"] == SIDE * SIDE * (SPP - HALF)
    else:
        # the port's render over MESH killed at HALF spp; the JAX package
        # resumes rank 0's file over its own 1x2 mesh
        assert_ranks_ok(run_jobs(tmp_path, [job("killed", kill_after=CHUNKS)]))
        with np.load(rank_ckpt(tmp_path, 0)) as f:
            assert int(f["spp_done"]) == HALF
        resumed, stats = jdriver.render_to_image(
            jscene, seed=5, spp_chunk=HALF, checkpoint_path=rank_ckpt(tmp_path, 0),
            verbose=False, mesh=jsharding.make_device_mesh(*MESH))
        assert stats.primary_rays == SIDE * SIDE * (SPP - HALF)
    diff = np.abs(np.asarray(resumed).astype(int) - np.asarray(whole).astype(int))
    assert diff.max() <= 1, f"{(diff > 1).sum()} subpixels off by > 1"
