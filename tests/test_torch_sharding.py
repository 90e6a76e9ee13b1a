"""Sharded rendering in the torch port (parallel/sharding.py) on the CPU:
gloo ranks spawned as processes on 127.0.0.1, against the one-device
render and against the JAX package's sharded render.

The contract, bit for bit in the u8 image and in the HDR accumulator
(the checkpoint rank 0 writes): a mesh with n_sp = 1 equals the one-device
render at the same spp_chunk; a mesh with n_sp > 1 and spp_chunk S equals
the one-device render at S / n_sp, since the sp partials are added one at
a time in sp order. Every rank returns the same image; only rank 0 writes
a checkpoint. Against the JAX package's render_to_image_sharded on its
8-virtual-device CPU mesh: within 1 u8 on >= 99% of subpixels, mean |diff|
<= 0.05 u8 (the port's image contract).

Each group of ranks runs under its own timeout (RANK_TIMEOUT): a hung rank
fails its test, and every process of the group is killed.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cs397raytracingsp22_tpu.parallel import sharding as jsharding
from cs397raytracingsp22_tpu_torch.parallel import multihost, sharding
from cs397raytracingsp22_tpu_torch.render import driver
from cs397raytracingsp22_tpu_torch.scenes import bench_scene, cornell
from scenes import cornell as jcornell

torch.set_num_threads(1)  # several test workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 120  # seconds for a whole group of ranks

# One rank: joins the gloo group, runs each job of the spec through
# render_to_image_multihost (a mesh of every rank, n_sp of the spec) and
# saves its image and stats.
# A job may kill its render after `kill_after` chunk calls (every rank
# raises at the same chunk, before its collectives); the file of a job
# that raised otherwise is missing and the rank exits non-zero.
WORKER = r"""
import dataclasses, importlib, json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
spec = json.loads(sys.argv[1])
from cs397raytracingsp22_tpu_torch.parallel import multihost
from cs397raytracingsp22_tpu_torch.render import driver
rank, world = spec["rank"], spec["world"]
multihost.initialize(f"127.0.0.1:{spec['port']}", world, rank, device="cpu")
part = torch.zeros(world)
part[rank] = rank + 1.0
np.save(os.path.join(spec["out"], f"gather_r{rank}.npy"), multihost.gather_to_host(part))
real = driver.render_chunk
for job in spec["jobs"]:
    module, fn, kw = job["scene"]
    scene = getattr(importlib.import_module("cs397raytracingsp22_tpu_torch.scenes." + module),
                    fn)(**kw)
    if job.get("nee"):
        scene = dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, nee=True))
    kw = dict(job["render"])
    if kw.get("checkpoint_path"):
        kw["checkpoint_path"] = kw["checkpoint_path"].format(rank=rank)
        os.makedirs(os.path.dirname(kw["checkpoint_path"]), exist_ok=True)
    calls = []

    def chunk(*a, _calls=calls, _kill=job.get("kill_after"), **k):
        _calls.append(1)
        if _kill is not None and len(_calls) > _kill:
            raise RuntimeError("killed")
        return real(*a, **k)

    driver.render_chunk = chunk
    try:
        img, st = multihost.render_to_image_multihost(scene, n_sp=spec["mesh"][1], device="cpu",
                                                      verbose=False, **kw)
    except RuntimeError as e:
        if "killed" not in str(e):
            raise
        continue
    finally:
        driver.render_chunk = real
    np.savez(os.path.join(spec["out"], f"{job['name']}_r{rank}.npz"), img=img,
             stats=json.dumps(dataclasses.asdict(st)), calls=len(calls))
torch.distributed.destroy_process_group()
"""


def run_bounded(cmds, cwd, log_dir, timeout=RANK_TIMEOUT):
    """Run the commands together, each leading a process group of its own,
    logging to log_dir/proc<i>.log; kill every one of them if they are not
    all done within `timeout` seconds, and fail. Returns [(returncode,
    log), ...] and the seconds they took."""
    t0 = time.monotonic()
    logs = [open(os.path.join(log_dir, f"proc{i}.log"), "w+") for i in range(len(cmds))]
    procs = [subprocess.Popen(cmd, cwd=cwd, stdout=log, stderr=subprocess.STDOUT,
                              start_new_session=True) for cmd, log in zip(cmds, logs)]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, timeout - (time.monotonic() - t0)))
    except subprocess.TimeoutExpired:
        pytest.fail(f"processes still running after {timeout} s: killed")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    out = []
    for p, log in zip(procs, logs):
        log.seek(0)
        out.append((p.returncode, log.read()))
        log.close()
    return out, time.monotonic() - t0


def run_ranks(out_dir, mesh, jobs, timeout=RANK_TIMEOUT):
    """Spawn the n_dp·n_sp ranks of `mesh` on 127.0.0.1 running WORKER's
    jobs; their files land in out_dir. Returns ([(rc, log), ...], seconds)."""
    world = mesh[0] * mesh[1]
    port = multihost.free_port()
    cmds = [[sys.executable, "-c", WORKER, json.dumps(dict(
        rank=r, world=world, port=port, mesh=list(mesh), out=str(out_dir), jobs=jobs))]
        for r in range(world)]
    return run_bounded(cmds, ROOT, out_dir, timeout)


def assert_ranks_ok(results):
    for rank, (rc, log) in enumerate(results[0]):
        assert rc == 0, f"rank {rank} exited {rc}:\n{log[-4000:]}"


def load_rank(out_dir, name, rank):
    with np.load(os.path.join(out_dir, f"{name}_r{rank}.npz")) as f:
        return f["img"], json.loads(str(f["stats"]))


def checkpoint_accum(path):
    with np.load(path) as f:
        return f["accum"]


SIZE, SPP, DEPTH = 16, 8, 3
# (name, scene: [module, build function, kwargs], nee, render kwargs) of each mesh's jobs
CORNELL = ("cornell", ["cornell", "build", dict(width=SIZE, height=SIZE, spp=SPP,
                                                path_depth=DEPTH)], False,
           dict(seed=3, spp_chunk=4, pixel_chunk=96))  # 3 chunks, the last ragged
NEE = ("nee", ["cornell", "build_config3", dict(width=SIZE, height=SIZE, spp=SPP,
                                                path_depth=DEPTH)], True,
       dict(seed=5, spp_chunk=4, pixel_chunk=64))
STAGED = ("staged", ["bench_scene", "build", dict(width=SIZE, height=SIZE, spp=4,
                                                  path_depth=DEPTH)], False,
          dict(seed=7, spp_chunk=4, pixel_chunk=128))
MESHES = {(1, 1): [CORNELL], (2, 1): [CORNELL, STAGED], (1, 2): [CORNELL],
          (2, 2): [CORNELL, NEE]}


def spec_of(job, out_dir):
    """WORKER's spec of a job, its checkpoint in out_dir/<name>/r<rank>/."""
    name, (module, fn, kw), nee, render = job
    if module == "bench_scene":  # the staged path: a mesh beyond the dense budget
        kw = dict(kw, obj_path=bench_scene.teapot_obj(9000))
    return dict(name=name, scene=[module, fn, kw], nee=nee,
                render=dict(render, checkpoint_path=os.path.join(str(out_dir), name,
                                                                 "r{rank}", "c.npz")))


def build_scene(spec):
    """The scene of a WORKER spec, built in this process."""
    module, fn, kw = spec["scene"]
    scene = getattr({"cornell": cornell, "bench_scene": bench_scene}[module], fn)(**kw)
    if spec["nee"]:
        scene = dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, nee=True))
    return scene


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """group(mesh) → the directory of that mesh's ranks' files, spawning
    the ranks on first use."""
    done = {}

    def group(mesh):
        if mesh not in done:
            out = tmp_path_factory.mktemp(f"mesh{mesh[0]}x{mesh[1]}")
            assert_ranks_ok(run_ranks(out, mesh, [spec_of(j, out) for j in MESHES[mesh]]))
            done[mesh] = out
        return done[mesh]

    return group


def assert_matches_one_device(out, mesh, job, tmp_path):
    """Every rank's image, and rank 0's accumulator, against the
    one-device render at spp_chunk / n_sp; only rank 0 wrote a checkpoint."""
    spec = spec_of(job, out)
    name, render = spec["name"], dict(spec["render"])
    n_dp, n_sp = mesh
    render.update(spp_chunk=render["spp_chunk"] // n_sp, checkpoint_path=str(tmp_path / "c.npz"))
    ref, ref_stats = driver.render_to_image(build_scene(spec), device="cpu", verbose=False,
                                            **render)
    for rank in range(n_dp * n_sp):
        img, stats = load_rank(out, name, rank)
        np.testing.assert_array_equal(img, ref, err_msg=f"{name} rank {rank}")
        assert stats["path_segments"] == ref_stats.path_segments
        assert stats["device_count"] == n_dp * n_sp
        assert stats["primary_rays"] == ref_stats.primary_rays
        assert os.path.exists(os.path.join(out, name, f"r{rank}", "c.npz")) == (rank == 0)
    np.testing.assert_array_equal(checkpoint_accum(os.path.join(out, name, "r0", "c.npz")),
                                  checkpoint_accum(render["checkpoint_path"]))
    assert ref.max() > 0


def test_make_device_mesh_checks():
    """Without a group a mesh is refused; in a world of one: n_sp <= 0 and
    a mesh that needs more ranks than the world has raise the JAX
    package's ValueErrors; the 1x1 mesh has the axes ("dp", "sp"), and
    render_to_image_sharded over it equals the one-device render."""
    with pytest.raises(RuntimeError, match="process group"):
        sharding.make_device_mesh()
    assert multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0,
                                device="cpu") == (0, 1)
    try:
        assert dist.get_backend() == "gloo"
        with pytest.raises(ValueError, match="n_sp must be positive, got 0"):
            sharding.make_device_mesh(1, 0)
        with pytest.raises(ValueError, match=r"mesh 2x1 needs 2 devices, have 1"):
            sharding.make_device_mesh(2, 1)
        with pytest.raises(ValueError, match=r"mesh 0x2 needs 0 devices, have 1"):
            sharding.make_device_mesh(n_sp=2)
        mesh = sharding.make_device_mesh()
        assert mesh.shape == (1, 1) and mesh.mesh_dim_names == ("dp", "sp")
        assert sharding.mesh_axes(mesh) == (1, 1, 0, 0)
        x = torch.arange(6.0).reshape(2, 3)
        np.testing.assert_array_equal(multihost.gather_to_host(x), x.numpy())
        scene = cornell.build(width=8, height=8, spp=2, path_depth=2)
        img, stats = sharding.render_to_image_sharded(scene, mesh, seed=3, device="cpu",
                                                      verbose=False)
        ref, _ = driver.render_to_image(scene, device="cpu", seed=3, verbose=False)
        np.testing.assert_array_equal(img, ref)
        assert stats.device_count == 1
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh", [(1, 1), (2, 1), (1, 2), (2, 2)],
                         ids=["1x1", "2x1", "1x2", "2x2"])
def test_mesh_matches_one_device(mesh, groups, tmp_path):
    """Cornell 16x16, 8 spp, depth 3 (K1's path): every rank's image and
    the accumulator bit for bit against one device at spp_chunk / n_sp,
    over chunks with a ragged tail; gather_to_host sums the ranks' parts."""
    out = groups(mesh)
    assert_matches_one_device(out, mesh, CORNELL, tmp_path)
    world = mesh[0] * mesh[1]
    for rank in range(world):
        np.testing.assert_array_equal(np.load(os.path.join(out, f"gather_r{rank}.npy")),
                                      np.arange(1.0, world + 1))


def test_nee_mesh_2x2(groups, tmp_path):
    """NEE on Cornell config 3 over a 2x2 mesh: bit for bit against one
    device at spp_chunk / 2."""
    assert_matches_one_device(groups((2, 2)), (2, 2), NEE, tmp_path)


def test_staged_mesh_2x1(groups, tmp_path):
    """The staged path (the bench scene with a 9,000-triangle teapot) over
    a 2x1 mesh: each rank compacts its own shard; bit for bit against one
    device."""
    assert_matches_one_device(groups((2, 1)), (2, 1), STAGED, tmp_path)


def test_spp_not_divisible_by_sp_raises(tmp_path):
    """spp 3 over a 1x2 mesh: both ranks refuse before any collective and
    exit non-zero."""
    job = spec_of(CORNELL, tmp_path)
    job["scene"][2] = dict(job["scene"][2], spp=3)
    job["render"] = dict(seed=3)
    results, seconds = run_ranks(tmp_path, (1, 2), [job])
    for rc, log in results:
        assert rc != 0 and "spp 3 not divisible by the mesh's sp axis 2" in log, log[-2000:]
    assert seconds < RANK_TIMEOUT / 2


def test_mesh_2x2_matches_jax(groups):
    """The port's 2x2 image against the JAX package's render_to_image_sharded
    on its own 2x2 mesh of virtual CPU devices."""
    img, _ = load_rank(groups((2, 2)), "cornell", 0)
    jscene = jcornell.build(width=SIZE, height=SIZE, spp=SPP, path_depth=DEPTH)
    ref, _ = jsharding.render_to_image_sharded(jscene, jsharding.make_device_mesh(2, 2), seed=3,
                                               verbose=False, spp_chunk=4)
    diff = np.abs(img.astype(int) - np.asarray(ref).astype(int))
    assert (diff <= 1).mean() >= 0.99, f"{(diff > 1).sum()} subpixels off by > 1"
    assert diff.mean() <= 0.05, f"mean |diff| {diff.mean():.4f}"
