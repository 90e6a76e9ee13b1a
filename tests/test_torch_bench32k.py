"""The CLI's default scene (scenes/bench_teapot_32k.py: the bench room with
its 32,832-triangle teapot, past the dense budget) on the mega-bounce
kernel K1, which walks the big mesh's BVH (csrc/intersect.cuh::
walk_big_mesh over csrc/bvh_walk.cuh, the step the big-mesh kernel K3
shares), and the benchmark's configuration and cell of it
(bench_teapot_32k, bench32k.k1).

On the CPU: K1's gate takes the configuration and still refuses what it
cannot render; the bench teapot_6k scene's tables are as they were; the
plain version's big-walk counts; K1's plain version on the configuration,
cut to 24² × 2 spp, against the benchmark's plain reference
(benchmark/reference/tracer.py) within the cell's limits; the committed
mesh is utils/subdivide.py's output; the benchmark finds the new files by
name; the frozen count over every mesh (benchmark/reference/
bigmesh_walk.py) gives walk.k1_image_bound's count on bench_teapot_6k.

On the card (marked `gpu`, skipped without one; the file imports no JAX):
K1's rows on chunk 0 of the configuration, sampled, against the plain
version; the registers and spills of K1's instantiations without the
big-mesh walk as recorded; K4 refusing a big mesh; a render launching K1
alone. Run them there:

    python -m pytest tests/test_torch_bench32k.py -q -m gpu
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from benchmark import cells, check, port_scene
from benchmark.reference import bigmesh_walk, walk
from benchmark.reference import scene as ref_scene
from benchmark.reference import tracer
from cs397raytracingsp22_tpu_torch import Lambertian, Scene, Sphere, StaticMesh
from cs397raytracingsp22_tpu_torch.models import transform as tf
from cs397raytracingsp22_tpu_torch.ops import intersect as isect
from cs397raytracingsp22_tpu_torch.ops.kernels import bounce
from cs397raytracingsp22_tpu_torch.ops.tonemap import tonemap
from cs397raytracingsp22_tpu_torch.render import driver, integrator
from cs397raytracingsp22_tpu_torch.scenes import bench_scene, drone_demo
from cs397raytracingsp22_tpu_torch.tools import walk_counts
from cs397raytracingsp22_tpu_torch.utils import subdivide, threefry

torch.set_num_threads(1)  # several test workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "bench32k.k1"
MESH = "benchmark/data/teapot_32k.obj"
MESH_6K = "benchmark/data/teapot_6k.obj"
MAX_DIST = 100.0


def _config(name="bench_teapot_32k"):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


def _camera(config, width, spp, depth):
    return dict(config["scene"]["camera"], screen_width=width, screen_height=width,
                aa_sample_count=spp, path_depth=depth)


def _port(width=8, spp=1, depth=8, device="cpu", config=None):
    """(Scene, SceneData) of the configuration through the renderer's public
    API (benchmark/port_scene.py), cut to width² × spp at `depth`."""
    config = config or _config()
    scene = port_scene.build(config, _camera(config, width, spp, depth), cells.files_of(config))
    return scene, scene.compile(device=device)


def _teapot(obj, material, transform=tf.translate(0.0, 0.75, -0.6) @ tf.rotate_x(-90.0)):
    return StaticMesh.load_from_file(obj, material=material, transform=transform)


# ---------------------------------------------------------------- the gate


def test_gate_takes_the_configuration():
    _, sd = _port()
    assert sd.dense_mesh_ids == () and sd.meshes[0].tri_verts.shape[0] == 32832
    assert bounce.big_meshes(sd) == [sd.meshes[0]] and bounce.big_depth(sd) == 14
    assert bounce.scene_is_simple(sd)
    # the table, then the big mesh's kmesh_xfm row and 128 stacks of its depth
    assert bounce.k1_staged_bytes(sd) == bounce.staged_bytes(sd) + 144 + 8 * 128 * 14
    assert bounce.k1_staged_bytes(sd) <= bounce.MAX_STAGED_BYTES


def _gate_cases():
    white = Lambertian(albedo=(0.73, 0.73, 0.73))
    cam = bench_scene.build(8, 8, 1).camera
    big = bench_scene.teapot_obj(9000)
    return {
        "demo_scene": lambda: drone_demo.build(8, 8, 1),
        "two_big_meshes": lambda: Scene(camera=cam, objects=[
            _teapot(big, white, tf.translate(float(i), 0.0, -3.0)) for i in range(2)]),
        "big_mesh_and_sphere_tree": lambda: Scene(camera=cam, objects=[
            _teapot(big, white)] + [Sphere(center=(float(i), 0.0, -9.0), radius=0.4,
                                           material=white) for i in range(64)]),
        "big_mesh_beside_a_dense_one": lambda: Scene(camera=cam, objects=[
            _teapot(big, white, tf.translate(1.0, 0.0, -3.0)),
            _teapot(bench_scene.TEAPOT_6K, white)]),
    }


@pytest.mark.parametrize("name", ["demo_scene", "two_big_meshes", "big_mesh_and_sphere_tree",
                                  "big_mesh_beside_a_dense_one"])
def test_gate_refuses_what_k1_cannot_render(name):
    """demo_scene's 32,512-triangle sphere (textured, normal-mapped) stays on
    the staged path with K3; so does a big mesh beside another mesh, big or
    dense, or beside a sphere tree: K1 walks one big mesh, the scene's only
    mesh."""
    sd = _gate_cases()[name]().compile(device="cpu")
    assert bounce.big_meshes(sd)
    assert not bounce.scene_is_simple(sd)


def test_bench_teapot_6k_tables_unchanged():
    """The tables K1 reads for the bench teapot_6k scene (bench.k1), bit for
    bit as before the big-mesh walk (digests recorded from the parent's
    compile), and no big-mesh launch arguments."""
    _, sd = _port(16, 4, 8, config=_config("bench_teapot_6k"))
    digests = {"kscene": "ab22b51652e57876", "ksl_tree": "4476d09226c2ddee",
               "kmesh_tri4": "66408f55ebf5356a", "kmesh_nrm": "f4136afd628d0b66",
               "ksph_tree": "374708fff7719dd5", "kmesh_xfm": "9312960709f24bd7",
               "kmesh_res": "765d6d788a75c67f"}
    for key, want in digests.items():
        got = hashlib.sha256(getattr(sd, key).numpy().tobytes()).hexdigest()[:16]
        assert got == want, key
    assert bounce.big_meshes(sd) == [] and bounce.big_depth(sd) == 0
    assert bounce.k1_staged_bytes(sd) == bounce.staged_bytes(sd) == 25248


# ---------------------------------------------------------------- counts


def test_plain_counts_the_big_walk():
    """intersect_scene_plain's stats count the big mesh's BVH walk
    (ops/bvh.py::traverse_packed within [t_min, min(t_hit, t_max)]): dead
    rays none, every teapot winner at least one triangle, nothing on a
    scene without a big mesh; tools/walk_counts reports them."""
    n = 48 * 48
    sc, sd = _port(48, 1, 8)
    o, d, _ = driver._gen_chunk_rays(sc.camera, torch.arange(n, dtype=torch.int32), 3, 0, 1, 1)
    t_max = torch.full((n,), MAX_DIST)
    t_max[::16] = 0.0  # dead rays
    u_vol = torch.zeros((n, 1))
    stats: dict = {}
    hit = isect.intersect_scene_plain(sd, o, d, integrator.PATH_T_MIN, t_max, u_vol, stats=stats)
    nodes, tris = stats["big_nodes"], stats["big_tris"]
    assert (nodes[::16] == 0).all() and (tris[::16] == 0).all()
    teapot = isect.intersect_mesh_plain(sd.meshes[0], sd, o, d, integrator.PATH_T_MIN, t_max)
    won = teapot["valid"] & (teapot["t"] == hit.t)
    assert int(won.sum()) >= 20 and (tris[won] >= 1).all() and (nodes[won] >= 3).all()
    assert int(nodes.sum()) > int(tris.sum()) > 0
    _, sd6 = _port(16, 1, 8, config=_config("bench_teapot_6k"))
    stats6: dict = {}
    isect.intersect_scene_plain(sd6, o, d, integrator.PATH_T_MIN, t_max, u_vol, stats=stats6)
    assert int(stats6["big_nodes"].sum()) == int(stats6["big_tris"].sum()) == 0
    rows = walk_counts.walk_counts(2, "cpu", mesh="32k")
    assert len(rows) == 8 and all(r["nodes"] >= 1.0 for r in rows)


# ---------------------------------------------------------------- parity


def test_cpu_render_matches_the_plain_reference():
    """The port's CPU path (render_chunk → K1's plain version,
    integrator.path_trace, on a scene that passes the gate) against the
    benchmark's plain reference on the same seed: ray by ray within K1's
    parity contract (rtol 1e-3 / atol 1e-4 on >= 99.5% of rays), and the
    u8 pixels within the cell's limits."""
    w, spp, depth, seed = 24, 2, 8, 3000000019
    config = _config()
    scene, sd = _port(w, spp, depth)
    assert bounce.scene_is_simple(sd)
    ref = ref_scene.build(dict(config["scene"], camera=_camera(config, w, spp, depth)),
                          cells.files_of(config), "cpu")
    pix = torch.arange(w * w)
    key = threefry.key_words(seed)
    o, d, uids = driver._gen_chunk_rays(scene.camera, pix.to(torch.int32), key, 0, spp, 1)
    rad, segs = bounce.path_trace_cuda(sd, o, d, uids, key, depth, MAX_DIST)
    ro, rd, ru = tracer.camera_rays(ref, seed, pix)
    assert torch.equal(o, ro) and torch.equal(d, rd)
    stats: list = []
    want = tracer.trace(ref, ro, rd, ru, seed, False, stats=stats)
    ok = np.isclose(rad.numpy(), want.numpy(), rtol=1e-3, atol=1e-4).all(axis=1)
    assert ok.mean() >= 0.995, f"{int((~ok).sum())} of {ok.size} rays outside rtol 1e-3 / atol 1e-4"
    assert abs(int(segs) - sum(x[0].shape[0] for x in stats)) <= depth * int((~ok).sum())
    got = tonemap(rad.reshape(w * w, spp, 3).sum(dim=1) / spp, 2.0).numpy()
    ref_u8 = tracer.tonemap(want.reshape(w * w, spp, 3).sum(dim=1) / spp, 2.0).numpy()
    vals = check.numbers([got], [ref_u8])
    with open(os.path.join(ROOT, "benchmark", "workloads", f"{CELL}.json")) as f:
        limits = json.load(f)["check"]["limits"]
    assert all(vals[k] <= limits[k] for k in check.NUMBERS), vals
    assert float(rad.max()) > 0 and int((rad.sum(dim=1) > 0).sum()) > 50  # lit


# ---------------------------------------------------------------- the benchmark


def test_committed_mesh_is_the_subdividers_output(tmp_path):
    """benchmark/data/teapot_32k.obj is utils/subdivide.py's output from
    benchmark/data/teapot_6k.obj at the scene's target, byte for byte (the
    header names the source as given, relative to the root)."""
    out = tmp_path / "teapot_32k.obj"
    subdivide.write_obj(str(out), MESH_6K, *subdivide.subdivide_to(
        os.path.join(ROOT, MESH_6K), 32768))

    def sha(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    assert sha(out) == sha(os.path.join(ROOT, MESH))
    scene, _ = _port()
    mesh = [o for o in scene.objects if isinstance(o, StaticMesh)][0]
    assert mesh.mesh.num_triangles == 32832


def test_benchmark_finds_the_new_files_by_name():
    cell = cells.load_cell(CELL)
    assert (cell.config["name"], cell.traffic["name"], cell.chips) == (
        "bench_teapot_32k", "frames.path", 1)
    assert cell.config["reduced"] == [] and cell.spec["trace_images"] == 20
    assert cell.spec["check"] == {"images": 2, "pixels": 4096,
                                  "limits": cell.spec["check"]["limits"]}
    assert cells.files_of(cell.config) == {"teapot_32k.obj": os.path.join(ROOT, MESH)}
    # the 6k configuration but for the mesh, every width as the CLI renders it
    six, big = _config("bench_teapot_6k")["scene"], cell.config["scene"]
    assert big["camera"] == six["camera"] and big["materials"] == six["materials"]
    assert [o.get("obj", "") for o in big["objects"]][-1] == "teapot_32k.obj"
    assert [dict(o, obj="") for o in big["objects"]] == [dict(o, obj="") for o in six["objects"]]
    e2e, per_layer = cells.cell_metrics(CELL)
    assert [m["name"] for m in e2e] == ["setup_s", "image_s", "peak_mem_gib"]
    assert [m["name"] for m in per_layer] == ["idle_share", "driver_idle_share",
                                              "k1_bigmesh_roofline"]
    reader = cells.metric_reader("k1_bigmesh_roofline")
    assert reader.read({}) is None and reader.read({"trace": None}) is None
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = [c for c in bench["configs"] if c["name"] == "bench_teapot_32k"][0]
    assert entry["file"] == "benchmark/configs/bench_teapot_32k.json" and entry["reduced"] == []
    metric = [m for m in bench["per_layer"] if m["name"] == "k1_bigmesh_roofline"][0]
    assert metric["layer"] == "ops.kernels.bounce (K1), big-mesh walk"
    assert (metric["moves"], metric["workloads"]) == ("image_s", [CELL])


def _ref(config, width, spp):
    return ref_scene.build(dict(config["scene"], camera=_camera(config, width, spp, 8)),
                           cells.files_of(config), "cpu")


def test_bigmesh_count_is_the_frozen_count():
    """On bench_teapot_6k (one dense mesh) the count over every mesh gives
    walk.k1_image_bound's nodes, triangles and bytes; on the 32k
    configuration it counts the big mesh, which k1_image_bound leaves out."""
    six = _ref(_config("bench_teapot_6k"), 32, 4)
    a = walk.k1_image_bound(six, 77, stride=5)
    b = bigmesh_walk.k1_bigmesh_image_bound(six, 77, stride=5, block=300)
    for key in ("nodes", "tris", "bytes", "ops", "segments", "seconds"):
        assert a[key] == b[key], key
    assert a["tris"] > 0
    big = _ref(_config(), 32, 4)
    c = bigmesh_walk.k1_bigmesh_image_bound(big, 77, stride=5)
    assert walk.k1_image_bound(big, 77, stride=5)["tris"] == 0
    assert c["tris"] > 0 and c["nodes"] > c["segments"]
    assert c["bytes"] > 32832 * 48


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _chunk0(scene, sd, key, dev):
    cam = scene.camera
    px = driver.chunk_pixels(sd, cam, cam.aa_sample_count)
    n_chunks = -(-cam.screen_width * cam.screen_height // px)
    ids = torch.arange(px, dtype=torch.int32, device=dev) * n_chunks
    return driver._gen_chunk_rays(cam, ids, key, 0, cam.aa_sample_count, 1)


@pytest.mark.gpu
def test_k1_big_matches_the_plain_version_on_card(cuda):
    """K1 (bounce_kernel_big) on chunk 0 of the configuration at full size
    (4,194,304 rays): every 61st ray traced alone gives the launch's rows
    bit for bit, and K1's parity contract against the plain version on
    the radiance (rtol 1e-3 / atol 1e-4 on >= 99.5% of rays). Segments are
    held ray by ray to the same share: at this mesh's scale many triangles
    sit near the |det| >= 1e-4 reject (C4), where K1's contracted
    multiply-adds can keep a hit the plain version drops, and a path that
    gathers no light there changes its length and not its radiance (2 of
    548,328 segments on one seed, all 68,760 rays within the radiance
    tolerance), which the radiance-based budget of the other scenes'
    contract does not allow for."""
    scene, sd = _port(512, 64, 8, device=cuda)
    key = threefry.key_words(20261018)
    o, d, uids = _chunk0(scene, sd, key, cuda)
    assert o.shape[0] == 4194304
    rad, _ = bounce.path_trace_cuda(sd, o, d, uids, key, 8, MAX_DIST)
    idx = torch.arange(0, o.shape[0], 61, device=cuda)
    sub = (o[idx].contiguous(), d[idx].contiguous(), uids[idx].contiguous())
    stats: dict = {}
    rad_s, _ = bounce.path_trace_cuda(sd, *sub, key, 8, MAX_DIST, stats=stats)
    assert torch.equal(rad_s, rad[idx])
    ref_stats: dict = {}
    ref_rad, _ = integrator.path_trace(sd, *sub, key, 8, MAX_DIST, stats=ref_stats)
    assert float(ref_rad.max()) > 0.0 and bool(torch.isfinite(rad_s).all())
    ok = torch.isclose(rad_s, ref_rad, rtol=1e-3, atol=1e-4).all(dim=1)
    assert float(ok.float().mean()) >= 0.995, int((~ok).sum())
    same_segs = stats["segs"] == ref_stats["segs"]
    assert float(same_segs.float().mean()) >= 0.995, int((~same_segs).sum())


@pytest.mark.gpu
def test_k1_big_mesh_under_a_scale_matches_the_plain_version_on_card(cuda):
    """bounce_kernel_big on a big teapot scaled, turned and moved off the
    room's centre (its kmesh_xfm row's transforms and the normal matrix
    under a scale), with a material of its own, against the plain
    version: K1's parity contract on the camera rays of a 64² × 16 spp
    image."""
    from test_torch_bounce_kernel import assert_paths_match

    big = bench_scene.teapot_obj(9000)
    base = bench_scene.build(64, 64, spp=16, path_depth=8)
    sc = Scene(camera=base.camera, objects=list(base.objects[:-1]) + [
        _teapot(big, Lambertian(albedo=(0.2, 0.3, 0.8)),
                tf.translate(0.6, 0.2, -0.8) @ tf.rotate_y(30.0) @ tf.rotate_x(-90.0)
                @ tf.scale(2.5))])
    sd = sc.compile(device=cuda)
    assert sd.dense_mesh_ids == () and len(bounce.big_meshes(sd)) == 1
    key = threefry.key_words(4242)
    o, d, uids = _chunk0(sc, sd, key, cuda)
    rad, segs = bounce.path_trace_cuda(sd, o, d, uids, key, 8, MAX_DIST)
    ref_rad, ref_segs = integrator.path_trace(sd, o, d, uids, key, 8, MAX_DIST)
    assert float(ref_rad.max()) > 0.0
    assert_paths_match(rad.cpu().numpy(), segs.cpu(), ref_rad.cpu().numpy(), ref_segs.cpu(),
                       depth=8)


# (registers, local spill bytes) of K1's instantiations without the big-mesh
# walk, as the build before the walk gave them on an H100 (nvcc 12.9.86): the
# walk must leave them as they were
RECORDED_ATTRS = {(True, False): (91, 0), (False, False): (48, 0), (True, True): (91, 0),
                  (False, True): (61, 0)}


@pytest.mark.gpu
@pytest.mark.parametrize("dense, sph_tree", sorted(RECORDED_ATTRS))
def test_instantiations_keep_their_registers(cuda, dense, sph_tree):
    assert bounce.kernel_attrs(dense, sph_tree) == RECORDED_ATTRS[(dense, sph_tree)]
    assert bounce.kernel_attrs(big=True)[1] == 0  # the big walk spills nothing


@pytest.mark.gpu
def test_wavefront_refuses_a_big_mesh(cuda):
    from cs397raytracingsp22_tpu_torch.ops.kernels import wavefront

    scene, sd = _port(8, 1, 8, device=cuda)
    o, d, uids = _chunk0(scene, sd, 1, cuda)
    with pytest.raises(ValueError, match="dense budget"):
        wavefront.path_trace_wavefront(sd, o, d, uids, 1, 8, MAX_DIST)


@pytest.mark.gpu
def test_render_launches_k1_alone(cuda):
    from cs397raytracingsp22_tpu_torch.ops.kernels import scene_intersect, tri_scan_big

    scene, sd = _port(64, 4, 8, device=cuda)
    k1, k2, k3 = bounce.LAUNCHES, scene_intersect.LAUNCHES, tri_scan_big.LAUNCHES
    img, stats = driver.render_to_image(scene, device=cuda, seed=5, verbose=False, scene_data=sd)
    assert bounce.LAUNCHES - k1 == stats.chunks >= 1
    assert (scene_intersect.LAUNCHES, tri_scan_big.LAUNCHES) == (k2, k3)
    assert img.max() > 0
