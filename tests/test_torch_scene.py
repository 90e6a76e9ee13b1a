"""Scene compile of the torch port against the JAX package: every table
equal (both sides run the same numpy arithmetic on the host), then a
round trip through scene_data_from_numpy.

Also holds the helpers the other torch parity tests share: the JAX bench
scene pinned to the in-repo teapot_6k mesh, and the conversion of a JAX
SceneData into the port's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import bench
from cs397raytracingsp22_tpu_torch.models.scene import PACKED, SceneData, scene_data_from_numpy
from cs397raytracingsp22_tpu_torch.scenes import bench_scene as tbench
from cs397raytracingsp22_tpu_torch.scenes import cornell as tcornell
from scenes import cornell as jcornell

torch.set_num_threads(1)  # several test workers share the cores

TEAPOT_6K = tbench.TEAPOT_6K

_MESH_FIELDS = ("tri_verts", "tri_table", "tri_normals", "tri_uvs", "tri_tangent", "transform",
                "inv_transform", "normal_mat", "bounds_min", "bounds_max", "skip", "leaf_start",
                "leaf_count")
_STATIC = ("n_spheres", "n_planes", "n_tris", "n_volumes", "n_gvols", "gvol_eps", "kmesh_ranges",
           "ksl_ranges", "dense_mesh_ids", "mat_types_present", "n_lt_tri", "n_lt_sph",
           "nee_ok")


def jax_bench_scene(width=16, height=16, spp=4, path_depth=4, obj_path=TEAPOT_6K):
    """bench.build_bench_scene with its mesh pinned to obj_path (teapot_6k
    unless given, e.g. tbench.teapot_obj(9000))."""
    old = os.environ.get("RT_TEAPOT")
    os.environ["RT_TEAPOT"] = obj_path
    try:
        scene = bench.build_bench_scene(width, height, spp=spp, path_depth=path_depth)
    finally:
        if old is None:
            del os.environ["RT_TEAPOT"]
        else:
            os.environ["RT_TEAPOT"] = old
    assert len([o for o in scene.objects if type(o).__name__ == "StaticMesh"]) == 1
    return scene


def port_data_from_jax(jsd) -> SceneData:
    """The port's SceneData holding the JAX package's compiled tables."""
    arrays = {
        f.name: np.asarray(getattr(jsd, f.name))
        for f in dataclasses.fields(SceneData)
        if f.name not in _STATIC and f.name not in PACKED and f.name not in ("meshes", "gvol_tri")
    }
    arrays["gvol_tri"] = [np.asarray(x) for x in jsd.gvol_tri]
    arrays["meshes"] = [
        {**{k: np.asarray(getattr(m, k)) for k in _MESH_FIELDS}, "leaf_size": m.leaf_size,
         "tex_ids": m.tex_ids, "has_uv": m.has_uv}
        for m in jsd.meshes
    ]
    meta = {k: getattr(jsd, k) for k in _STATIC}
    meta["mesh_mat_ids"] = [m.mat_id for m in jsd.meshes]
    return scene_data_from_numpy(arrays, meta, device="cpu")


def assert_scene_data_equal(port: SceneData, jsd) -> None:
    """Every table the JAX package also compiles (it has no PACKED ones),
    the light tables lt_tri and lt_sph, Phong's point_light_pos and
    ambient, the texture atlas and the general volumes' rows, and the
    static fields, n_lt_tri, n_lt_sph, nee_ok, n_gvols and gvol_eps among
    them. Non-finite values (a tangent where the uv determinant is 0) must
    stand in the same places."""
    for f in dataclasses.fields(SceneData):
        name = f.name
        if name in PACKED:
            continue
        if name == "meshes":
            assert len(port.meshes) == len(jsd.meshes)
            for pm, jm in zip(port.meshes, jsd.meshes):
                assert pm.mat_id == jm.mat_id and pm.leaf_size == jm.leaf_size
                assert pm.tex_ids == tuple(jm.tex_ids) and pm.has_uv == jm.has_uv
                for k in _MESH_FIELDS:
                    a, b = pm.__dict__[k].numpy(), np.asarray(getattr(jm, k))
                    assert a.dtype == b.dtype, k
                    np.testing.assert_array_equal(a, b, err_msg=f"mesh.{k}")
        elif name == "gvol_tri":
            assert len(port.gvol_tri) == len(jsd.gvol_tri)
            for a, b in zip(port.gvol_tri, jsd.gvol_tri):
                assert a.dtype == torch.float32
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        elif name in _STATIC:
            assert getattr(port, name) == getattr(jsd, name), name
            assert type(getattr(port, name)) is type(getattr(jsd, name)), name
        else:
            a, b = getattr(port, name).numpy(), np.asarray(getattr(jsd, name))
            assert a.dtype == b.dtype, name
            assert a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module")
def bench_pair():
    return (tbench.build(16, 16, spp=4, path_depth=4).compile(device="cpu"),
            jax_bench_scene().compile())


def test_bench_scene_tables_equal(bench_pair):
    port, jsd = bench_pair
    assert port.kmesh_ranges == ((0, 6144),)
    assert port.dense_mesh_ids == (0,)
    assert_scene_data_equal(port, jsd)


def test_config3_tables_equal():
    port = tcornell.build_config3(16, 16, spp=4, path_depth=4).compile(device="cpu")
    jsd = jcornell.build_config3(16, 16, spp=4, path_depth=4).compile()
    assert_scene_data_equal(port, jsd)


def test_round_trip_from_numpy(bench_pair):
    port, jsd = bench_pair
    from_jax = port_data_from_jax(jsd)
    assert_scene_data_equal(from_jax, jsd)
    for name in PACKED:  # the kernel's tables, packed from the JAX package's
        np.testing.assert_array_equal(getattr(from_jax, name).numpy(),
                                      getattr(port, name).numpy(), err_msg=name)
    moved = port.to("cpu")
    assert moved.device == torch.device("cpu")
    assert_scene_data_equal(moved, jsd)


def test_compile_accepts_the_staged_path(tmp_path):
    """Textured meshes, materials synthesized from textures and
    general-boundary volumes compile; so do meshes beyond the dense budget
    (see test_big_mesh_tables_equal)."""
    from cs397raytracingsp22_tpu_torch import (
        ConvexVolume, Isotropic, Lambertian, Scene, StaticMesh, Triangle,
    )
    from cs397raytracingsp22_tpu_torch.utils.obj_loader import ObjMesh

    cam = tcornell.build(8, 8, spp=1).camera
    gvol = ConvexVolume(
        boundary=Triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), Lambertian()),
        phase_function=Isotropic(), density=1.0,
    )
    sd = Scene(camera=cam, objects=[gvol]).compile(device="cpu")
    assert sd.n_gvols == 1 and sd.n_volumes == 0 and sd.gvol_tri[0].shape == (1, 9)
    mesh = ObjMesh(
        positions=np.eye(3, dtype=np.float32), normals=np.eye(3, dtype=np.float32),
        texcoords=np.zeros((3, 2), np.float32), indices=np.array([[0, 1, 2]], np.int32),
        has_normals=True, has_texcoords=True,
    )
    textured = StaticMesh(mesh, [np.zeros((2, 2, 3), np.uint8)] + [None] * 4, None, np.eye(4))
    sd = Scene(camera=cam, objects=[textured]).compile(device="cpu")
    assert sd.meshes[0].mat_id == -1 and sd.meshes[0].tex_ids == (0, -1, -1, -1, -1)
    assert sd.tex_pixels.shape == (4, 3) and sd.dense_mesh_ids == (0,)
    n = 8200  # beyond the dense budget: a big mesh, which compiles
    big = ObjMesh(
        positions=np.random.default_rng(0).random((n + 2, 3)).astype(np.float32),
        normals=np.zeros((n + 2, 3), np.float32), texcoords=np.zeros((n + 2, 2), np.float32),
        indices=np.stack([np.arange(n), np.arange(n) + 1, np.arange(n) + 2], 1).astype(np.int32),
        has_normals=False, has_texcoords=False,
    )
    sd = Scene(camera=cam, objects=[StaticMesh(big, [None] * 5, Lambertian(), np.eye(4))]
               ).compile(device="cpu")
    assert sd.dense_mesh_ids == () and sd.meshes[0].tri_verts.shape == (n, 3, 3)


def test_big_mesh_tables_equal():
    """The bench scene with a 9,000-triangle teapot (beyond the dense
    budget): the BVH node arrays, the reordered triangles and normals and
    every other table equal the JAX package's compile bit for bit, and a
    round trip of the JAX tables through scene_data_from_numpy keeps them."""
    obj = tbench.teapot_obj(9000)
    port = tbench.build(16, 16, spp=4, path_depth=4, obj_path=obj).compile(device="cpu")
    jsd = jax_bench_scene(obj_path=obj).compile()
    assert port.dense_mesh_ids == () and port.kmesh_ranges == ()
    m = port.meshes[0]
    assert m.tri_verts.shape == (9000, 3, 3) and m.leaf_size == 4
    assert m.bounds_min.shape[0] == m.skip.shape[0] > 9000 // 4
    assert_scene_data_equal(port, jsd)
    assert_scene_data_equal(port_data_from_jax(jsd), jsd)


def test_entry_points_default_to_the_card(monkeypatch):
    """Scene.compile, compile_scene, scene_data_from_numpy and
    render_to_image run on the card unless the caller asks for the CPU;
    without a card, a call that does not name a device raises."""
    import inspect

    from cs397raytracingsp22_tpu_torch.models import scene as scene_mod
    from cs397raytracingsp22_tpu_torch.render import driver

    for fn in (scene_mod.Scene.compile, scene_mod.compile_scene,
               scene_mod.scene_data_from_numpy, driver.render_to_image):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = tcornell.build(8, 8, spp=1, path_depth=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        scene.compile()
    with pytest.raises(RuntimeError, match="CUDA"):
        scene_mod.compile_scene(scene)
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.render_to_image(scene, verbose=False)
    sd = scene.compile(device="cpu")
    assert sd.device == torch.device("cpu")


def test_bench_scene_refuses_a_missing_mesh(tmp_path):
    with pytest.raises(FileNotFoundError):
        tbench.build(8, 8, spp=1, obj_path=str(tmp_path / "absent.obj"))
