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

_MESH_FIELDS = ("tri_verts", "tri_table", "tri_normals", "transform", "inv_transform",
                "normal_mat")
_STATIC = ("n_spheres", "n_planes", "n_tris", "n_volumes", "kmesh_ranges",
           "ksl_ranges", "dense_mesh_ids", "mat_types_present")


def jax_bench_scene(width=16, height=16, spp=4, path_depth=4):
    """bench.build_bench_scene with its mesh pinned to teapot_6k."""
    old = os.environ.get("RT_TEAPOT")
    os.environ["RT_TEAPOT"] = TEAPOT_6K
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
        if f.name not in _STATIC and f.name not in PACKED and f.name != "meshes"
    }
    arrays["meshes"] = [
        {k: np.asarray(getattr(m, k)) for k in _MESH_FIELDS} for m in jsd.meshes
    ]
    meta = {k: getattr(jsd, k) for k in _STATIC}
    meta["mesh_mat_ids"] = [m.mat_id for m in jsd.meshes]
    return scene_data_from_numpy(arrays, meta)


def assert_scene_data_equal(port: SceneData, jsd) -> None:
    """Every table the JAX package also compiles (it has no PACKED ones)."""
    for f in dataclasses.fields(SceneData):
        name = f.name
        if name in PACKED:
            continue
        if name == "meshes":
            assert len(port.meshes) == len(jsd.meshes)
            for pm, jm in zip(port.meshes, jsd.meshes):
                assert pm.mat_id == jm.mat_id
                for k in _MESH_FIELDS:
                    a, b = pm.__dict__[k].numpy(), np.asarray(getattr(jm, k))
                    assert a.dtype == b.dtype, k
                    np.testing.assert_array_equal(a, b, err_msg=f"mesh.{k}")
        elif name in _STATIC:
            assert getattr(port, name) == getattr(jsd, name), name
        else:
            a, b = getattr(port, name).numpy(), np.asarray(getattr(jsd, name))
            assert a.dtype == b.dtype, name
            assert a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module")
def bench_pair():
    return tbench.build(16, 16, spp=4, path_depth=4).compile(), jax_bench_scene().compile()


def test_bench_scene_tables_equal(bench_pair):
    port, jsd = bench_pair
    assert port.kmesh_ranges == ((0, 6144),)
    assert port.dense_mesh_ids == (0,)
    assert_scene_data_equal(port, jsd)


def test_config3_tables_equal():
    port = tcornell.build_config3(16, 16, spp=4, path_depth=4).compile()
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


def test_compile_refuses_the_staged_path(tmp_path):
    from cs397raytracingsp22_tpu_torch import (
        ConvexVolume, Isotropic, Lambertian, Scene, StaticMesh, Triangle,
    )
    from cs397raytracingsp22_tpu_torch.utils.obj_loader import ObjMesh

    cam = tcornell.build(8, 8, spp=1).camera
    gvol = ConvexVolume(
        boundary=Triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), Lambertian()),
        phase_function=Isotropic(), density=1.0,
    )
    with pytest.raises(NotImplementedError, match="staged path"):
        Scene(camera=cam, objects=[gvol]).compile()
    mesh = ObjMesh(
        positions=np.eye(3, dtype=np.float32), normals=np.eye(3, dtype=np.float32),
        texcoords=np.zeros((3, 2), np.float32), indices=np.array([[0, 1, 2]], np.int32),
        has_normals=True, has_texcoords=True,
    )
    textured = StaticMesh(mesh, [np.zeros((2, 2, 3), np.uint8)] + [None] * 4, None, np.eye(4))
    with pytest.raises(NotImplementedError, match="staged path"):
        Scene(camera=cam, objects=[textured]).compile()
    n = 8200  # beyond the dense budget
    big = ObjMesh(
        positions=np.random.default_rng(0).random((n + 2, 3)).astype(np.float32),
        normals=np.zeros((n + 2, 3), np.float32), texcoords=np.zeros((n + 2, 2), np.float32),
        indices=np.stack([np.arange(n), np.arange(n) + 1, np.arange(n) + 2], 1).astype(np.int32),
        has_normals=False, has_texcoords=False,
    )
    with pytest.raises(NotImplementedError, match="staged path"):
        Scene(camera=cam, objects=[StaticMesh(big, [None] * 5, Lambertian(), np.eye(4))]).compile()


def test_bench_scene_refuses_a_missing_mesh(tmp_path):
    with pytest.raises(FileNotFoundError):
        tbench.build(8, 8, spp=1, obj_path=str(tmp_path / "absent.obj"))
