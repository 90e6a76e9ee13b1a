"""K1, the CUDA mega-bounce kernel, against its plain torch version on the
card. Needs a CUDA device: the tests are marked `gpu` and skip without
one. Run them on a machine with the card:

    python -m pytest tests/test_torch_bounce_kernel.py -q

The file imports no JAX (the scene builders here take the package as an
argument, so the JAX parity tests share them). Tolerance: the one of
tests/test_torch_path_trace.py — rtol 1e-3, atol 1e-4 on at least 99.5%
of rays, segment totals within depth × (rays outside the tolerance).
"""

import numpy as np
import pytest
import torch

import cs397raytracingsp22_tpu_torch as T
from cs397raytracingsp22_tpu_torch.models import transform as tf
from cs397raytracingsp22_tpu_torch.ops.kernels import bounce
from cs397raytracingsp22_tpu_torch.render import integrator
from cs397raytracingsp22_tpu_torch.scenes import bench_scene, cornell
from cs397raytracingsp22_tpu_torch.utils import obj_loader

DEPTH = 4
N = 512


def tri_mesh(P, loader, material, transform):
    """One triangle as a StaticMesh of package P (the mesh of the JAX
    package's test_bounce_kernel.py bench_like_scene)."""
    pos = np.asarray([[-1.0, 0.0, -1.0], [1.0, 0.0, -1.0], [0.0, 1.5, -1.0]], np.float32)
    nrm = np.zeros_like(pos)
    nrm[:, 2] = 1.0
    m = loader.ObjMesh(
        positions=pos, normals=nrm, texcoords=np.zeros((3, 2), np.float32),
        indices=np.asarray([[0, 1, 2]], np.int32), has_normals=True, has_texcoords=True,
    )
    return P.StaticMesh(m, [None] * 5, material, transform)


def bench_like(P, cornell_mod, loader):
    """Cornell config 3 plus a metal one-triangle mesh (bounce kernel
    tests of the JAX package, test_bounce_kernel.py:14-30)."""
    base = cornell_mod.build_config3(width=16, height=16, spp=4, path_depth=DEPTH)
    mesh = tri_mesh(
        P, loader, P.Metal(albedo=(0.7, 0.7, 0.9), roughness=0.15),
        tf.translate(0.0, 0.4, 0.4) @ tf.rotate_y(25.0),
    )
    return P.Scene(camera=base.camera, objects=list(base.objects) + [mesh])


def volume_parameterized(P):
    """Two sphere-bounded volumes and ParameterizedMaterial surfaces."""
    cam = P.Camera(eyepoint=(0.0, 1.5, 4.0), screen_width=16, screen_height=8,
                   aa_sample_count=4, focal_length=0.8)
    return P.Scene(camera=cam, objects=[
        P.Plane(point=(0, 0, 0), normal=(0, 1, 0),
                material=P.ParameterizedMaterial(albedo=(0.8, 0.6, 0.4), roughness=0.3,
                                                 metallic=0.4)),
        P.Plane(point=(0, 0, -4), normal=(0, 0, 1), material=P.Lambertian(albedo=(0.5, 0.5, 0.5))),
        P.Sphere(center=(0, 8, -3), radius=2.5,
                 material=P.Lambertian(albedo=(0, 0, 0), emission=(4, 4, 4))),
        P.Sphere(center=(1.2, 0.6, -1.0), radius=0.6,
                 material=P.ParameterizedMaterial(albedo=(0.2, 0.7, 0.3), roughness=0.05,
                                                  metallic=0.9, emission=(0.0, 0.3, 0.0))),
        P.ConvexVolume(
            boundary=P.Sphere(center=(-0.5, 1.2, -1.5), radius=1.0, material=P.Lambertian()),
            phase_function=P.Isotropic(albedo=(0.9, 0.9, 0.9)), density=1.5,
        ),
        P.ConvexVolume(
            boundary=P.Sphere(center=(0.8, 2.0, -2.0), radius=0.7, material=P.Lambertian()),
            phase_function=P.Isotropic(albedo=(0.6, 0.8, 0.9)), density=0.7,
        ),
    ])


def assert_paths_match(rad, segs, ref_rad, ref_segs, depth=DEPTH, min_frac=0.995):
    """K1's parity contract: rtol 1e-3, atol 1e-4 on >= 99.5% of rays (a
    winner flip at a triangle edge re-rolls one path), segment totals
    within depth × (rays outside the tolerance). Returns the count of
    rays outside the tolerance."""
    rad, ref_rad = np.asarray(rad), np.asarray(ref_rad)
    assert rad.shape == ref_rad.shape and np.isfinite(rad).all()
    ok = np.isclose(rad, ref_rad, rtol=1e-3, atol=1e-4).all(axis=1)
    n_bad = int((~ok).sum())
    assert ok.mean() >= min_frac, f"{n_bad} of {len(ok)} rays outside rtol 1e-3 / atol 1e-4"
    assert abs(float(segs) - float(ref_segs)) <= depth * n_bad, (float(segs), float(ref_segs))
    return n_bad


PORT_SCENES = {
    "bench_like": lambda: bench_like(T, cornell, obj_loader),
    "volume_parameterized": lambda: volume_parameterized(T),
    "bench_teapot_6k": lambda: bench_scene.build(16, 16, spp=4, path_depth=DEPTH),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(PORT_SCENES))
def test_kernel_matches_plain_on_card(cuda, name):
    scene = PORT_SCENES[name]()
    data = scene.compile(device=cuda)
    o, d = scene.camera.generate_rays(123, torch.arange(N // 4, dtype=torch.int32, device=cuda),
                                      spp=4)
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    uids = torch.arange(N, dtype=torch.int32, device=cuda)
    before = bounce.LAUNCHES
    rad, segs = bounce.path_trace_cuda(data, o, d, uids, 123, DEPTH,
                                       scene.camera.max_trace_dist)
    torch.cuda.synchronize()
    assert bounce.LAUNCHES == before + 1
    ref_rad, ref_segs = integrator.path_trace(data, o, d, uids, 123, DEPTH,
                                              scene.camera.max_trace_dist)
    assert float(ref_rad.max()) > 0.0
    assert_paths_match(rad.cpu().numpy(), segs.cpu(), ref_rad.cpu().numpy(), ref_segs.cpu())


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    scene = PORT_SCENES["bench_like"]()
    data = scene.compile(device=cuda)
    o = torch.zeros((8, 3), device=cuda)
    d = torch.ones((8, 3), device=cuda)
    uids = torch.arange(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        bounce.path_trace_cuda(data, o.double(), d, uids, 0, 2, 100.0)
    with pytest.raises(ValueError, match="shape"):
        bounce.path_trace_cuda(data, o, d[:4], uids, 0, 2, 100.0)
    with pytest.raises(ValueError, match="contiguous"):
        bounce.path_trace_cuda(data, o.t().contiguous().t(), d, uids, 0, 2, 100.0)
    with pytest.raises(ValueError, match="on"):
        bounce.path_trace_cuda(data, o, d, uids.cpu(), 0, 2, 100.0)
