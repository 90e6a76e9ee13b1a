"""General-boundary volumes in the torch port (a ConvexVolume whose
boundary is a Triangle or a StaticMesh, geometry.rs:495-530) against the
JAX package and against a literal numpy port of the reference algorithm
(tests/test_volume_general.py::_ref_volume_intersect): the boundary
tables and their per-volume epsilon, ops/intersect.py::
intersect_general_volume (also in blocks), the analytic transmittance,
the draws' extra columns, the routing away from K1, the fused path's
merge against the plain spec, chunk sizing and an end-to-end render.

The JAX package's own tests of these read obj/cube.obj from the
reference's asset directory; here the 12-triangle cube ([-1, 1]³) is built
in code.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs397raytracingsp22_tpu import Camera as JCamera
from cs397raytracingsp22_tpu import ConvexVolume as JConvexVolume
from cs397raytracingsp22_tpu import Isotropic as JIsotropic
from cs397raytracingsp22_tpu import Lambertian as JLambertian
from cs397raytracingsp22_tpu import Plane as JPlane
from cs397raytracingsp22_tpu import Scene as JScene
from cs397raytracingsp22_tpu import Sphere as JSphere
from cs397raytracingsp22_tpu import Triangle as JTriangle
from cs397raytracingsp22_tpu.models import transform as jtf_
from cs397raytracingsp22_tpu.ops import intersect as jisect
from cs397raytracingsp22_tpu.render import integrator as jint
from cs397raytracingsp22_tpu.render.driver import render_to_image as jax_render
from cs397raytracingsp22_tpu.utils import threefry as jtf
from cs397raytracingsp22_tpu_torch import (
    Camera, ConvexVolume, Isotropic, Lambertian, Plane, Scene, Sphere, Triangle,
)
from cs397raytracingsp22_tpu_torch.models import transform as tf
from cs397raytracingsp22_tpu_torch.ops import intersect as tisect
from cs397raytracingsp22_tpu_torch.ops.kernels import bounce as tbounce
from cs397raytracingsp22_tpu_torch.render import driver as tdriver
from cs397raytracingsp22_tpu_torch.render import integrator as tint
from cs397raytracingsp22_tpu_torch.render import nee as tnee
from cs397raytracingsp22_tpu_torch.scenes.kitchen_sink import mesh_from_arrays
from test_mesh import make_mesh as jax_make_mesh
from test_torch_scene import assert_scene_data_equal
from test_volume_general import _ref_volume_intersect

torch.set_num_threads(1)
MT_EPS = 1e-4


def cube_arrays():
    """The 12 triangles of the cube [-1, 1]³: (positions, faces, uvs)."""
    pos = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float32)
    faces = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                      [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return pos, faces, np.zeros((8, 2), np.float32)


def cube_volume(pkg, density=2.0, scale=1.0, center=(0.0, 0.0, 0.0)):
    """A cube-boundary volume for the port ("t") or the JAX package ("j")."""
    pos, faces, uv = cube_arrays()
    if pkg == "t":
        xf = tf.translate(*center) @ tf.scale(scale)
        mesh = mesh_from_arrays(pos, faces, uv, (None,) * 5, Lambertian(albedo=(1, 1, 1)), xf)
        return ConvexVolume(boundary=mesh, phase_function=Isotropic(albedo=(0.9, 0.9, 0.9)),
                            density=density)
    xf = jtf_.translate(*center) @ jtf_.scale(scale)
    mesh = jax_make_mesh(pos, faces, texcoords=uv, material=JLambertian(albedo=(1, 1, 1)),
                         transform=xf)
    return JConvexVolume(boundary=mesh, phase_function=JIsotropic(albedo=(0.9, 0.9, 0.9)),
                         density=density)


def triangle_volume(pkg):
    tri = Triangle if pkg == "t" else JTriangle
    iso = Isotropic if pkg == "t" else JIsotropic
    lam = Lambertian if pkg == "t" else JLambertian
    return (ConvexVolume if pkg == "t" else JConvexVolume)(
        boundary=tri(a=(-2.2, 0.2, -1.0), b=(-1.4, 0.2, -1.0), c=(-1.8, 1.0, -1.0),
                     material=lam()),
        phase_function=iso(albedo=(0.6, 0.9, 0.6)), density=1.5)


def volume_scenes(pkg):
    """Three general volumes (a cube, a triangle, a cube scaled by 0.002),
    a sphere-boundary volume, a sphere and a plane."""
    if pkg == "t":
        cam, scene, sph, pln, lam = Camera(), Scene, Sphere, Plane, Lambertian
        sph_vol = ConvexVolume(boundary=Sphere((1.3, 0.8, -1.2), 0.7, Lambertian()),
                               phase_function=Isotropic(albedo=(0.9, 0.7, 0.7)), density=0.8)
    else:
        cam, scene, sph, pln, lam = JCamera(), JScene, JSphere, JPlane, JLambertian
        sph_vol = JConvexVolume(boundary=JSphere((1.3, 0.8, -1.2), 0.7, JLambertian()),
                                phase_function=JIsotropic(albedo=(0.9, 0.7, 0.7)), density=0.8)
    return scene(camera=cam, objects=[
        cube_volume(pkg, density=1.1, scale=0.8, center=(0.3, 0.0, -2.0)),
        triangle_volume(pkg),
        cube_volume(pkg, density=1e6, scale=0.002, center=(0.0, 0.0, 0.5)),
        sph_vol,
        sph(center=(0, 0, -4), radius=0.8, material=lam(albedo=(0.6, 0.2, 0.2))),
        pln(point=(0, -2, 0), normal=(0, 1, 0), material=lam(albedo=(0.4, 0.4, 0.4))),
    ])


@pytest.fixture(scope="module")
def compiled():
    return volume_scenes("t").compile(device="cpu"), volume_scenes("j").compile()


def rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 4, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    half = n // 2  # half aimed at the cube
    d[:half] = (rng.uniform([-0.5, -0.7, -2.6], [1.1, 0.7, -1.4], (half, 3)) - o[:half])
    return o, d.astype(np.float32)


def test_boundary_tables_equal(compiled):
    """gvol_tri, gvol_density, gvol_mat, n_gvols and gvol_eps (1e-4 for a
    Triangle, 1e-4·|det M| for a mesh) equal the JAX package's."""
    tsd, jsd = compiled
    assert_scene_data_equal(tsd, jsd)
    assert tsd.n_gvols == 3 and tsd.n_volumes == 1
    assert [g.shape for g in tsd.gvol_tri] == [(12, 9), (1, 9), (12, 9)]
    assert tsd.gvol_eps[1] == MT_EPS
    np.testing.assert_allclose(tsd.gvol_eps[0], MT_EPS * 0.8**3, rtol=1e-5)


def test_intersect_general_volume_matches_jax(compiled):
    """Each volume's (t, valid) against the JAX function on the same rays
    and uniforms, windows and its own epsilon: valid equal, t within an ulp
    (rtol 1e-6; jnp.cross rounds a component differently); the cube in the
    smallest blocks the scan can take gives the same bits as in one."""
    tsd, jsd = compiled
    o, d = rays(1024)
    rng = np.random.default_rng(1)
    u = rng.uniform(1e-3, 1.0, o.shape[0]).astype(np.float32)
    t_min = rng.uniform(-1.0, 0.01, o.shape[0]).astype(np.float32)
    t_max = rng.uniform(0.5, 20.0, o.shape[0]).astype(np.float32)
    for g in range(tsd.n_gvols):
        got = tisect.intersect_general_volume(
            tsd.gvol_tri[g], tsd.gvol_density[g], *(torch.from_numpy(x) for x in (o, d, t_min,
                                                                                    t_max, u)),
            eps=tsd.gvol_eps[g])
        ref = jisect.intersect_general_volume(
            jsd.gvol_tri[g], jsd.gvol_density[g], *(jnp.asarray(x) for x in (o, d, t_min, t_max,
                                                                              u)),
            eps=jsd.gvol_eps[g])
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]), err_msg=f"valid {g}")
        m = got[1].numpy()
        np.testing.assert_allclose(got[0].numpy()[m], np.asarray(ref[0])[m], rtol=1e-6, atol=0,
                                   err_msg=f"t {g}")
        assert m.sum() > 20 or g > 0
    whole = tisect.intersect_general_volume(tsd.gvol_tri[0], tsd.gvol_density[0],
                                            *(torch.from_numpy(x) for x in (o, d, t_min, t_max,
                                                                            u)))
    old = tisect.GVOL_BLOCK
    try:
        for block in (1, 5 * o.shape[0]):  # rows of 1, then blocks of 5, 5 and 2
            tisect.GVOL_BLOCK = block
            parts = tisect.intersect_general_volume(
                tsd.gvol_tri[0], tsd.gvol_density[0],
                *(torch.from_numpy(x) for x in (o, d, t_min, t_max, u)))
            assert all(torch.equal(a, b) for a, b in zip(parts, whole)), block
    finally:
        tisect.GVOL_BLOCK = old


def port_cube_data(density, scale=1.0):
    sc = Scene(camera=Camera(), objects=[cube_volume("t", density=density, scale=scale)])
    return sc.compile(device="cpu")


def test_matches_reference_algorithm():
    """tests/test_volume_general.py::test_matches_reference_algorithm on
    the cube built in code."""
    data = port_cube_data(1.7)
    assert data.n_gvols == 1
    tris = data.gvol_tri[0].numpy()
    assert tris.shape == (12, 9)
    rng = np.random.default_rng(7)
    n = 256
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    u = rng.uniform(1e-3, 1.0, n).astype(np.float32)
    t_min, t_max = 0.001, 50.0
    t, valid = (x.numpy() for x in tisect.intersect_general_volume(
        data.gvol_tri[0], torch.tensor(1.7), torch.from_numpy(o), torch.from_numpy(d), t_min,
        t_max, torch.from_numpy(u)))
    assert 0 < valid.sum() < n
    for i in range(n):
        ref = _ref_volume_intersect(tris, 1.7, o[i], d[i], t_min, t_max, u[i])
        assert valid[i] == (ref is not None), i
        if ref is not None:
            np.testing.assert_allclose(t[i], ref, rtol=2e-4, atol=2e-5)


def test_transmittance_through_cube():
    """Axis-aligned rays through the side-2 cube: the scatter probability
    is 1 - exp(-rho · 2)."""
    rho = 0.8
    data = port_cube_data(rho)
    n = 4096
    rng = np.random.default_rng(3)
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = rng.uniform(-0.7, 0.7, n)
    o[:, 1] = rng.uniform(-0.7, 0.7, n)
    o[:, 2] = 5.0
    d = np.tile(np.array([[0, 0, -1.0]], np.float32), (n, 1))
    u = rng.uniform(0, 1, n).astype(np.float32)
    _, valid = tisect.intersect_general_volume(data.gvol_tri[0], torch.tensor(rho),
                                               torch.from_numpy(o), torch.from_numpy(d), 0.001,
                                               100.0, torch.from_numpy(u))
    frac = float(valid.float().mean())
    assert abs(frac - (1.0 - np.exp(-rho * 2.0))) < 0.03, frac


def test_small_scaled_boundary_keeps_reference_accept_set():
    """A cube scaled by 0.002: its world-space det shrinks by det(M), so a
    flat 1e-4 would reject every boundary triangle; the per-volume epsilon
    1e-4·|det M| keeps the reference's object-space accept set."""
    s = 0.002
    data = port_cube_data(1e6, scale=s)
    np.testing.assert_allclose(data.gvol_eps[0], MT_EPS * s**3, rtol=1e-5)
    n = 8
    o = torch.tensor([[0.0, 0.0, 3.0]]).repeat(n, 1)
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(n, 1)
    u = torch.full((n,), 1.0 - 1e-7)  # u → 1: scatter at the entry
    t, valid = tisect.intersect_general_volume(data.gvol_tri[0], data.gvol_density[0], o, d,
                                               1e-3, 100.0, u, eps=data.gvol_eps[0])
    assert bool(valid.all())
    np.testing.assert_allclose(t.numpy(), 3.0 - s, atol=2e-3)
    _, valid_flat = tisect.intersect_general_volume(data.gvol_tri[0], data.gvol_density[0], o, d,
                                                    1e-3, 100.0, u, eps=MT_EPS)
    assert not bool(valid_flat.any())


def test_mega_kernel_excludes_gvol_scenes(compiled):
    """K1 has no general-volume test: such a scene takes the staged path."""
    assert not tbounce.scene_is_simple(port_cube_data(2.0))
    assert not tbounce.scene_is_simple(compiled[0])
    only_sphere_vol = Scene(camera=Camera(), objects=[ConvexVolume(
        boundary=Sphere((0, 0, 0), 1.0, Lambertian()), phase_function=Isotropic(),
        density=1.0)]).compile(device="cpu")
    assert tbounce.scene_is_simple(only_sphere_vol)


def test_fused_path_matches_plain_and_jnp(compiled):
    """intersect_scene_fused (the plain versions of K2 and K3 on CPU
    tensors, then the general volumes' merge) bit for bit against
    intersect_scene_plain, and both against the JAX package's jnp spec."""
    tsd, jsd = compiled
    o, d = rays(2048, seed=5)
    n_cols = tsd.vol_center.shape[0] + tsd.n_gvols
    u = np.random.default_rng(6).uniform(0, 1, (o.shape[0], n_cols)).astype(np.float32)
    args = [torch.from_numpy(o), torch.from_numpy(d), 0.001, 100.0, torch.from_numpy(u)]
    plain = tisect.intersect_scene_plain(tsd, *args)
    fused = tisect.intersect_scene_fused(tsd, *args)
    assert torch.equal(plain.valid, fused.valid)
    m = plain.valid
    for f in ("t", "point", "normal", "frontface", "mtype", "albedo", "emission", "roughness",
              "metallic", "ior"):
        assert torch.equal(getattr(plain, f)[m], getattr(fused, f)[m]), f
    assert int((plain.mtype[m] == 4).sum()) > 100  # isotropic: volume scatter events
    ref = jisect.intersect_scene_jnp(jsd, jnp.asarray(o), jnp.asarray(d), 0.001, 100.0,
                                     jnp.asarray(u))
    np.testing.assert_array_equal(plain.valid.numpy(), np.asarray(ref.valid))
    mm = m.numpy()
    np.testing.assert_allclose(plain.t.numpy()[mm], np.asarray(ref.t)[mm], rtol=2e-5, atol=2e-6)
    np.testing.assert_array_equal(plain.mtype.numpy()[mm], np.asarray(ref.mtype)[mm])


def test_draws_carry_a_column_per_general_volume(compiled):
    """_bounce_draws and nee_draws draw 4 + V + G uniforms, bit for bit the
    JAX package's; the sphere-volume columns are those of the same draw
    without the general volumes (each counter slot is independent)."""
    tsd, jsd = compiled
    uids = np.arange(-5, 600, dtype=np.int32)
    v, g = tsd.vol_center.shape[0], tsd.n_gvols
    for site in (1, 4):
        _, u_choice, u_vol = tint._bounce_draws(tsd, 77, torch.from_numpy(uids), site)
        assert u_vol.shape == (uids.size, v + g)
        _, ju_choice, ju_vol = jint._bounce_draws(jsd, jtf.key_words(77), jnp.asarray(uids), site)
        np.testing.assert_array_equal(u_vol.numpy(), np.asarray(ju_vol))
        np.testing.assert_array_equal(u_choice.numpy(), np.asarray(ju_choice))
        from cs397raytracingsp22_tpu_torch.utils import threefry

        fewer = threefry.bounce_uniforms(77, torch.from_numpy(uids), site, 4 + v)
        assert torch.equal(fewer[:, 4:], u_vol[:, :v])
    nd = tnee.nee_draws(tsd, 77, torch.from_numpy(uids), 2)
    assert nd.shape == (uids.size, 4 + v + g)
    ref = jtf.counter_uniforms(jtf.key_words(77), jnp.asarray(uids), tnee.SITE_NEE0 + 2, 4 + v + g)
    np.testing.assert_array_equal(nd.numpy(), np.asarray(ref))


def test_chunk_pixels_counts_boundary_triangles(compiled):
    """The chunk's work counts each general volume's boundary triangles
    as primitive tests (driver.py:462-468 in the JAX package)."""
    tsd, _ = compiled
    cam = Camera(screen_width=2048, screen_height=2048, aa_sample_count=256, path_depth=16)
    prims = 1 + 1 + 1 + 12 + 1 + 12  # sphere, plane, sphere volume, three boundaries
    want = (1 << 36) // (256 * 16 * prims)
    assert want < 2048 * 2048
    assert tdriver.chunk_pixels(tsd, cam, 256) == 1 << (want.bit_length() - 1) == 524288


def test_render_with_mesh_boundary_volume():
    """tests/test_volume_general.py::test_render_with_mesh_boundary_volume
    in the port, and its image against the JAX package's within 1 u8 on
    >= 99% of subpixels: an emissive backdrop seen through the cube's fog
    is lit but dimmer than where nothing is in the way."""
    def scene(pkg):
        cam = (Camera if pkg == "t" else JCamera)(
            eyepoint=(0, 0, 5), view_dir=(0, 0, -1), up=(0, 1, 0), screen_width=24,
            screen_height=24, aa_sample_count=16, path_depth=6)
        pln = Plane if pkg == "t" else JPlane
        lam = Lambertian if pkg == "t" else JLambertian
        return (Scene if pkg == "t" else JScene)(camera=cam, objects=[
            cube_volume(pkg, density=1.2, scale=1.2),
            pln(point=(0, 0, -4), normal=(0, 0, 1),
                material=lam(albedo=(0, 0, 0), emission=(4, 4, 4))),
        ])

    img1, _ = tdriver.render_to_image(scene("t"), device="cpu", seed=11, verbose=False)
    img2, _ = tdriver.render_to_image(scene("t"), device="cpu", seed=11, verbose=False)
    np.testing.assert_array_equal(img1, img2)
    center, corner = img1[10:14, 10:14].mean(), img1[0:3, 0:3].mean()
    assert 5.0 < center < corner, (center, corner)
    ref, _ = jax_render(scene("j"), seed=11, verbose=False)
    diff = np.abs(img1.astype(int) - ref.astype(int))
    assert (diff <= 1).mean() >= 0.99, (diff <= 1).mean()
