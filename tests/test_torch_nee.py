"""Next-event estimation in the torch port (render/nee.py,
integrator.path_trace_shrink with nee=True) against the JAX package's.

- the light tables, nee_ok, point_light_pos and ambient: equal to JAX's
  exactly, on scenes with triangle and sphere lights and on scenes that
  void NEE (an emissive plane, an emissive medium, no light), and carried
  by scene_data_from_numpy;
- the NEE draws at SITE_NEE0 + depth: the bits of JAX's;
- the stages on the same hit records (JAX's intersection of the same
  rays): sample_light_point within rtol 1e-6 / atol 1e-6; _diffuse_mask's
  `applies` exact; direct_light's `did` and shadow-ray count exact and its
  contribution within rtol 1e-4 / atol 1e-5 on >= 99.9% of rays
  (torch.rsqrt and the float32 cube root may round apart from XLA's);
- the executor against JAX path_trace_nee: radiance within rtol 1e-3 /
  atol 1e-4 on >= 99.5% of rays (a winner flip re-rolls a path), equal
  segment totals; bit-identical in any ray order;
- the estimator: the mean of the plain path trace at equal depth, with
  lower variance (the sizes and bounds of tests/test_nee.py:99);
- the driver's refusals: NEE under Phong, NEE where nee_ok is False.
The `gpu` test holds the executor with K2 (and K3) on the card to its
plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cs397raytracingsp22_tpu as J
import cs397raytracingsp22_tpu_torch as T
from cs397raytracingsp22_tpu.ops.intersect import intersect_scene as j_intersect
from cs397raytracingsp22_tpu.render import integrator as jint
from cs397raytracingsp22_tpu.render import nee as jnee
from cs397raytracingsp22_tpu.utils import rng as jrng
from cs397raytracingsp22_tpu.utils import threefry as jtf
from cs397raytracingsp22_tpu_torch.models import materials as tmat
from cs397raytracingsp22_tpu_torch.ops.intersect import HitRecord, intersect_scene_plain
from cs397raytracingsp22_tpu_torch.render import driver as tdriver
from cs397raytracingsp22_tpu_torch.render import integrator as tint
from cs397raytracingsp22_tpu_torch.render import nee as tnee
from cs397raytracingsp22_tpu_torch.scenes import bench_scene as tbench
from cs397raytracingsp22_tpu_torch.scenes import cornell as tcornell
from cs397raytracingsp22_tpu_torch.utils import rng as trng
from scenes import cornell as jcornell
# sibling test modules by their bare names (pytest puts tests/ on sys.path)
from test_torch_bounce_kernel import volume_parameterized
from test_torch_scene import assert_scene_data_equal, jax_bench_scene, port_data_from_jax

torch.set_num_threads(1)  # several test workers share the cores

DEPTH = 4
MAX_DIST = 100.0


def emissive_sphere(P):
    """A floor under one emissive sphere (tests/test_nee.py:31)."""
    return P.Scene(
        camera=P.Camera(screen_width=4, screen_height=4, aa_sample_count=1),
        objects=[
            P.Plane(point=(0, 0, 0), normal=(0, 1, 0), material=P.Lambertian()),
            P.Sphere(center=(0, 3, 0), radius=0.5,
                     material=P.Lambertian(albedo=(0, 0, 0), emission=(4, 4, 4))),
        ],
        point_light_pos=(1.0, 5.0, 2.0), ambient=(0.05, 0.1, 0.15),
    )


def emissive_plane(P):
    """An emissive plane: not a sampled light, so nee_ok is False."""
    return P.Scene(
        camera=P.Camera(screen_width=4, screen_height=4, aa_sample_count=1),
        objects=[
            P.Plane(point=(0, 0, 0), normal=(0, 1, 0), material=P.Lambertian()),
            P.Plane(point=(0, 8, 0), normal=(0, -1, 0), material=P.Lambertian(emission=(3, 3, 3))),
            P.Sphere(center=(0, 3, 0), radius=0.5,
                     material=P.Lambertian(albedo=(0, 0, 0), emission=(4, 4, 4))),
        ],
    )


def emissive_medium(P):
    """A sphere light and an emissive medium, which voids nee_ok."""
    return P.Scene(
        camera=P.Camera(screen_width=4, screen_height=4, aa_sample_count=1),
        objects=[
            P.Sphere(center=(0, 3, 0), radius=0.5,
                     material=P.Lambertian(albedo=(0, 0, 0), emission=(4, 4, 4))),
            P.ConvexVolume(boundary=P.Sphere(center=(0, 1, 0), radius=0.5, material=P.Lambertian()),
                           phase_function=P.Isotropic(albedo=(0.5,) * 3, emission=(1, 1, 1)),
                           density=1.0),
        ],
    )


def no_light(P):
    return P.Scene(
        camera=P.Camera(screen_width=4, screen_height=4, aa_sample_count=1),
        objects=[P.Plane(point=(0, 0, 0), normal=(0, 1, 0), material=P.Lambertian())],
    )


def fog(P, spp=4):
    """A floor, a sphere light and a sphere-bounded Isotropic medium between
    them (tests/test_nee.py:240), seen from above."""
    return P.Scene(
        camera=P.Camera(eyepoint=(0.3, 2.2, 2.5), view_dir=(0.0, -0.8, -1.0), screen_width=16,
                        screen_height=16, aa_sample_count=spp, path_depth=DEPTH,
                        focal_length=0.7),
        objects=[
            P.Plane(point=(0, 0, 0), normal=(0, 1, 0), material=P.Lambertian(albedo=(0.7,) * 3)),
            P.Sphere(center=(0.0, 2.0, -0.5), radius=0.3,
                     material=P.Lambertian(albedo=(0, 0, 0), emission=(300.0,) * 3)),
            P.ConvexVolume(
                boundary=P.Sphere(center=(0.3, 1.0, -0.5), radius=0.5, material=P.Lambertian()),
                phase_function=P.Isotropic(albedo=(0.9,) * 3), density=2.0,
            ),
        ],
    )


# name -> (JAX scene, port scene, (n_lt_tri, n_lt_sph, nee_ok))
TABLE_SCENES = {
    "cornell": (lambda: jcornell.build(8, 8, spp=1), lambda: tcornell.build(8, 8, spp=1),
                (2, 0, True)),
    "cornell_config3": (lambda: jcornell.build_config3(8, 8, spp=1),
                        lambda: tcornell.build_config3(8, 8, spp=1), (2, 1, True)),
    "bench_scene": (lambda: jax_bench_scene(8, 8, spp=1), lambda: tbench.build(8, 8, spp=1),
                    (2, 0, True)),
    "emissive_sphere": (lambda: emissive_sphere(J), lambda: emissive_sphere(T), (0, 1, True)),
    "emissive_plane": (lambda: emissive_plane(J), lambda: emissive_plane(T), (0, 1, False)),
    "emissive_medium": (lambda: emissive_medium(J), lambda: emissive_medium(T), (0, 1, False)),
    "no_light": (lambda: no_light(J), lambda: no_light(T), (0, 0, False)),
}


@pytest.mark.parametrize("name", sorted(TABLE_SCENES))
def test_light_tables_equal_jax(name):
    jbuild, tbuild, (n_tri, n_sph, ok) = TABLE_SCENES[name]
    jsd, tsd = jbuild().compile(), tbuild().compile(device="cpu")
    assert (tsd.n_lt_tri, tsd.n_lt_sph, tsd.nee_ok) == (n_tri, n_sph, ok)
    for field in ("lt_tri", "lt_sph", "point_light_pos", "ambient"):
        a, b = getattr(tsd, field).numpy(), np.asarray(getattr(jsd, field))
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert_scene_data_equal(tsd, jsd)
    # the JAX package's leaves carried over into the port's SceneData
    assert_scene_data_equal(port_data_from_jax(jsd), jsd)
    if n_tri:
        assert (tsd.lt_tri[:n_tri, 12] > 0).all() and (tsd.lt_tri[:n_tri, 9:12] > 1.0).all()


def test_nee_draws_bit_exact():
    assert trng.SITE_NEE0 == jrng.SITE_NEE0 == 1 << 12
    uids = np.concatenate([np.arange(300), [2**31 - 1, -(2**31), -1, 123456789]]).astype(np.int32)
    data = volume_parameterized(T).compile(device="cpu")
    jdata = volume_parameterized(J).compile()
    m = 4 + jdata.vol_center.shape[0] + jdata.n_gvols
    for depth in (0, 3, 7):
        key = jtf.key_words(2**33 + 17)
        ref = jtf.counter_uniforms(key, jnp.asarray(uids), jrng.SITE_NEE0 + depth, m)
        got = tnee.nee_draws(data, 2**33 + 17, torch.from_numpy(uids), depth)
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _port_hit(jhit) -> HitRecord:
    return HitRecord(**{f.name: torch.from_numpy(np.array(getattr(jhit, f.name)))
                        for f in dataclasses.fields(HitRecord)})


def _camera_rays(scene, n_px, spp, key=11):
    o, d = scene.camera.generate_rays(key, jnp.arange(n_px, dtype=jnp.int32), spp=spp)
    return np.array(o).reshape(-1, 3), np.array(d).reshape(-1, 3)


STAGE_SCENES = {
    "cornell_config3": (lambda: jcornell.build_config3(16, 16, spp=4, path_depth=DEPTH),
                        lambda: tcornell.build_config3(16, 16, spp=4, path_depth=DEPTH)),
    "volume_parameterized": (lambda: volume_parameterized(J), lambda: volume_parameterized(T)),
    "fog": (lambda: fog(J), lambda: fog(T)),
}


@pytest.fixture(scope="module", params=sorted(STAGE_SCENES))
def stage(request):
    """A scene, its first and second hits of 1,024 rays (JAX's intersection;
    the second bounce through JAX's bounce body) and the rays' draws."""
    jbuild, tbuild = STAGE_SCENES[request.param]
    jscene = jbuild()
    jsd, tsd = jscene.compile(), tbuild().compile(device="cpu")
    o, d = _camera_rays(jscene, 256, 4)
    n = o.shape[0]
    uids = np.arange(n, dtype=np.int32) * 7 + 3
    key = jtf.key_words(5)
    hits = []
    state = (jnp.asarray(o), jnp.asarray(d), jnp.ones((n, 3), jnp.float32),
             jnp.zeros((n, 3), jnp.float32), jnp.ones((n,), bool))
    for b in range(2):
        _, u_choice, u_vol = jint._bounce_draws(jsd, key, jnp.asarray(uids), jrng.SITE_BOUNCE0 + b)
        t_max = jnp.where(state[4], MAX_DIST, 0.0)
        jhit = j_intersect(jsd, state[0], state[1], jint.PATH_T_MIN, t_max, u_vol)
        hits.append((jhit, np.array(state[1]), np.array(u_choice), np.array(state[4] & jhit.valid)))
        state = jint._bounce_update(jsd, *state, jnp.asarray(uids), key, jrng.SITE_BOUNCE0 + b,
                                    MAX_DIST)[:5]
    return request.param, jsd, tsd, hits, uids, key


def test_sample_light_point_matches_jax(stage):
    _, jsd, tsd, _, _, _ = stage
    u = np.random.default_rng(4).random((4096, 3)).astype(np.float32)
    u[:8] = [[0, 0, 0], [1 - 2**-24, 1 - 2**-24, 1 - 2**-24]] * 4  # the ends of [0, 1)
    ref = jnee.sample_light_point(jsd, *(jnp.asarray(u[:, k]) for k in range(3)))
    got = tnee.sample_light_point(tsd, *(torch.from_numpy(u[:, k].copy()) for k in range(3)))
    for name, a, b in zip(("x", "n_l", "emission", "inv_pdf"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6, err_msg=name)


def test_diffuse_mask_matches_jax(stage):
    name, _, _, hits, _, _ = stage
    kinds = set()
    for jhit, d, u_choice, _ in hits:
        hit = _port_hit(jhit)
        has_n = np.array(jnp.sum(jhit.normal * jhit.normal, axis=-1) > 0.0)
        ref = jnee._diffuse_mask(jhit, jnp.asarray(d), jnp.asarray(u_choice), jnp.asarray(has_n))
        got = tnee._diffuse_mask(hit, torch.from_numpy(d), torch.from_numpy(u_choice),
                                 torch.from_numpy(has_n))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-6, atol=1e-7)
        app = got[0].numpy() & np.asarray(jhit.valid)
        kinds |= {(int(t), bool(h)) for t, h in zip(np.asarray(jhit.mtype)[app], has_n[app])}
    if name == "volume_parameterized":  # each kind of NEE vertex took part
        assert {(tmat.LAMBERTIAN, True), (tmat.PARAMETERIZED, True),
                (tmat.ISOTROPIC, False)} <= kinds, kinds


def test_direct_light_matches_jax(stage):
    _, jsd, tsd, hits, uids, key = stage
    for depth, (jhit, d, u_choice, live) in enumerate(hits):
        c_ref, did_ref, n_ref = jnee.direct_light(
            jsd, jhit, jnp.asarray(d), jnp.asarray(u_choice), jnp.asarray(live),
            jnp.asarray(uids), key, depth, jint.PATH_T_MIN, MAX_DIST)
        c, did, n_shot = tnee.direct_light(
            tsd, _port_hit(jhit), torch.from_numpy(d), torch.from_numpy(u_choice),
            torch.from_numpy(live), torch.from_numpy(uids), key, depth, tint.PATH_T_MIN, MAX_DIST,
            intersect=intersect_scene_plain)
        np.testing.assert_array_equal(did.numpy(), np.asarray(did_ref))
        assert n_shot.dtype == torch.int64 and int(n_shot) == int(n_ref) > 0
        c_ref = np.asarray(c_ref)
        ok = np.isclose(c.numpy(), c_ref, rtol=1e-4, atol=1e-5).all(axis=1)
        assert ok.mean() >= 0.999, f"{(~ok).sum()} of {len(ok)} contributions differ"
        if depth == 0:
            assert (c_ref.max(axis=1) > 0).sum() > 50, "the lights must reach the vertices"


EXEC_SCENES = {
    "cornell_config3": (lambda: jcornell.build_config3(16, 16, spp=4, path_depth=DEPTH),
                        lambda: tcornell.build_config3(16, 16, spp=4, path_depth=DEPTH)),
    "fog": (lambda: fog(J), lambda: fog(T)),
}


@pytest.fixture(scope="module", params=sorted(EXEC_SCENES))
def executor_run(request):
    """JAX path_trace_nee and the port's on 1,024 camera rays."""
    jbuild, tbuild = EXEC_SCENES[request.param]
    jscene = jbuild()
    jsd, tsd = jscene.compile(), tbuild().compile(device="cpu")
    o, d = _camera_rays(jscene, 256, 4, key=3)
    uids = np.arange(o.shape[0], dtype=np.int32)
    key = jtf.key_words(9)
    ref_rad, ref_segs = jint.path_trace_nee(jsd, jnp.asarray(o), jnp.asarray(d),
                                            jnp.asarray(uids), key, DEPTH, MAX_DIST)
    ins = [torch.from_numpy(x) for x in (o, d, uids)]
    rad, segs = tint.path_trace_shrink(tsd, *ins, key, DEPTH, MAX_DIST, nee=True)
    return tsd, ins, key, (rad, segs), (np.asarray(ref_rad), float(ref_segs))


def test_path_trace_nee_matches_jax(executor_run):
    tsd, ins, key, (rad, segs), (ref_rad, ref_segs) = executor_run
    assert rad.dtype == torch.float32 and segs.dtype == torch.int64
    assert np.isfinite(rad.numpy()).all() and ref_rad.max() > 0.0
    ok = np.isclose(rad.numpy(), ref_rad, rtol=1e-3, atol=1e-4).all(axis=1)
    assert ok.mean() >= 0.995, f"{(~ok).sum()} of {len(ok)} rays outside rtol 1e-3 / atol 1e-4"
    assert int(segs) == int(ref_segs)
    # the paths are the plain path trace's (the draw sites are shared), so
    # the segments beyond its count are the shadow rays shot, at most one
    # a segment
    _, path_segs = tint.path_trace(tsd, *ins, key, DEPTH, MAX_DIST)
    assert int(path_segs) < int(segs) < 2 * int(path_segs)


def test_path_trace_nee_is_order_invariant(executor_run):
    tsd, (o, d, uids), key, (rad, segs), _ = executor_run
    perm = torch.from_numpy(np.random.default_rng(1).permutation(o.shape[0]))
    rad_p, segs_p = tint.path_trace_shrink(tsd, o[perm], d[perm], uids[perm], key, DEPTH, MAX_DIST,
                                           nee=True)
    assert torch.equal(rad_p, rad[perm]) and int(segs_p) == int(segs)


def test_nee_same_mean_lower_variance():
    """The plain and NEE estimators over the same camera rays and scatter
    draws (the sites are shared): per-pixel means within the paired
    estimator's noise, global means within 6%, variance below 0.85x
    (tests/test_nee.py:99's sizes and bounds, on the port's executors)."""
    n_px, spp, depth = 24, 256, 4
    scene = tcornell.build_config3(width=16, height=16, spp=spp, path_depth=depth)
    data = scene.compile(device="cpu")
    key = 7
    pixel_ids = torch.arange(n_px, dtype=torch.int32) * 7 % 256
    o, d, uids = tdriver._gen_chunk_rays(scene.camera, pixel_ids, key, 0, spp, 1)
    plain, _ = tint.path_trace(data, o, d, uids, key, depth, MAX_DIST)
    neer, _ = tint.path_trace_shrink(data, o, d, uids, key, depth, MAX_DIST, nee=True)
    plain = plain.numpy().reshape(n_px, spp, 3)
    neer = neer.numpy().reshape(n_px, spp, 3)
    pm, nm = plain.mean(axis=1), neer.mean(axis=1)
    assert np.abs(pm - nm).mean() < 0.12 * max(pm.mean(), 1e-3)
    np.testing.assert_allclose(nm.mean(), pm.mean(), rtol=0.06)
    assert neer.var(axis=1).mean() < 0.85 * plain.var(axis=1).mean()


def test_driver_refuses_nee_where_it_is_wrong():
    base = tcornell.build_config3(width=4, height=4, spp=1)
    phong = dataclasses.replace(base, camera=dataclasses.replace(
        base.camera, nee=True, shading_mode=T.ShadingMode.PHONG))
    with pytest.raises(ValueError, match="PHONG"):
        tdriver.render_to_image(phong, device="cpu", verbose=False)
    for build in (emissive_plane, no_light):
        sc = build(T)
        sc = dataclasses.replace(sc, camera=dataclasses.replace(sc.camera, nee=True))
        with pytest.raises(ValueError, match="nee"):
            tdriver.render_to_image(sc, device="cpu", verbose=False)
        data = sc.compile(device="cpu")
        ray = torch.zeros((1, 3))
        with pytest.raises(ValueError, match="nee_ok"):
            tint.path_trace_shrink(data, ray, ray + 1, torch.zeros(1, dtype=torch.int32), 0, 2,
                                   9.0, nee=True)


def test_nee_render_matches_jax():
    """render_to_image with Camera(nee=True): the port's image within 1 u8
    of the JAX package's on >= 99% of subpixels, and lit."""
    from cs397raytracingsp22_tpu.render.driver import render_to_image as jax_render

    kw = dict(width=12, height=12, spp=4, path_depth=3)
    jsc, tsc = jcornell.build_config3(**kw), tcornell.build_config3(**kw)
    jsc = dataclasses.replace(jsc, camera=dataclasses.replace(jsc.camera, nee=True))
    tsc = dataclasses.replace(tsc, camera=dataclasses.replace(tsc.camera, nee=True))
    img, stats = tdriver.render_to_image(tsc, device="cpu", seed=4, verbose=False)
    ref, ref_stats = jax_render(jsc, seed=4, verbose=False)
    diff = np.abs(img.astype(int) - np.asarray(ref).astype(int))
    assert (diff <= 1).mean() >= 0.99 and diff.mean() <= 0.05
    assert stats.path_segments == int(ref_stats.path_segments)
    assert img.mean() > 2.0


@pytest.mark.gpu
@pytest.mark.parametrize("big", [False, True])
def test_path_trace_nee_on_card_matches_plain(big):
    """The executor through K2 (and K3 on a big mesh) on the card against
    itself through intersect_scene_plain: the executor's contract."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cs397raytracingsp22_tpu_torch.ops.kernels import scene_intersect, tri_scan_big
    from test_torch_bounce_kernel import assert_paths_match

    dev = torch.device("cuda")
    obj = tbench.teapot_obj(9000) if big else tbench.TEAPOT_6K
    scene = tbench.build(32, 32, spp=4, path_depth=DEPTH, obj_path=obj)
    data = scene.compile(device=dev)
    o, d, uids = tdriver._gen_chunk_rays(scene.camera, torch.arange(32 * 32, dtype=torch.int32,
                                                                    device=dev), 5, 0, 4, 1)
    k2, k3 = scene_intersect.LAUNCHES, tri_scan_big.LAUNCHES
    rad, segs = tint.path_trace_shrink(data, o, d, uids, 5, DEPTH, MAX_DIST, nee=True)
    torch.cuda.synchronize()
    assert scene_intersect.LAUNCHES - k2 == 2 * DEPTH - 1
    assert tri_scan_big.LAUNCHES - k3 == ((2 * DEPTH - 1) * 2 if big else 0)
    ref, ref_segs = tint.path_trace_shrink(data, o, d, uids, 5, DEPTH, MAX_DIST, nee=True,
                                           intersect=intersect_scene_plain)
    assert_paths_match(rad.cpu().numpy(), segs, ref.cpu().numpy(), ref_segs,
                       depth=2 * DEPTH - 1)
