"""R1, the merged-resolve kernel (ops/kernels/resolve.py, csrc/resolve.cu),
against its plain version ops/intersect.py::resolve_mesh_winners.

On the CPU: the wrapper's contract (CPU tensors take the plain version and
launch nothing; what a launch does not take raises), the packed table the
kernel reads per mesh (kmesh_xfm: each mesh's transforms, its first
kmesh_res row, triangles and material id), the instantiation each scene
picks, and a torch re-statement of the kernel's
per-ray arithmetic from those tables against resolve_mesh_winners, bit for
bit, on seeded winners of every class.

On the card (marked `gpu`, skipped without one; the file imports no JAX):
every output bit-identical to resolve_mesh_winners run on the same card (NaN
where it has NaN), on seeded winners and on the winners of rendered rays,
and one launch per intersect_scene call of a render. Run them there:

    python -m pytest tests/test_torch_resolve_kernel.py -q -m gpu

The scenes: config 5's stand-ins (scenes/drone_demo.py: three meshes, one of
them big, materials synthesized from textures, normal maps), the bench
teapot (one untextured dense mesh with a material), config 4's stand-ins
(scenes/textured_spheres.py: albedo and normal maps), the kitchen sink
(scenes/kitchen_sink.py: synthesized materials, a general volume) and the
kitchen sink with all five slots of each mesh bound (`all_slots`), and
`many_meshes`: more meshes and materials than a block of the kernel stages
(the rest read from device memory). The bench teapot takes the bare
instantiation, the others the full one.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from cs397raytracingsp22_tpu_torch import Lambertian, Scene, Sphere, StaticMesh
from cs397raytracingsp22_tpu_torch.models import materials as mat
from cs397raytracingsp22_tpu_torch.models import transform as tf
from cs397raytracingsp22_tpu_torch.models.scene import resolve_order
from cs397raytracingsp22_tpu_torch.ops import intersect as isect
from cs397raytracingsp22_tpu_torch.ops.kernels import resolve
from cs397raytracingsp22_tpu_torch.render import driver, integrator
from cs397raytracingsp22_tpu_torch.scenes import bench_scene, drone_demo, kitchen_sink
from cs397raytracingsp22_tpu_torch.scenes import textured_spheres
from cs397raytracingsp22_tpu_torch.utils import rng as rnglib

torch.set_num_threads(1)  # several test workers share the cores



def many_meshes() -> Scene:
    """More meshes and materials than a block of the kernel stages (64 and
    512): 600 small spheres of materials of their own, then 70 copies of
    config 4's earth mesh in a grid, in turn with its material synthesized
    from its albedo and normal maps, with those maps and a material of its
    own, and bare with a material of its own."""
    base = textured_spheres.build(64, 64, spp=1)
    earth = next(x for x in base.objects if isinstance(x, StaticMesh))
    objects = [Sphere(center=(0.3 * (i % 30) - 4.5, 3.0 + 0.3 * (i // 30), -3.0), radius=0.1,
                      material=Lambertian(albedo=(i / 600.0, 0.5, 0.25))) for i in range(600)]
    for k in range(70):
        objects.append(StaticMesh(
            earth.mesh, [None] * 5 if k % 3 == 2 else earth.textures,
            None if k % 3 == 0 else Lambertian(albedo=(0.2, k / 70.0, 0.4)),
            tf.translate(float(k % 10) - 4.5, 0.6 * (k // 10), 0.0) @ tf.scale(0.25)))
    return Scene(camera=base.camera, objects=objects)


SCENES = {
    "demo": lambda: drone_demo.build(64, 64, spp=1, path_depth=10),
    "bench": lambda: bench_scene.build(64, 64, spp=1, path_depth=8),
    "config4": lambda: textured_spheres.build(64, 64, spp=1),
    "kitchen_sink": lambda: kitchen_sink.build(32, 32, spp=1),
    "all_slots": lambda: kitchen_sink.build(32, 32, spp=1),
    "many": many_meshes,
}
# the instantiation each scene launches (resolve.variant): 1 the full one
# (a texture slot or a synthesized material), 0 the bare one
VARIANTS = {"demo": 1, "bench": 0, "config4": 1, "kitchen_sink": 1, "all_slots": 1, "many": 1}
FIELDS = tuple(resolve.OUTPUTS)
# a kmesh_xfm row: [normal matrix, R, t, inverse R, inverse t, first
# kmesh_res row, triangles, material id]
INV_R, INV_T, FIRST, TRIS, MAT_ID = slice(21, 30), slice(30, 33), 33, 34, 35


def all_slots(sd):
    """The scene with every unbound texture slot of each mesh bound to the
    mesh's first bound texture, in its tex_ids and in kmesh_tex, so that the
    synthesized materials read all four slots and every mesh a normal map."""
    order = resolve_order(sd.dense_mesh_ids, len(sd.meshes))
    tex = sd.kmesh_tex.clone()
    meshes = list(sd.meshes)
    for j, mi in enumerate(order):
        m = meshes[mi]
        first = next(s for s in range(5) if m.tex_ids[s] >= 0)
        meshes[mi] = dataclasses.replace(m, tex_ids=tuple(
            t if t >= 0 else m.tex_ids[first] for t in m.tex_ids))
        for s in range(5):
            if m.tex_ids[s] < 0:
                tex[j, 3 * s:3 * s + 3] = sd.kmesh_tex[j, 3 * first:3 * first + 3]
    return dataclasses.replace(sd, meshes=tuple(meshes), kmesh_tex=tex)


@functools.cache
def compiled(name: str, device: str):
    sd = SCENES[name]().compile(device=device)
    return all_slots(sd) if name == "all_slots" else sd


def winners(sd, n: int, seed: int, dev):
    """Seeded inputs of a resolve over n rays: (o, d, code, t, idx, u, v,
    fields). Codes of every class (misses, the four analytic classes, each
    mesh, each general volume), half of them mesh winners; triangle indices
    from below 0 to past their mesh's end; barycentrics with u + v = 1 on
    every fifth ray and u or v at 0 or 1 on others; material ids from -1 to
    past the table's end."""
    g = np.random.default_rng(seed)
    m = len(sd.meshes)
    others = [-1, 0, 1, 2, 3] + [isect.CODE_GVOL0 + k for k in range(sd.n_gvols)]
    code = np.where(g.random(n) < 0.5, isect.CODE_MESH0 + g.integers(0, m, n),
                    g.choice(others, n))
    tris = int(sd.kmesh_xfm[:m, TRIS].max())
    idx = g.integers(-3, tris + 4, n)
    u = g.random(n).astype(np.float32)
    v = (g.random(n) * (1.0 - u)).astype(np.float32)
    v[::5] = np.float32(1.0) - u[::5]
    u[1::7], v[1::7] = 1.0, 0.0
    u[2::11], v[2::11] = 0.0, 1.0
    u[3::13], v[3::13] = 0.25, 0.75
    o = (g.normal(size=(n, 3)) * 3.0).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    t = g.uniform(1e-3, 20.0, n).astype(np.float32)
    normal = g.normal(size=(n, 3)).astype(np.float32)
    n_mat = sd.mat_type.shape[0]

    def on(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x)).to(dtype).to(dev)

    f32 = torch.float32
    fields = dict(point=on(o + t[:, None] * d, f32), normal=on(normal, f32),
                  frontface=on(g.random(n) < 0.5, torch.bool),
                  mat=on(g.integers(-1, n_mat + 2, n), torch.int32))
    return (on(o, f32), on(d, f32), on(code, torch.int32), on(t, f32), on(idx, torch.int32),
            on(u, f32), on(v, f32), fields)


def plain(sd, o, d, code, t, idx, u, v, fields):
    """resolve_mesh_winners on the device of the inputs, every mesh's object
    rays formed as intersect_scene_fused formed them."""
    obj = {mi: isect.object_rays(sd.meshes[mi], o, d)
           for mi in resolve_order(sd.dense_mesh_ids, len(sd.meshes))}
    return isect.resolve_mesh_winners(sd, obj, code, t, idx, u, v, fields)


def assert_same(got: dict, want: dict, what=""):
    """Every field bit for bit; a float may be NaN where the other is NaN."""
    assert set(got) == set(want) == set(FIELDS)
    for f in FIELDS:
        a, b = got[f].contiguous(), want[f].contiguous()
        assert a.shape == b.shape and a.dtype == b.dtype, (what, f)
        if a.dtype == torch.float32:
            same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())
        else:
            same = a == b
        bad = (~same).reshape(a.shape[0], -1).any(dim=1).nonzero()[:, 0]
        assert bad.numel() == 0, (what, f, bad[:8].tolist())


# ---------------------------------------------------------------- CPU ----


def kernel_model(sd, o, d, code, t, idx, u, v, fields, decode):
    """csrc/resolve.cu's per-ray arithmetic restated in float32 torch ops,
    one operation per line of the kernel, from the packed tables it stages
    (kmesh_xfm, kmesh_tex, kscene's material rows) and
    reads (kmesh_res, tex_pixels). decode: bytes (N, 3) to floats, as the
    plain version decodes them on the device it runs on (on the card both
    multiply by the float32 reciprocal of 255)."""
    n, m, n_mat = code.shape[0], len(sd.meshes), sd.mat_type.shape[0]
    j = code.long() - isect.CODE_MESH0
    is_mesh = (j >= 0) & (j < m)
    j = torch.where(is_mesh, j, 0)
    xf, tx = sd.kmesh_xfm[j], sd.kmesh_tex[j]
    ids = xf[:, FIRST:].to(torch.int32)  # [first row, triangles, material id]
    iv = torch.cat([xf[:, INV_R], xf[:, INV_T]], dim=1)
    tri = torch.minimum(torch.clamp(idx, min=0), ids[:, 1] - 1)
    r = sd.kmesh_res[(ids[:, 0] + tri).long()]

    def row3(mm, k, p):  # row k of the row-major 3x3 mm (N, 9) times p (N, 3)
        return (mm[:, 3 * k] * p[:, 0] + mm[:, 3 * k + 1] * p[:, 1]) + mm[:, 3 * k + 2] * p[:, 2]

    def normalize(a):
        s = torch.sqrt(((a[:, 0] * a[:, 0] + a[:, 1] * a[:, 1]) + a[:, 2] * a[:, 2]) + 1e-30)
        return a / s[:, None]

    def cross(a, b):
        return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                            a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                            a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)

    def texel(slot, uv):  # (rgb, bound) of slot `slot` of each ray's mesh
        off, w, h = (tx[:, 3 * slot + k] for k in range(3))
        bound = off >= 0
        w, h, off = torch.where(bound, w, 1), torch.where(bound, h, 1), torch.where(bound, off, 0)
        uc, vc = torch.clamp(uv[:, 0], 0.0, 0.999), torch.clamp(uv[:, 1], 0.0, 0.999)
        x = torch.minimum((uc * w.float()).to(torch.int32), w - 1)
        y = torch.minimum(((1.0 - vc) * h.float()).to(torch.int32), h - 1)
        return decode(sd.tex_pixels[((off + y * w) + x).long()]), bound

    oo = torch.stack([row3(iv, k, o) + iv[:, 9 + k] for k in range(3)], dim=1)
    dd = torch.stack([row3(iv, k, d) for k in range(3)], dim=1)
    w = (1.0 - u) - v
    nrm = normalize(torch.stack([(u * r[:, 3 + k] + v * r[:, 6 + k]) + w * r[:, k]
                                 for k in range(3)], dim=1))
    front = ((nrm[:, 0] * dd[:, 0] + nrm[:, 1] * dd[:, 1]) + nrm[:, 2] * dd[:, 2]) < 0.0
    nrm = torch.where(front[:, None], nrm, -nrm)
    uv = torch.stack([(u * r[:, 11 + k] + v * r[:, 13 + k]) + w * r[:, 9 + k] for k in range(2)],
                     dim=1)
    rgb, nm_bound = texel(4, uv)
    nm = 2.0 * rgb - 1.0
    bt = normalize(cross(nrm, r[:, 15:18]))
    tg = normalize(cross(bt, nrm))
    mapped = (tg * nm[:, 0:1] + bt * nm[:, 1:2]) + nrm * nm[:, 2:3]
    nrm = torch.where(nm_bound[:, None], mapped, nrm)
    nw = normalize(torch.stack([row3(xf, k, nrm) for k in range(3)], dim=1))
    po = oo + t[:, None] * dd
    pw = torch.stack([row3(xf[:, 9:], k, po) + xf[:, 18 + k] for k in range(3)], dim=1)

    # material rows [type, albedo, emission, roughness, metallic, ior] of kscene
    first = 5 * sd.n_spheres + 7 * sd.n_planes + 10 * sd.n_tris + 6 * sd.n_volumes
    rows = sd.kscene[first:first + 10 * n_mat].reshape(n_mat, 10)
    mid = torch.clamp(torch.where(is_mesh, ids[:, 2], fields["mat"]), 0, n_mat - 1).long()
    mrow = rows[mid].clone()
    synth = is_mesh & (ids[:, 2] < 0)
    srow = torch.tensor([float(mat.PARAMETERIZED), 0, 0, 0, 0, 0, 0, 1, 0, 1.5]).expand(n, 10)
    srow = srow.clone()
    for slot, cols in ((0, slice(1, 4)), (1, slice(4, 7)), (3, slice(7, 8)), (2, slice(8, 9))):
        rgb, bound = texel(slot, uv)
        val = rgb if cols.stop - cols.start == 3 else rgb[:, 0:1]
        srow[:, cols] = torch.where(bound[:, None], val, srow[:, cols])
    mrow = torch.where(synth[:, None], srow, mrow)
    return dict(point=torch.where(is_mesh[:, None], pw, fields["point"]),
                normal=torch.where(is_mesh[:, None], nw, fields["normal"]),
                frontface=torch.where(is_mesh, front, fields["frontface"]),
                mtype=mrow[:, 0].to(torch.int32), albedo=mrow[:, 1:4].contiguous(),
                emission=mrow[:, 4:7].contiguous(), roughness=mrow[:, 7].contiguous(),
                metallic=mrow[:, 8].contiguous(), ior=mrow[:, 9].contiguous())


@pytest.mark.parametrize("name", sorted(SCENES))
def test_kernel_arithmetic_matches_plain_on_cpu(name):
    """The kernel's operation order and packed tables reproduce
    resolve_mesh_winners bit for bit, every class of winner included."""
    sd = compiled(name, "cpu")
    ins = winners(sd, 3000, seed=len(name), dev="cpu")
    got = kernel_model(sd, *ins, decode=lambda b: b.to(torch.float32) / 255.0)
    assert_same(got, plain(sd, *ins), name)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_packed_tables(name):
    """kmesh_xfm holds after the plain version's 21 columns each mesh's
    inverse transform [R⁻¹ row-major, t⁻¹] and its [first kmesh_res row,
    triangles, material id], in resolve order; the scene picks the
    instantiation of its bindings."""
    sd = compiled(name, "cpu")
    order = resolve_order(sd.dense_mesh_ids, len(sd.meshes))
    first = 0
    for j, mi in enumerate(order):
        mesh = sd.meshes[mi]
        inv = mesh.inv_transform
        assert torch.equal(sd.kmesh_xfm[j, INV_R], inv[:3, :3].reshape(-1))
        assert torch.equal(sd.kmesh_xfm[j, INV_T], inv[:3, 3])
        nt = mesh.tri_normals.shape[0]
        assert sd.kmesh_xfm[j, FIRST:].tolist() == [first, nt, mesh.mat_id]
        first += nt
    assert sd.kmesh_res.shape[0] == first
    assert sd.kmesh_xfm.shape == (len(order), 36)
    assert resolve.variant(sd) == VARIANTS[name]


def test_tables_without_a_mesh():
    """One inert row of kmesh_xfm, as of kmesh_res and kmesh_tex: a scene
    without a mesh never launches the resolve."""
    from cs397raytracingsp22_tpu_torch.scenes import cornell

    sd = cornell.build(8, 8, spp=1).compile(device="cpu")
    assert not sd.meshes
    assert sd.kmesh_xfm.tolist() == [[0.0] * 36] and sd.kmesh_tex.tolist() == [[-1] * 15]


@pytest.mark.parametrize("name", ["demo", "kitchen_sink"])
def test_cpu_tensors_take_the_plain_version(name):
    sd = compiled(name, "cpu")
    ins = winners(sd, 500, seed=3, dev="cpu")
    before = dict(resolve.LAUNCHES)
    assert_same(resolve.resolve_winners(sd, *ins), plain(sd, *ins), name)
    assert resolve.LAUNCHES == before
    if not torch.cuda.is_available():
        assert before == {"resolve": 0}


@pytest.mark.parametrize("bad", ["float64_t", "int64_code", "strided_o", "strided_u", "shape_d",
                                 "shape_mat", "bool_mat", "cuda_expected"])
def test_launch_checks_raise(bad):
    """What a launch checks before it launches, on CPU tensors against the
    device a launch expects."""
    sd = compiled("kitchen_sink", "cpu")
    o, d, code, t, idx, u, v, fields = winners(sd, 64, seed=5, dev="cpu")
    dev = torch.device("cpu")
    assert resolve.check_inputs(sd, o, d, code, t, idx, u, v, fields, dev) == 64
    if bad == "float64_t":
        t = t.double()
    elif bad == "int64_code":
        code = code.long()
    elif bad == "strided_o":
        o = torch.cat([o, o], dim=1)[:, ::2]
    elif bad == "strided_u":
        u = torch.stack([u, u], dim=1)[:, 0]
    elif bad == "shape_d":
        d = d[:63]
    elif bad == "shape_mat":
        fields = dict(fields, mat=fields["mat"][:, None])
    elif bad == "bool_mat":
        fields = dict(fields, mat=fields["mat"] > 0)
    else:
        dev = torch.device("cuda")  # CPU tensors where the launch's device is CUDA
    with pytest.raises(ValueError):
        resolve.check_inputs(sd, o, d, code, t, idx, u, v, fields, dev)


def test_other_devices_raise():
    """A meta tensor: the resolve takes CPU or CUDA tensors."""
    sd = compiled("bench", "cpu")
    ins = [x.to("meta") for x in winners(sd, 8, seed=1, dev="cpu")[:7]]
    fields = {k: x.to("meta") for k, x in winners(sd, 8, seed=1, dev="cpu")[7].items()}
    with pytest.raises(ValueError, match="CPU or CUDA"):
        resolve.resolve_winners(sd, *ins, fields)


def test_fused_cpu_path_resolves_with_the_plain_version():
    """intersect_scene_fused on CPU tensors: the resolve runs the plain
    version (no launch) and equals intersect_scene_plain bit for bit on the
    kitchen sink's camera rays."""
    sd = compiled("kitchen_sink", "cpu")
    cam = kitchen_sink.build(32, 32, spp=1).camera
    o, d, uids = driver._gen_chunk_rays(cam, torch.arange(32 * 32, dtype=torch.int32), 3, 0, 1, 1)
    u_vol = integrator._bounce_draws(sd, 3, uids, rnglib.SITE_BOUNCE0)[2]
    before = dict(resolve.LAUNCHES)
    fused = isect.intersect_scene_fused(sd, o, d, integrator.PATH_T_MIN, 100.0, u_vol)
    ref = isect.intersect_scene_plain(sd, o, d, integrator.PATH_T_MIN, 100.0, u_vol)
    assert resolve.LAUNCHES == before
    assert torch.equal(fused.valid, ref.valid) and bool(fused.valid.any())
    keep = fused.valid
    assert_same({f: getattr(fused, f)[keep] for f in FIELDS},
                {f: getattr(ref, f)[keep] for f in FIELDS})


# --------------------------------------------------------------- card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("n", [70_001, 1 << 20])
def test_resolve_on_card(cuda, name, n):
    """Seeded winners of every class: every output of R1 bit-identical to
    resolve_mesh_winners on the same card, in one launch."""
    sd = compiled(name, "cuda")
    ins = winners(sd, n, seed=n + len(name), dev=cuda)
    before = resolve.LAUNCHES["resolve"]
    got = resolve.resolve_winners(sd, *ins)
    assert resolve.LAUNCHES["resolve"] == before + 1
    assert_same(got, plain(sd, *ins), name)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SCENES))
def test_rendered_rays_on_card(cuda, name, monkeypatch):
    """The winners that K2 and K3 give the camera rays and the rays of
    bounces 1-3 of a 64² × 4 spp chunk (each call of the resolve during
    those bounces compared as it happens), mesh winners among them."""
    sd = compiled(name, "cuda")
    cam = dataclasses.replace(SCENES[name]().camera, screen_width=64, screen_height=64)
    calls, mesh_hits = [0], set()
    launch = resolve.resolve_winners

    def checked(scene, o, d, code, t, idx, u, v, fields):
        got = launch(scene, o, d, code, t, idx, u, v, fields)
        assert_same(got, plain(scene, o, d, code, t, idx, u, v, fields), (name, calls[0]))
        mesh_hits.update(int(c) for c in code.unique() if c >= isect.CODE_MESH0)
        calls[0] += 1
        return got

    monkeypatch.setattr(resolve, "resolve_winners", checked)
    ids = torch.arange(64 * 64, dtype=torch.int32, device=cuda)
    o, d, uids = driver._gen_chunk_rays(cam, ids, 5, 0, 4, 1)
    thr, rad = torch.ones_like(o), torch.zeros_like(o)
    alive = torch.ones((o.shape[0],), dtype=torch.bool, device=cuda)
    for b in range(4):
        o, d, thr, rad, alive, _, _ = integrator.bounce_update(
            sd, o, d, thr, rad, alive, uids, 5, b, 100.0, intersect=isect.intersect_scene)
    assert calls[0] == 4
    assert mesh_hits, name


@pytest.mark.gpu
def test_card_launch_checks_raise(cuda):
    sd = compiled("kitchen_sink", "cuda")
    o, d, code, t, idx, u, v, fields = winners(sd, 64, seed=9, dev=cuda)
    for bad in (dict(t=t.double()), dict(o=torch.cat([o, o], dim=1)[:, ::2]),
                dict(code=code.long()), dict(u=u[:32])):
        args = dict(o=o, d=d, code=code, t=t, idx=idx, u=u, v=v) | bad
        with pytest.raises(ValueError):
            resolve.resolve_winners(sd, **args, fields=fields)
    with pytest.raises(ValueError):
        resolve.resolve_winners(sd, o, d, code, t, idx, u, v, {**fields, "mat": fields["mat"].cpu()})


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["demo.staged", "bench.nee"])
def test_render_launch_counts(cuda, cell, monkeypatch):
    """One R1 launch per intersect_scene call of a render of the cell's
    scene (the bounces' and, with NEE, the shadow rays' calls)."""
    if cell == "demo.staged":
        scene = drone_demo.build(1024, 1024, spp=64, path_depth=10)
    else:
        scene = bench_scene.build(512, 512, spp=64, path_depth=8)
        scene = dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, nee=True))
    calls = [0]
    fused = isect.intersect_scene_fused

    def counted(*args, **kwargs):
        calls[0] += 1
        return fused(*args, **kwargs)

    monkeypatch.setattr(isect, "intersect_scene_fused", counted)
    before = resolve.LAUNCHES["resolve"]
    _, stats = driver.render_to_image(scene, device=cuda, seed=11, verbose=False)
    torch.cuda.synchronize()
    depth = scene.camera.path_depth
    want = stats.chunks * (2 * depth - 1 if cell == "bench.nee" else depth)
    assert calls[0] == want
    assert resolve.LAUNCHES["resolve"] - before == want
