"""The plain reference path tracer: a sample of an image's pixels from the
scene's tables (reference/scene.py) and the image's seed.

The estimator of the reference renderer (tracing.rs:300-324), as the
renderer's published scene format and draw scheme define it: multi-jittered
camera rays through a thin lens, nearest hit over every primitive by plain
scans (every sphere, plane, triangle and sphere-bounded volume, every
triangle of every mesh in its object space), mesh shading with smooth
normals, texcoords, nearest-texel maps, the TBN normal map and materials
made from textures, the five-material BSDF, and optionally next-event
estimation with one shadow ray a diffuse-like vertex. Ties between
classes go to the earlier class (spheres, planes, triangles, volumes,
meshes); within a class to the lower index.

Every float is computed in the scene's dtype (float32 for the reference,
bfloat16 for the control). Rays are traced in blocks and each bounce runs
on the live rays only, so memory stays bounded and dead rays cost
nothing.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import rng
from benchmark.reference.scene import (
    DIELECTRIC, ISOTROPIC, LAMBERTIAN, METAL, PARAMETERIZED, Mesh, RefScene,
)

PI = 3.14159265358979
T_MIN = 0.001
SHADOW_T_MAX = 1.0 - 1e-3
MT_EPS = 1e-4
# (ray, triangle) pairs a mesh scan holds at once
PAIRS = 1 << 24
BIG = float("inf")


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize(v, eps: float = 0.0):
    return v / torch.sqrt(dot(v, v) + eps)[..., None]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def mat_point(m, p):
    return m[:3, 0] * p[..., 0:1] + m[:3, 1] * p[..., 1:2] + m[:3, 2] * p[..., 2:3] + m[:3, 3]


def mat_vec(m, v):
    return m[:3, 0] * v[..., 0:1] + m[:3, 1] * v[..., 1:2] + m[:3, 2] * v[..., 2:3]


def fresnel(v, n, ir):
    ir = torch.as_tensor(ir, dtype=v.dtype, device=v.device)
    r0 = (ir - 1.0) / (ir + 1.0)
    r0 = r0 * r0
    x = 1.0 - torch.abs(dot(v, n))
    x2 = x * x
    return r0 + (1.0 - r0) * (x * (x2 * x2))


def camera_rays(scene: RefScene, seed: int, pixel_ids: torch.Tensor):
    """(origins, directions, uids), each (P·spp, ...), for every sample of
    the pixels `pixel_ids` (tracing.rs:137-209)."""
    cam, dt, dev = scene.camera, scene.dtype, pixel_ids.device
    spp, width, height = cam["aa_sample_count"], cam["screen_width"], cam["screen_height"]
    n_px = pixel_ids.shape[0]
    ids = pixel_ids.to(torch.int32)
    x = (ids % width).to(dt)
    y = torch.div(ids, width, rounding_mode="floor").to(dt)
    pixel_size = 1.0 / float(height)
    n = float(spp)
    rootn = math.sqrt(n)
    rootn_i = int(rootn)
    sample = torch.arange(spp, dtype=torch.int32, device=dev)
    uids = (ids[:, None] * spp + sample[None, :]).reshape(-1)
    u4 = rng.counter_uniforms(seed, uids, rng.SITE_CAMERA, 4, dt)
    rand_x = torch.floor(u4[:, 0] * n).reshape(n_px, spp)
    rand_y = torch.floor(u4[:, 1] * n).reshape(n_px, spp)
    sub_x = torch.div(sample, rootn_i, rounding_mode="floor").to(dt)[None, :]
    sub_y = (sample % rootn_i).to(dt)[None, :]
    off_x = (sub_x - 0.5 * rootn) * pixel_size / rootn + (rand_x - 0.5 * n) * pixel_size / n
    off_y = (sub_y - 0.5 * rootn) * pixel_size / rootn + (rand_y - 0.5 * n) * pixel_size / n
    cx = pixel_size * (x[:, None] - 0.5 * width + 0.5) + off_x
    cy = pixel_size * (0.5 + 0.5 * height - y[:, None]) + off_y
    center = torch.stack([cx, cy, torch.full_like(cx, -cam["focal_length"])], dim=-1)
    view = torch.tensor(cam["view_dir"], dtype=dt, device=dev)
    up = torch.tensor(cam["up"], dtype=dt, device=dev)
    rot = torch.stack([normalize(cross(view, up)), up, -view], dim=-1)
    lens = cam.get("lens_radius", 0.0) * rng.disk(u4[:, 2:4]).reshape(n_px, spp, 3)
    focus = normalize(center) * cam["focus_dist"]
    eye = torch.tensor(cam["eyepoint"], dtype=dt, device=dev)
    rotate = lambda v: rot[:, 0] * v[..., 0:1] + rot[:, 1] * v[..., 1:2] + rot[:, 2] * v[..., 2:3]  # noqa: E731
    o = eye + rotate(lens)
    d = rotate(normalize(focus - lens))
    return o.reshape(-1, 3), d.reshape(-1, 3), uids


def _nearest(t, valid):
    """Per row the nearest valid column: (t inf where none, index, valid)."""
    t_m = torch.where(valid, t, torch.full_like(t, BIG))
    idx = torch.argmin(t_m, dim=1)
    rows = torch.arange(t.shape[0], device=t.device)
    return t_m[rows, idx], idx, valid[rows, idx]


def _sphere_roots(o, d, center, radius):
    f = o[:, None, :] - center
    dd = d[:, None, :]
    a = dot(dd, dd)
    b = 2.0 * dot(f, dd)
    c = dot(f, f) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    return disc >= 0.0, (-b - sq) / (2.0 * a), (-b + sq) / (2.0 * a)


def _mt(o, d, a, e1, e2):
    """Möller–Trumbore of rays (N, 1, 3) against rows (1, K, 3): (|det|
    passes, t, u, v), (N, K) each."""
    q = cross(d, e2)
    det = dot(e1, q)
    ok = torch.abs(det) >= MT_EPS
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    s = o - a
    u = inv * dot(s, q)
    r = cross(s, e1)
    v = inv * dot(d, r)
    t = inv * dot(e2, r)
    return ok, t, u, v


def _blank(n, like, dt):
    return dict(valid=torch.zeros(n, dtype=torch.bool, device=like.device),
                t=torch.full((n,), BIG, dtype=dt, device=like.device))


def _analytic(scene: RefScene, o, d, t_min, t_max, u_vol):
    """The nearest hit of each analytic class as candidate dicts."""
    n, dt = o.shape[0], scene.dtype
    tmn, tmx = t_min[:, None], t_max[:, None]
    out = []
    center, radius, mat = scene.spheres
    c = _blank(n, o, dt)
    if radius.numel():
        ok, t1, t2 = _sphere_roots(o, d, center, radius)
        t = torch.where(t1 >= tmn, t1, t2)
        t, i, v = _nearest(t, ok & (t >= tmn) & (t <= tmx))
        p = o + t[:, None] * d
        nrm = normalize(p - center[i], eps=1e-30)
        ff = dot(nrm, d) < 0.0
        c = dict(valid=v, t=t, point=p, normal=torch.where(ff[:, None], nrm, -nrm), frontface=ff,
                 mat=mat[i])
    out.append(c)
    point, normal, mat = scene.planes
    c = _blank(n, o, dt)
    if mat.numel():
        od = dot(o[:, None, :] - point, normal)
        sgn = torch.where(od >= 0.0, 1.0, -1.0).to(dt)
        nn = sgn[..., None] * normal
        dd = dot(d[:, None, :], nn)
        t = torch.abs(od) / torch.abs(dd)
        t, i, v = _nearest(t, (dd < 0.0) & (t >= tmn) & (t <= tmx))
        n_pre = torch.where(dot(o - point[i], normal[i]) >= 0.0, 1.0, -1.0).to(dt)[:, None] * normal[i]
        ff = dot(n_pre, d) < 0.0
        c = dict(valid=v, t=t, point=o + t[:, None] * d,
                 normal=torch.where(ff[:, None], n_pre, -n_pre), frontface=ff, mat=mat[i])
    out.append(c)
    ta, tb, tc, mat = scene.triangles
    c = _blank(n, o, dt)
    if mat.numel():
        e1, e2 = tb - ta, tc - ta
        ok, t, u, v = _mt(o[:, None, :], d[:, None, :], ta, e1, e2)
        t, i, val = _nearest(t, ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= tmn)
                             & (t <= tmx))
        g = normalize(cross(e1[i], e2[i]), eps=1e-30)
        ff = dot(g, d) < 0.0
        c = dict(valid=val, t=t, point=o + t[:, None] * d, normal=torch.where(ff[:, None], g, -g),
                 frontface=ff, mat=mat[i])
    out.append(c)
    center, radius, density, mat = scene.volumes
    c = _blank(n, o, dt)
    if mat.numel():
        ok, t1, t2 = _sphere_roots(o, d, center, radius)
        t_start = torch.maximum(t1, tmn)
        t_end = torch.minimum(t2, tmx)
        dist = (-1.0 / density) * torch.log(torch.clamp(u_vol[:, :mat.numel()], min=1e-38))
        valid = (ok & (t2 >= t1 + 1e-4) & (t2 >= tmn) & (t1 <= tmx)
                 & (dist < t_end - t_start))
        t, i, v = _nearest(t_start + dist, valid)
        c = dict(valid=v, t=t, point=o + t[:, None] * d, normal=torch.zeros_like(o),
                 frontface=torch.zeros_like(v), mat=mat[i])
    out.append(c)
    return out


def _texel(tex, uv):
    """Nearest texel of a (H, W, 3) uint8 map at (N, 2) uv, in [0, 1]."""
    h, w = tex.shape[0], tex.shape[1]
    u = torch.clamp(uv[:, 0], 0.0, 0.999)
    v = torch.clamp(uv[:, 1], 0.0, 0.999)
    x = torch.clamp((u * w).to(torch.int32), max=w - 1).long()
    y = torch.clamp(((1.0 - v) * h).to(torch.int32), max=h - 1).long()
    return tex[y, x].to(uv.dtype) / 255.0


def _bary(corners, u, v):
    return (u[:, None] * corners[:, 1] + v[:, None] * corners[:, 2]
            + (1.0 - u - v)[:, None] * corners[:, 0])


def _box_hit(m: Mesh, o_obj, d_obj, t_min, t_max):
    """Rays whose window meets the mesh's padded object-space box: no
    other ray can hit one of its triangles."""
    inv = 1.0 / d_obj
    t0, t1 = (m.box[0] - o_obj) * inv, (m.box[1] - o_obj) * inv
    near, far = torch.fmin(t0, t1), torch.fmax(t0, t1)
    lo = torch.fmax(torch.fmax(near[:, 0], near[:, 1]), torch.fmax(near[:, 2], t_min))
    hi = torch.fmin(torch.fmin(far[:, 0], far[:, 1]), torch.fmin(far[:, 2], t_max))
    return hi >= lo


def _mesh(scene: RefScene, m: Mesh, o, d, t_min, t_max):
    """One mesh's nearest hit and its shading (geometry.rs:274-349)."""
    n = o.shape[0]
    o_obj, d_obj = mat_point(m.inv_transform, o), mat_vec(m.inv_transform, d)
    nt = m.a.shape[0]
    best = t_max.clone()
    row = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    bu, bv = torch.zeros_like(best), torch.zeros_like(best)
    sel = _box_hit(m, o_obj, d_obj, t_min, t_max).nonzero()[:, 0]
    if sel.numel():
        so, sd, smin = o_obj[sel], d_obj[sel], t_min[sel][:, None]
        sbest, srow = best[sel], row[sel]
        su, sv = bu[sel], bv[sel]
        step = max(1, PAIRS // sel.numel())
        rows = torch.arange(sel.numel(), device=o.device)
        for r0 in range(0, nt, step):
            ok, t, u, v = _mt(so[:, None, :], sd[:, None, :], m.a[None, r0:r0 + step],
                              m.e1[None, r0:r0 + step], m.e2[None, r0:r0 + step])
            ok = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= smin)
                  & (t < sbest[:, None]))
            k = torch.argmin(torch.where(ok, t, torch.full_like(t, BIG)), dim=1)
            better = ok[rows, k]
            sbest = torch.where(better, t[rows, k], sbest)
            srow = torch.where(better, r0 + k, srow)
            su = torch.where(better, u[rows, k], su)
            sv = torch.where(better, v[rows, k], sv)
        best[sel], row[sel], bu[sel], bv[sel] = sbest, srow, su, sv
    hit = row >= 0
    tri = torch.clamp(row, min=0)
    n_s = normalize(_bary(m.normals[tri], bu, bv), eps=1e-30)
    ff = dot(n_s, d_obj) < 0.0
    n_flip = torch.where(ff[:, None], n_s, -n_s)
    uv = _bary(m.uvs[tri], bu, bv)
    n_obj = n_flip
    if m.textures[4] is not None:
        nm = 2.0 * _texel(m.textures[4], uv) - 1.0
        bit = normalize(cross(n_flip, m.tangent[tri]), eps=1e-30)
        tan = normalize(cross(bit, n_flip), eps=1e-30)
        n_obj = tan * nm[:, 0:1] + bit * nm[:, 1:2] + n_flip * nm[:, 2:3]
    out = dict(valid=hit, t=torch.where(hit, best, torch.full_like(best, BIG)),
               point=mat_point(m.transform, o_obj + best[:, None] * d_obj),
               normal=normalize(mat_vec(m.normal_mat, n_obj), eps=1e-30), frontface=ff)
    if m.mat >= 0:
        out["mat"] = torch.full((n,), m.mat, dtype=torch.int64, device=o.device)
    else:
        tex = [None if x is None else _texel(x, uv) for x in m.textures[:4]]
        zero3 = torch.zeros_like(o)
        out["material"] = dict(
            mtype=torch.full((n,), PARAMETERIZED, dtype=torch.int64, device=o.device),
            albedo=zero3 if tex[0] is None else tex[0],
            emission=zero3 if tex[1] is None else tex[1],
            metallic=torch.zeros_like(best) if tex[2] is None else tex[2][:, 0],
            roughness=torch.ones_like(best) if tex[3] is None else tex[3][:, 0],
            ior=torch.full_like(best, 1.5))
    return out


_FIELDS = ("mtype", "albedo", "emission", "roughness", "metallic", "ior")


def intersect(scene: RefScene, o, d, t_min, t_max, u_vol):
    """The nearest hit over the scene: a dict of valid, t, point, normal,
    frontface and the material's fields."""
    cands = _analytic(scene, o, d, t_min, t_max, u_vol)
    cands += [_mesh(scene, m, o, d, t_min, t_max) for m in scene.meshes]
    for c in cands:
        if "material" in c:
            continue
        if "mat" not in c:  # an empty class
            c["material"] = None
            continue
        i = c["mat"]
        c["material"] = dict(mtype=scene.mat_type[i], albedo=scene.mat_albedo[i],
                             emission=scene.mat_emission[i], roughness=scene.mat_roughness[i],
                             metallic=scene.mat_metallic[i], ior=scene.mat_ior[i])
    live = [c for c in cands if c["material"] is not None]
    win = torch.argmin(torch.stack([c["t"] for c in cands], dim=1), dim=1)
    hit = {}
    for key in ("t", "point", "normal", "frontface") + _FIELDS:
        out = None
        for g, c in enumerate(cands):
            if c["material"] is None:
                continue
            val = c[key] if key in c else c["material"][key]
            if out is None:
                out = val
                continue
            sel = win == g
            out = torch.where(sel[:, None] if val.ndim > 1 else sel, val, out)
        hit[key] = out
    valid = torch.zeros_like(live[0]["valid"])
    for g, c in enumerate(cands):
        if c["material"] is not None:
            valid = valid | ((win == g) & c["valid"])
    hit["valid"] = valid
    return hit


def scatter(hit, d_in, ball, u_choice):
    """The five-material BSDF (materials.rs): (direction, attenuation,
    1/pdf)."""
    n, albedo = hit["normal"], hit["albedo"]
    dd = dot(ball, n)[:, None]
    hemi = torch.where(dd < 0.0, ball - 2.0 * dd * n, ball)
    two_pi = torch.full_like(u_choice, rng.TWO_PI)
    one = torch.ones_like(u_choice)
    refl = d_in - 2.0 * dot(d_in, n)[:, None] * n
    met_dir = refl + hit["roughness"][:, None] * ball
    ior = hit["ior"]
    eta = torch.where(hit["frontface"], 1.0 / ior, ior)
    cos_in = torch.clamp(dot(-d_in, n), max=1.0)
    critical = eta * torch.sqrt(torch.clamp(1.0 - cos_in * cos_in, min=0.0)) > 1.0
    refract = (~critical) & (u_choice >= fresnel(d_in, n, ior))
    perp = eta[:, None] * (d_in + cos_in[:, None] * n)
    par = -torch.sqrt(torch.abs(1.0 - dot(perp, perp)))[:, None] * n
    die_dir = torch.where(refract[:, None], perp + par, refl)
    k_s = fresnel(d_in, n, 1.5) * (1.0 - hit["roughness"])
    k_d = (1.0 - k_s) * (1.0 - hit["metallic"])
    diffuse = u_choice < k_d
    par_dir = torch.where(diffuse[:, None], hemi, met_dir)
    mk = hit["metallic"][:, None]
    par_att = torch.where(diffuse[:, None], albedo / PI,
                          (1.0 - mk) * torch.ones_like(albedo) + mk * albedo)
    par_ipdf = torch.where(diffuse, two_pi, one)
    t = hit["mtype"]

    def pick(lam, met, die, par_, iso):
        def m(code):
            return (t == code)[:, None] if lam.ndim == 2 else t == code
        out = torch.where(m(METAL), met, lam)
        out = torch.where(m(DIELECTRIC), die, out)
        out = torch.where(m(PARAMETERIZED), par_, out)
        return torch.where(m(ISOTROPIC), iso, out)

    return (pick(hemi, met_dir, die_dir, par_dir, ball),
            pick(albedo / PI, albedo, torch.ones_like(albedo), par_att, albedo),
            pick(two_pi, one, one, par_ipdf, one))


def _light_point(scene: RefScene, u_pick, u1, u2):
    n_t, n_s = scene.lt_tri.shape[0], scene.lt_sph.shape[0]
    n_l = n_t + n_s
    pick = torch.clamp((u_pick * n_l).to(torch.int32), max=n_l - 1).long()
    x = torch.zeros(u1.shape + (3,), dtype=u1.dtype, device=u1.device)
    nrm, emi, inv_pdf = torch.zeros_like(x), torch.zeros_like(x), torch.zeros_like(u1)
    if n_t:
        row = scene.lt_tri[torch.clamp(pick, 0, n_t - 1)]
        a, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
        su = torch.sqrt(torch.clamp(u1, min=0.0))
        is_t = pick < n_t
        x = torch.where(is_t[:, None], a + (su * (1.0 - u2))[:, None] * e1 + (su * u2)[:, None] * e2, x)
        nrm = torch.where(is_t[:, None], normalize(cross(e1, e2), eps=1e-30), nrm)
        emi = torch.where(is_t[:, None], row[:, 9:12], emi)
        inv_pdf = torch.where(is_t, n_l * row[:, 12], inv_pdf)
    if n_s:
        row = scene.lt_sph[torch.clamp(pick - n_t, 0, n_s - 1)]
        z = 1.0 - 2.0 * u1
        rr = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = 2.0 * PI * u2
        w = torch.stack([rr * torch.cos(phi), rr * torch.sin(phi), z], dim=-1)
        is_s = pick >= n_t
        x = torch.where(is_s[:, None], row[:, 0:3] + row[:, 3:4] * w, x)
        nrm = torch.where(is_s[:, None], w, nrm)
        emi = torch.where(is_s[:, None], row[:, 4:7], emi)
        inv_pdf = torch.where(is_s, n_l * 4.0 * PI * row[:, 3] * row[:, 3], inv_pdf)
    return x, nrm, emi, inv_pdf


def _direct(scene: RefScene, hit, d_in, u_choice, live, uids, seed, depth, max_dist):
    """One next-event sample a live diffuse-like vertex: (contribution, did)."""
    n_vol = scene.volumes[3].numel()
    u = rng.counter_uniforms(seed, uids, rng.SITE_NEE0 + depth, 4 + max(n_vol, 1), scene.dtype)
    x, n_l, emission, inv_pdf = _light_point(scene, u[:, 0], u[:, 1], u[:, 2])
    has_n = dot(hit["normal"], hit["normal"]) > 0.0
    t = hit["mtype"]
    lam = (t == LAMBERTIAN) & has_n
    iso = (t == ISOTROPIC) & ~has_n
    par = (t == PARAMETERIZED) & has_n
    k_s = fresnel(d_in, hit["normal"], 1.5) * (1.0 - hit["roughness"])
    k_d = (1.0 - k_s) * (1.0 - hit["metallic"])
    did = live & (lam | iso | (par & (u_choice < k_d)))
    f = torch.where(iso[:, None], hit["albedo"] / (4.0 * PI), hit["albedo"] / PI)
    to_l = x - hit["point"]
    dist2 = dot(to_l, to_l)
    inv_dist = torch.rsqrt(torch.clamp(dist2, min=1e-12))
    dist = dist2 * inv_dist
    wl = to_l * inv_dist[:, None]
    cos_x = torch.where(has_n, torch.clamp(dot(wl, hit["normal"]), 0.0, 1.0), torch.ones_like(dist))
    cos_y = torch.abs(dot(wl, n_l))
    r_len = torch.clamp(u[:, 3] ** (1.0 / 3.0), min=1e-6)
    t_light = dist / r_len
    shoot = did & (t_light <= max_dist)
    sh_o = torch.where(shoot[:, None], hit["point"], 0.0)
    sh_d = torch.where(shoot[:, None], wl * r_len[:, None], 1.0)
    t_max = torch.where(shoot, SHADOW_T_MAX * t_light, 0.0)
    sh = intersect(scene, sh_o, sh_d, torch.full_like(t_max, T_MIN), t_max, u[:, 4:])
    geo = cos_x * cos_y / torch.clamp(dist2, min=1e-12) * inv_pdf
    geo = geo * torch.where(~iso, r_len, torch.ones_like(r_len))
    ok = shoot & ~sh["valid"]
    return torch.where(ok[:, None], f * emission * geo[:, None], 0.0), did


def trace(scene: RefScene, o, d, uids, seed: int, nee: bool, stats=None):
    """Radiance (N, 3) of each camera ray (tracing.rs:300-324), with
    next-event estimation where nee. stats, when a list, receives per
    bounce (o, d, t_hit) of the live rays, for work counts."""
    cam, dt = scene.camera, scene.dtype
    depth_max, max_dist = cam["path_depth"], cam["max_trace_dist"]
    n = o.shape[0]
    out = torch.zeros((n, 3), dtype=dt, device=o.device)
    thr = torch.ones_like(out)
    rad = torch.zeros_like(out)
    pos = torch.arange(n, device=o.device)
    prev_nee = torch.zeros(n, dtype=torch.bool, device=o.device)
    n_vol = scene.volumes[3].numel()
    for depth in range(depth_max):
        if pos.numel() == 0:
            break
        u = rng.bounce_uniforms(seed, uids, rng.SITE_BOUNCE0 + depth, 4 + max(n_vol, 1), dt)
        ball, u_choice, u_vol = rng.ball(u[:, 0:3]), u[:, 3], u[:, 4:]
        t_min = torch.full((o.shape[0],), T_MIN, dtype=dt, device=o.device)
        hit = intersect(scene, o, d, t_min, torch.full_like(t_min, max_dist), u_vol)
        if stats is not None:
            stats.append((o, d, torch.where(hit["valid"], hit["t"], torch.full_like(hit["t"], BIG))))
        live = hit["valid"]
        emit = live & ~prev_nee if nee else live
        rad = rad + torch.where(emit[:, None], thr * hit["emission"], 0.0)
        new_dir, att, inv_pdf = scatter(hit, d, ball, u_choice)
        has_n = dot(hit["normal"], hit["normal"]) > 0.0
        dot_term = torch.where(has_n, torch.clamp(torch.abs(dot(new_dir, hit["normal"])), 0.0, 1.0),
                               torch.ones_like(inv_pdf))
        if nee and depth < depth_max - 1:
            contrib, did = _direct(scene, hit, d, u_choice, live, uids, seed, depth, max_dist)
            rad = rad + torch.where(live[:, None], thr * contrib, 0.0)
            prev_nee = live & did
        thr = thr * ((dot_term * inv_pdf)[:, None] * att)
        out[pos[~live]] = rad[~live]
        keep = live.nonzero()[:, 0]
        o, d, thr, rad = hit["point"][keep], new_dir[keep], thr[keep], rad[keep]
        uids, pos, prev_nee = uids[keep], pos[keep], prev_nee[keep]
    out[pos] = rad
    return out


def tonemap(color, gamma: float):
    """Channel bleed, clamp, gamma, u8 (tracing.rs:241-256)."""
    color = color.float()
    excess = torch.clamp(color - 1.0, min=0.0)
    total = (excess[..., 0] + excess[..., 1] + excess[..., 2])[..., None]
    c = torch.clamp(color + (total - excess), 0.0, 1.0)
    return (torch.pow(c, 1.0 / gamma) * 255.9999).to(torch.uint8)


def render_pixels(scene: RefScene, seed: int, pixel_ids: torch.Tensor, block: int = 1 << 18):
    """(P, 3) uint8: the image of seed `seed` at pixels `pixel_ids`, every
    sample, traced in blocks of about `block` rays."""
    spp = scene.camera["aa_sample_count"]
    per = max(1, block // spp)
    out = []
    for p0 in range(0, pixel_ids.shape[0], per):
        ids = pixel_ids[p0:p0 + per]
        o, d, uids = camera_rays(scene, seed, ids)
        rad = trace(scene, o, d, uids, seed, bool(scene.camera.get("nee", False)))
        out.append(rad.reshape(ids.shape[0], spp, 3).float().sum(dim=1))
    acc = torch.cat(out) / float(spp)
    return tonemap(acc, scene.camera["gamma"])
