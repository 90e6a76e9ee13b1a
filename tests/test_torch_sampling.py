"""vecmath, sampling and tonemap of the torch port against the JAX package.

Float outputs agree within atol 2e-6: both sides run the same float32
formulas, and the residue is the order XLA and torch give to a sum or a
library sin/cos/log (about one ulp at unit scale). Tonemap u8 values are
within 1 and exact on at least 99.9% of subpixels: a pow() that differs
in the last bit can tip a value across a quantization step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs397raytracingsp22_tpu.ops import tonemap as jtm
from cs397raytracingsp22_tpu.utils import sampling as js
from cs397raytracingsp22_tpu.utils import vecmath as jvm
from cs397raytracingsp22_tpu_torch.ops import tonemap as ttm
from cs397raytracingsp22_tpu_torch.utils import sampling as ts
from cs397raytracingsp22_tpu_torch.utils import vecmath as tvm

torch.set_num_threads(1)  # several test workers share the cores

ATOL = 2e-6
N = 2048


def _rng(seed):
    return np.random.default_rng(seed)


def _vec(rng, n=N):
    return rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=atol)


def _both(fn_j, fn_t, *arrays):
    return fn_j(*[jnp.asarray(a) for a in arrays]), fn_t(*[torch.from_numpy(a) for a in arrays])


NAMES = ["dot", "vdot", "magnitude2", "magnitude", "normalize", "cross", "reflect",
     "clampvec", "apply_mat3", "apply_mat4_point", "apply_mat4_vector", "signum"]


@pytest.mark.parametrize("name", NAMES)
def test_vecmath(name):
    rng = _rng(NAMES.index(name))
    a, b = _vec(rng), _vec(rng)
    m3 = rng.uniform(-1.0, 1.0, (3, 3)).astype(np.float32)
    m4 = rng.uniform(-1.0, 1.0, (4, 4)).astype(np.float32)
    cases = {
        "dot": ((a, b), lambda m: m.dot),
        "vdot": ((a, b), lambda m: m.vdot),
        "magnitude2": ((a,), lambda m: m.magnitude2),
        "magnitude": ((a,), lambda m: m.magnitude),
        "normalize": ((a,), lambda m: m.normalize),
        "cross": ((a, b), lambda m: m.cross),
        "reflect": ((a, tvm.normalize(torch.from_numpy(b)).numpy()), lambda m: m.reflect),
        "clampvec": ((a,), lambda m: (lambda v: m.clampvec(v, -0.5, 0.5))),
        "apply_mat3": ((m3, a), lambda m: m.apply_mat3),
        "apply_mat4_point": ((m4, a), lambda m: m.apply_mat4_point),
        "apply_mat4_vector": ((m4, a), lambda m: m.apply_mat4_vector),
        "signum": ((np.concatenate([a[:, 0], [0.0, -0.0]]).astype(np.float32),),
                   lambda m: m.signum),
    }
    args, pick = cases[name]
    j, t = _both(pick(jvm), pick(tvm), *args)
    _close(j, t)


def test_fresnel_refract_lerp():
    rng = _rng(1)
    v = tvm.normalize(torch.from_numpy(_vec(rng))).numpy()
    n = tvm.normalize(torch.from_numpy(_vec(rng))).numpy()
    ior = rng.uniform(1.0, 2.5, N).astype(np.float32)
    eta = rng.uniform(0.4, 1.0, N).astype(np.float32)
    k = rng.uniform(0, 1, N).astype(np.float32)
    _close(*_both(jvm.fresnel, tvm.fresnel, v, n, ior))
    _close(jvm.fresnel(jnp.asarray(v), jnp.asarray(n), 1.5),
           tvm.fresnel(torch.from_numpy(v), torch.from_numpy(n), 1.5))
    _close(*_both(jvm.refract, tvm.refract, v, n, eta))
    _close(*_both(jvm.lerpvec, tvm.lerpvec, v, n, k))


def test_sincos_cbrt():
    rng = _rng(2)
    u = np.concatenate([rng.random(N), [0.0, 0.125, 0.25, 0.5, 0.75, 1 - 2**-24]]).astype(np.float32)
    cj, sj = js.sincos_2pi(jnp.asarray(u))
    ct, st = ts.sincos_2pi(torch.from_numpy(u))
    _close(cj, ct)
    _close(sj, st)
    _close(js.cbrt_fast(jnp.asarray(u)), ts.cbrt_fast(torch.from_numpy(u)))


def test_ball_disk_hemisphere():
    rng = _rng(3)
    u3 = rng.random((N, 3)).astype(np.float32)
    u2 = rng.random((N, 2)).astype(np.float32)
    _close(*_both(js.ball_vec_from_uniform, ts.ball_vec_from_uniform, u3))
    _close(*_both(js.disk_vec_from_uniform, ts.disk_vec_from_uniform, u2))
    ball = ts.ball_vec_from_uniform(torch.from_numpy(u3)).numpy()
    normal = tvm.normalize(torch.from_numpy(_vec(rng))).numpy()
    normal[:8] = 0.0  # zero normals (volume hits) pass the ball through
    _close(*_both(js.hemisphere_vec, ts.hemisphere_vec, ball, normal))
    assert ts.hemisphere_inv_pdf() == js.hemisphere_inv_pdf()
    assert ts.hemisphere_pdf() == js.hemisphere_pdf()


def test_alpha_and_rtow_samples():
    rng = _rng(4)
    u2 = rng.random((N, 2)).astype(np.float32)
    normal = tvm.normalize(torch.from_numpy(_vec(rng))).numpy()
    normal[0] = (0.0, 0.0, 1.0)
    normal[1] = (0.0, 0.0, -1.0)
    for alpha in (1.0, 4.0):
        dj, pj = js.alpha_sample(jnp.asarray(u2), jnp.asarray(normal), alpha)
        dt, pt = ts.alpha_sample(torch.from_numpy(u2), torch.from_numpy(normal), alpha)
        _close(dj, dt)
        _close(pj, pt, atol=ATOL * 4)  # pdf up to 5/(2π)·cos⁴
    ball, hp = _vec(rng), _vec(rng)
    pj, qj = js.rtow_sample(jnp.asarray(ball), jnp.asarray(hp), jnp.asarray(normal))
    pt, qt = ts.rtow_sample(torch.from_numpy(ball), torch.from_numpy(hp), torch.from_numpy(normal))
    _close(pj, pt)
    assert qj == qt


def test_channel_bleed_and_tonemap():
    rng = _rng(5)
    color = np.concatenate([
        rng.uniform(0, 1, (20000, 3)), rng.uniform(0, 3, (20000, 3)),
        rng.exponential(0.2, (20000, 3)),
    ]).astype(np.float32)
    _close(*_both(jtm.channel_bleed, ttm.channel_bleed, color), atol=ATOL * 4)  # values up to 9
    for gamma in (2.0, 2.2, 1.0):
        a = np.asarray(jtm.tonemap(jnp.asarray(color), gamma)).astype(int)
        b = ttm.tonemap(torch.from_numpy(color), gamma).numpy()
        assert b.dtype == np.uint8
        diff = np.abs(a - b.astype(int))
        assert diff.max() <= 1
        assert (diff == 0).mean() >= 0.999
