"""bsdf.scatter of the torch port against the JAX package, one case per
material type (rtol 1e-5, atol 1e-6: the same float32 formulas; the
residue is the order of three-term sums)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs397raytracingsp22_tpu.ops import bsdf as jbsdf
from cs397raytracingsp22_tpu.ops.intersect import HitRecord as JHit
from cs397raytracingsp22_tpu_torch.models import materials as mat
from cs397raytracingsp22_tpu_torch.ops import bsdf as tbsdf
from cs397raytracingsp22_tpu_torch.ops.intersect import HitRecord as THit

torch.set_num_threads(1)  # several test workers share the cores

N = 4096
TYPES = {
    "lambertian": mat.LAMBERTIAN,
    "metal": mat.METAL,
    "dielectric": mat.DIELECTRIC,
    "parameterized": mat.PARAMETERIZED,
    "isotropic": mat.ISOTROPIC,
}


def _unit(rng, n):
    v = rng.standard_normal((n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _inputs(mtype, seed):
    rng = np.random.default_rng(seed)
    normal = _unit(rng, N)
    d_in = _unit(rng, N) * rng.uniform(0.5, 2.0, (N, 1)).astype(np.float32)
    if mtype == mat.ISOTROPIC:
        normal[:] = 0.0  # volume hits carry a zero normal
    fields = dict(
        valid=np.ones(N, bool),
        t=rng.uniform(0.1, 5, N).astype(np.float32),
        point=rng.standard_normal((N, 3)).astype(np.float32),
        normal=normal,
        frontface=rng.random(N) < 0.5,
        mtype=np.full(N, mtype, np.int32),
        albedo=rng.random((N, 3)).astype(np.float32),
        emission=rng.random((N, 3)).astype(np.float32),
        roughness=rng.random(N).astype(np.float32),
        metallic=rng.random(N).astype(np.float32),
        ior=rng.uniform(1.0, 2.4, N).astype(np.float32),
    )
    u = rng.random((N, 3)).astype(np.float32)
    from cs397raytracingsp22_tpu_torch.utils import sampling

    ball = sampling.ball_vec_from_uniform(torch.from_numpy(u)).numpy()
    u_choice = rng.random(N).astype(np.float32)
    return fields, d_in, ball, u_choice


@pytest.mark.parametrize("name", sorted(TYPES))
def test_scatter_matches_jax(name):
    fields, d_in, ball, u_choice = _inputs(TYPES[name], seed=len(name))
    hj = JHit(**{k: jnp.asarray(v) for k, v in fields.items()})
    ht = THit(**{k: torch.from_numpy(v) for k, v in fields.items()})
    outj = jbsdf.scatter(hj, jnp.asarray(d_in), jnp.asarray(ball), jnp.asarray(u_choice))
    outt = tbsdf.scatter(ht, torch.from_numpy(d_in), torch.from_numpy(ball),
                         torch.from_numpy(u_choice))
    for a, b, what in zip(outj, outt, ("direction", "attenuation", "inv_pdf")):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6, err_msg=what)
