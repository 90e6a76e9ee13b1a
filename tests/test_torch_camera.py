"""Camera ray generation of the torch port against the JAX package, atol
1e-6 (origins are ~7.5 in magnitude, where one float32 ulp is 4.8e-7)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs397raytracingsp22_tpu.models.camera import Camera as JCamera
from cs397raytracingsp22_tpu.models.camera import CameraProjectionMode as JMode
from cs397raytracingsp22_tpu_torch.models.camera import Camera as TCamera
from cs397raytracingsp22_tpu_torch.models.camera import CameraProjectionMode as TMode

torch.set_num_threads(1)  # several test workers share the cores

BASE = dict(
    eyepoint=(0.0, 2.5, 7.5), view_dir=(0.0, 0.0, -1.0), up=(0.0, 1.0, 0.0),
    focal_length=0.8, focus_dist=5.0, screen_width=24, screen_height=16,
    aa_sample_count=9,
)
CASES = {
    "perspective": dict(),
    "thin_lens": dict(lens_radius=0.2, focus_dist=4.0, eyepoint=(0.3, 1.0, 6.0),
                      view_dir=(0.1, -0.2, -1.0), aa_sample_count=16),
    "orthographic": dict(projection_mode="ortho", view_dir=(0.0, -0.3, -1.0)),
    "sample_offset": dict(aa_sample_count=64, offset=5, spp=7),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_rays_matches_jax(case):
    kw = dict(BASE)
    kw.update(CASES[case])
    offset = kw.pop("offset", 0)
    spp = kw.pop("spp", None)
    ortho = kw.pop("projection_mode", None) == "ortho"
    jcam = JCamera(**kw, **({"projection_mode": JMode.ORTHOGRAPHIC} if ortho else {}))
    tcam = TCamera(**kw, **({"projection_mode": TMode.ORTHOGRAPHIC} if ortho else {}))
    rng = np.random.default_rng(len(case))
    ids = rng.permutation(kw["screen_width"] * kw["screen_height"])[:96].astype(np.int32)
    for seed in (0, 1234567):
        oj, dj = jcam.generate_rays(seed, jnp.asarray(ids), spp=spp, sample_offset=offset)
        ot, dt = tcam.generate_rays(seed, torch.from_numpy(ids), spp=spp, sample_offset=offset)
        assert tuple(ot.shape) == tuple(oj.shape) and ot.dtype == torch.float32
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=1e-6)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-6)
