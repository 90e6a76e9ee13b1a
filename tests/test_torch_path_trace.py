"""The plain version of K1 (the port's integrator.path_trace) against the
JAX package's integrator.path_trace: 512 rays, depth 4, three scenes.

Tolerance is the JAX package's own kernel-vs-spec contract
(tests/test_bounce_kernel.py): rtol 1e-3, atol 1e-4, here on at least
99.5% of rays — a winner flip at a triangle edge re-rolls that ray's
whole path, so exactness per ray cannot be required. Segment totals
differ by at most depth × (number of rays outside the tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cs397raytracingsp22_tpu as J
import cs397raytracingsp22_tpu_torch as T
from cs397raytracingsp22_tpu.render import integrator as jint
from cs397raytracingsp22_tpu.utils import obj_loader as jobj
from cs397raytracingsp22_tpu.utils import threefry as jtf
from cs397raytracingsp22_tpu_torch.render import integrator as tint
from cs397raytracingsp22_tpu_torch.scenes import bench_scene as tbench
from cs397raytracingsp22_tpu_torch.scenes import cornell as tcornell
from cs397raytracingsp22_tpu_torch.utils import obj_loader as tobj
from scenes import cornell as jcornell
from tests.test_torch_bounce_kernel import assert_paths_match, bench_like, volume_parameterized
from tests.test_torch_scene import jax_bench_scene

torch.set_num_threads(1)  # several test workers share the cores

DEPTH = 4
N = 512


SCENES = {
    "bench_like": lambda: (bench_like(J, jcornell, jobj), bench_like(T, tcornell, tobj)),
    "volume_parameterized": lambda: (volume_parameterized(J), volume_parameterized(T)),
    "bench_teapot_6k": lambda: (jax_bench_scene(16, 16, spp=4, path_depth=DEPTH),
                                tbench.build(16, 16, spp=4, path_depth=DEPTH)),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_path_trace_matches_jax(name):
    jscene, tscene = SCENES[name]()
    jsd, tsd = jscene.compile(), tscene.compile(device="cpu")
    key = 123
    o, d = jscene.camera.generate_rays(key, jnp.arange(N // 4, dtype=jnp.int32), spp=4)
    o = np.array(o).reshape(-1, 3)
    d = np.array(d).reshape(-1, 3)
    uids = np.arange(N, dtype=np.int32)
    max_dist = jscene.camera.max_trace_dist
    ref_rad, ref_segs = jax.jit(jint.path_trace, static_argnums=(5, 6))(
        jsd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(uids), jtf.key_words(key), DEPTH, max_dist
    )
    rad, segs = tint.path_trace(
        tsd, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(uids), key, DEPTH, max_dist
    )
    assert rad.dtype == torch.float32 and segs.dtype == torch.int64
    assert float(np.asarray(ref_rad).max()) > 0.0, "the scene must carry light"
    assert_paths_match(rad.numpy(), segs, ref_rad, ref_segs)
