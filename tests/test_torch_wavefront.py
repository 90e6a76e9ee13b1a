"""The wavefront executor of the torch port (ops/kernels/wavefront.py:
one step per bounce, a stable dead-last partition between bounces)
against the JAX package.

On CPU tensors the port runs its plain step (integrator._bounce_update on
intersect_scene_plain) through the same loop, partition and un-permute
that K4 runs on the card. Tolerances:
- the executor against the JAX integrator.path_trace: K1's contract
  (rtol 1e-3, atol 1e-4 on at least 99.5% of rays, segments within depth ×
  rays outside), the equality that the JAX package's own
  test_wavefront_matches_full_kernel asserts for its executor;
- compact=False against compact=True, and both against the port's plain
  path_trace: bit for bit (each ray's draws follow its uid, and every step
  is row-wise);
- the partition against the JAX bounce._stable_partition: exact.
The `gpu`-marked test holds K4 to K1 on the card and skips without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cs397raytracingsp22_tpu as J
import cs397raytracingsp22_tpu_torch as T
from cs397raytracingsp22_tpu.ops.pallas import bounce as jbounce
from cs397raytracingsp22_tpu.render import integrator as jint
from cs397raytracingsp22_tpu.utils import obj_loader as jobj
from cs397raytracingsp22_tpu.utils import threefry as jtf
from cs397raytracingsp22_tpu_torch.ops.kernels import bounce, wavefront
from cs397raytracingsp22_tpu_torch.render import integrator as tint
from cs397raytracingsp22_tpu_torch.scenes import bench_scene as tbench
from cs397raytracingsp22_tpu_torch.scenes import cornell as tcornell
from cs397raytracingsp22_tpu_torch.utils import obj_loader as tobj
from scenes import cornell as jcornell
# sibling test modules by their bare names (pytest puts tests/ on sys.path)
from test_torch_bounce_kernel import PORT_SCENES, assert_paths_match, bench_like
from test_torch_bounce_kernel import volume_parameterized
from test_torch_scene import jax_bench_scene

torch.set_num_threads(1)  # several test workers share the cores

DEPTH = 4
N = 512

# the scenes of tests/test_torch_path_trace.py: (JAX scene, port scene)
SCENES = {
    "bench_like": lambda: (bench_like(J, jcornell, jobj), bench_like(T, tcornell, tobj)),
    "volume_parameterized": lambda: (volume_parameterized(J), volume_parameterized(T)),
    "bench_teapot_6k": lambda: (jax_bench_scene(16, 16, spp=4, path_depth=DEPTH),
                                tbench.build(16, 16, spp=4, path_depth=DEPTH)),
}


def camera_rays(jscene, key):
    """N camera rays of the JAX scene (spp 4) as numpy, and their uids."""
    o, d = jscene.camera.generate_rays(key, jnp.arange(N // 4, dtype=jnp.int32), spp=4)
    return (np.array(o).reshape(-1, 3), np.array(d).reshape(-1, 3),
            np.arange(N, dtype=np.int32))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_wavefront_matches_jax_path_trace(name):
    jscene, tscene = SCENES[name]()
    jsd, tsd = jscene.compile(), tscene.compile(device="cpu")
    key = 77
    o, d, uids = camera_rays(jscene, key)
    max_dist = jscene.camera.max_trace_dist
    ref_rad, ref_segs = jax.jit(jint.path_trace, static_argnums=(5, 6))(
        jsd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(uids), jtf.key_words(key), DEPTH, max_dist
    )
    stats = {}
    rad, segs = wavefront.path_trace_wavefront(
        tsd, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(uids), key, DEPTH,
        max_dist, stats=stats)
    assert rad.dtype == torch.float32 and segs.dtype == torch.int64
    assert float(np.asarray(ref_rad).max()) > 0.0, "the scene must carry light"
    assert_paths_match(rad.numpy(), segs, ref_rad, ref_segs)
    live = stats["live"].tolist()
    assert len(live) == DEPTH and live[0] == N and sum(live) == int(segs)
    assert all(a >= b for a, b in zip(live, live[1:])), "live counts only fall"


@pytest.mark.parametrize("name", sorted(SCENES))
def test_no_compaction_is_bit_identical(name):
    jscene, tscene = SCENES[name]()
    tsd = tscene.compile(device="cpu")
    o, d, uids = (torch.from_numpy(x) for x in camera_rays(jscene, 5))
    max_dist = jscene.camera.max_trace_dist
    rad, segs = wavefront.path_trace_wavefront(tsd, o, d, uids, 5, DEPTH, max_dist)
    rad_nc, segs_nc = wavefront.path_trace_wavefront(tsd, o, d, uids, 5, DEPTH, max_dist,
                                                     compact=False)
    assert torch.equal(rad, rad_nc) and int(segs) == int(segs_nc)
    # and the plain path_trace, the same steps on the rays in place
    ref, ref_segs = tint.path_trace(tsd, o, d, uids, 5, DEPTH, max_dist)
    assert torch.equal(rad, ref) and int(ref_segs) == int(segs)
    assert float(rad.max()) > 0.0, "the scene must carry light"


@pytest.mark.parametrize("n, p_live, seed", [(1, 1.0, 0), (7, 0.0, 1), (1000, 0.5, 2),
                                             (4096, 0.97, 3), (4096, 0.03, 4)])
def test_partition_matches_jax(n, p_live, seed):
    rng = np.random.default_rng(seed)
    alive = (rng.random(n) < p_live).astype(np.int32)
    rows = rng.standard_normal((n, wavefront.ROW)).astype(np.float32)
    rows_t, alive_t = wavefront.stable_partition(torch.from_numpy(alive), torch.from_numpy(rows))
    ref = jbounce._stable_partition(jnp.asarray(alive),
                                    [jnp.asarray(rows[:, k]) for k in range(wavefront.ROW)]
                                    + [jnp.asarray(alive)])
    np.testing.assert_array_equal(rows_t.numpy(), np.stack([np.asarray(r) for r in ref[:-1]], 1))
    np.testing.assert_array_equal(alive_t.numpy(), np.asarray(ref[-1]))


def test_state_round_trip_restores_caller_order():
    rng = np.random.default_rng(9)
    n = 300
    o = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    uids = torch.from_numpy(rng.integers(0, 2**31 - 1, n).astype(np.int32))
    rows, alive = wavefront.pack_state(o, d, uids)
    ints = rows.view(torch.int32)
    assert torch.equal(ints[:, wavefront.STATE_UID], uids) and bool((alive == 1).all())
    rows[:, wavefront.STATE_RAD] = o  # a radiance that names its ray
    for seed in range(3):
        mask = torch.from_numpy((np.random.default_rng(seed).random(n) < 0.6).astype(np.int32))
        rows, alive = wavefront.stable_partition(mask, rows)
    assert torch.equal(wavefront.radiance_in_caller_order(rows), o)


def test_zero_depth_traces_nothing():
    _, tscene = SCENES["bench_like"]()
    tsd = tscene.compile(device="cpu")
    o = torch.zeros((8, 3))
    d = torch.ones((8, 3))
    rad, segs = wavefront.path_trace_wavefront(tsd, o, d, torch.arange(8, dtype=torch.int32),
                                               0, 0, 100.0)
    assert int(segs) == 0 and torch.equal(rad, torch.zeros((8, 3)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(PORT_SCENES))
def test_k4_matches_k1_on_card(cuda, name):
    scene = PORT_SCENES[name]()
    data = scene.compile(device=cuda)
    o, d = scene.camera.generate_rays(123, torch.arange(N // 4, dtype=torch.int32, device=cuda),
                                      spp=4)
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    uids = torch.arange(N, dtype=torch.int32, device=cuda)
    max_dist = scene.camera.max_trace_dist
    before = wavefront.LAUNCHES
    rad, segs = wavefront.path_trace_wavefront(data, o, d, uids, 123, DEPTH, max_dist)
    torch.cuda.synchronize()
    assert wavefront.LAUNCHES == before + DEPTH
    k1_rad, k1_segs = bounce.path_trace_cuda(data, o, d, uids, 123, DEPTH, max_dist)
    assert_paths_match(rad.cpu().numpy(), segs.cpu(), k1_rad.cpu().numpy(), k1_segs.cpu())
    rad_nc, segs_nc = wavefront.path_trace_wavefront(data, o, d, uids, 123, DEPTH, max_dist,
                                                     compact=False)
    assert torch.equal(rad_nc, rad) and int(segs_nc) == int(segs)
    ref, ref_segs = tint.path_trace(data, o, d, uids, 123, DEPTH, max_dist)
    assert_paths_match(rad.cpu().numpy(), segs.cpu(), ref.cpu().numpy(), ref_segs.cpu())
