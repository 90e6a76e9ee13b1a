"""The wavefront executor of the torch port (ops/kernels/wavefront.py:
one step per bounce, a stable dead-last partition between bounces)
against the JAX package.

On CPU tensors the port runs its plain step (integrator.bounce_update on
intersect_scene_plain) through the same loop, partition and un-permute
that K4 runs on the card. Tolerances:
- the executor against the JAX integrator.path_trace: K1's contract
  (rtol 1e-3, atol 1e-4 on at least 99.5% of rays, segments within depth ×
  rays outside), the equality that the JAX package's own
  test_wavefront_matches_full_kernel asserts for its executor;
- compact=False against compact=True, and both against the port's plain
  path_trace: bit for bit (each ray's draws follow its uid, and every step
  is row-wise);
- the partition against the JAX bounce._stable_partition: exact;
- the plain model of K4's launch (step_model: tile ranks, tile offsets in
  the order tiles reserve them, live rows to the other buffer, dead
  radiance by caller index) against stable_partition and the JAX partition
  plus the un-permute: exact in ticket order; in any other order, the same
  rows with each tile's rows together and in their order; its executor
  against path_trace_wavefront_plain: bit for bit.
The `gpu`-marked tests hold K4 to K1 and, launch by launch, to the plain
step and partition on the card (as a set, and in order inside a tile), and
skip without one.
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
from cs397raytracingsp22_tpu_torch import ShadingMode
from cs397raytracingsp22_tpu_torch.ops.kernels import bounce, wavefront
from cs397raytracingsp22_tpu_torch.render import integrator as tint
from cs397raytracingsp22_tpu_torch.scenes import bench_scene as tbench
from cs397raytracingsp22_tpu_torch.scenes import cornell as tcornell
from cs397raytracingsp22_tpu_torch.scenes import teapot as tteapot
from cs397raytracingsp22_tpu_torch.utils import obj_loader as tobj
from cs397raytracingsp22_tpu_torch.utils import threefry as ttf
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


def _rows_and_flags(n, p_live, seed):
    """n random state rows whose caller indices are a permutation of
    0..n-1, and live flags: every ray with probability p_live (exactly one
    when p_live is None)."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((n, wavefront.ROW)).astype(np.float32)
    rows.view(np.int32)[:, wavefront.STATE_IDX] = rng.permutation(n)
    if p_live is None:
        on = np.zeros(n, dtype=bool)
        on[rng.integers(n)] = True
    else:
        on = rng.random(n) < p_live
    return rows, on


def _check_tiles_keep_order(rows, on, out, tile):
    """`out` holds the live rows of `rows` once each; the live rows of each
    tile of `rows` lie together in `out`, in their order."""
    idx = torch.from_numpy(rows.view(np.int32)[:, wavefront.STATE_IDX].copy()).long()
    out_idx = out.view(torch.int32)[:, wavefront.STATE_IDX].long()
    where = torch.full((len(on),), -1, dtype=torch.int64)
    where[out_idx] = torch.arange(out.shape[0])
    at = where[idx]  # each input row's place in out, -1 if dead
    assert torch.equal(at >= 0, torch.from_numpy(on)) and out.shape[0] == int(on.sum())
    live = torch.nonzero(torch.from_numpy(on))[:, 0]
    same_tile = live[1:] // tile == live[:-1] // tile
    assert bool((at[live[1:]] - at[live[:-1]] == 1)[same_tile].all())
    np.testing.assert_array_equal(out.numpy(), rows[on][np.argsort(at[live].numpy())])


# all live, all dead, one live ray, N not a multiple of the tile, and more
# tiles than resident blocks (40 or 157 tiles on 3 blocks, tiles reserving
# in an order drawn from a seed); both tile sizes of the kernel
@pytest.mark.parametrize("n, p_live, tile, resident, seed", [
    (1000, 1.0, 128, None, None), (1000, 0.0, 32, None, None), (1000, None, 128, None, None),
    (129, 0.5, 128, 2, 3), (5000, 0.3, 128, 3, 4), (5000, 0.3, 32, 3, 6),
    (5000, 0.97, 32, 1, 5)])
def test_compact_plain_matches_partition(n, p_live, tile, resident, seed):
    rows, on = _rows_and_flags(n, p_live, seed or 0)
    n_tiles = -(-n // tile)
    rad = torch.full((n, 3), float("nan"))
    out, m = wavefront.compact_plain(torch.from_numpy(rows), torch.from_numpy(on), rad, tile)
    assert m == int(on.sum()) and out.shape == (m, wavefront.ROW)
    part, _ = wavefront.stable_partition(torch.from_numpy(on.astype(np.int32)),
                                         torch.from_numpy(rows))
    assert torch.equal(out.view(torch.int32), part[:m].view(torch.int32))
    ref = jbounce._stable_partition(jnp.asarray(on.astype(np.int32)),
                                    [jnp.asarray(rows[:, k]) for k in range(wavefront.ROW)])
    ref = np.stack([np.asarray(r) for r in ref], 1)
    np.testing.assert_array_equal(out.numpy().view(np.int32), ref[:m].view(np.int32))
    # the dead rays' radiance at their caller index, the JAX partition's dead
    # rows un-permuted; the live rays' entries untouched
    expect = torch.full((n, 3), float("nan"))
    dead = torch.from_numpy(ref[m:])
    expect[dead.view(torch.int32)[:, wavefront.STATE_IDX].long()] = dead[:, wavefront.STATE_RAD]
    assert torch.equal(rad.isnan(), expect.isnan())
    assert torch.equal(rad.nan_to_num(), expect.nan_to_num())
    # tiles reserving in another order: the same live rows, tile by tile
    order = wavefront.reservation_order(n_tiles, resident, seed)
    rad2 = torch.full((n, 3), float("nan"))
    out2, m2 = wavefront.compact_plain(torch.from_numpy(rows), torch.from_numpy(on), rad2,
                                       tile, order)
    assert m2 == m and torch.equal(rad2.nan_to_num(), rad.nan_to_num())
    _check_tiles_keep_order(rows, on, out2, tile)


@pytest.mark.parametrize("resident", [None, 1, 2, 7])
def test_reservation_order_takes_tickets_in_order(resident):
    n_tiles = 57
    assert wavefront.reservation_order(n_tiles, resident) == list(range(n_tiles))
    for seed in range(4):
        order = wavefront.reservation_order(n_tiles, resident, seed)
        assert sorted(order) == list(range(n_tiles))
        if resident is not None:  # tile t runs once t - resident + 1 tiles have reserved
            assert all(order.index(t) >= t - resident + 1 for t in range(n_tiles))


# the three scenes above and the open teapot scene, where most rays die
MODEL_SCENES = {
    **{name: (lambda name=name: SCENES[name]()[1], DEPTH) for name in SCENES},
    "open_teapot": (lambda: tteapot.build(16, 16, spp=4, shading=ShadingMode.PATH_TRACE), 6),
}


@pytest.mark.parametrize("name", sorted(MODEL_SCENES))
def test_kernel_model_is_bit_identical_to_plain(name):
    build, depth = MODEL_SCENES[name]
    scene = build()
    tsd = scene.compile(device="cpu")
    o, d = scene.camera.generate_rays(21, torch.arange(N // 4, dtype=torch.int32), spp=4)
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    uids = torch.arange(N, dtype=torch.int32)
    max_dist = scene.camera.max_trace_dist
    st = {}
    ref, ref_segs = wavefront.path_trace_wavefront_plain(tsd, o, d, uids, 21, depth, max_dist,
                                                         stats=st)
    for compact, resident, seed in ((True, None, None), (True, 2, 8), (False, None, None)):
        st_m = {}
        rad, segs = wavefront.path_trace_wavefront_model(
            tsd, o, d, uids, 21, depth, max_dist, compact=compact, stats=st_m, resident=resident,
            seed=seed)
        assert torch.equal(rad, ref) and int(segs) == int(ref_segs)
        assert torch.equal(st_m["live"], st["live"])
        tile = wavefront.tile_rays(tsd)
        tiles = [-(-m // tile) if compact else -(-N // tile) for m in st["live"].tolist()]
        assert st_m["tiles"].tolist() == tiles


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


def _launch_matches_plain(cuda, scene, data, ins, depth, last, src, dst, rad, ws, key):
    """One K4 launch against the plain step and stable_partition on the same
    input rows `ins` (the rows K4 read): every kept ray once, the kept rays
    of each input tile together and in their order (so a wrong offset or
    rank shows), the same live set as the plain step but for winner flips
    (K1's contract: <= 0.5% of the rays; with none, the rows are the
    partition's, tile by tile), the rows' floats within rtol 1e-3 / atol
    1e-4 on >= 99.5% of the rays both keep, the dead rays' radiance, the
    device live count and the tiles walked. Returns K4's output rows (its
    next input)."""
    max_dist = scene.camera.max_trace_dist
    camera = None if depth else (ins[:, wavefront.STATE_O].contiguous(),
                                 ins[:, wavefront.STATE_D].contiguous(),
                                 ins.view(torch.int32)[:, wavefront.STATE_UID].contiguous())
    wavefront.step_cuda(data, src, dst, rad, ws, ttf.key_pair(key), depth, last, tint.PATH_T_MIN,
                        max_dist, camera=camera)
    torch.cuda.synchronize()
    n_in, n = ins.shape[0], rad.shape[0]
    tile = wavefront.tile_rays(data)
    assert int(ws.tiles[depth]) == -(-n_in // tile)
    new, on = wavefront.step_plain(data, ins, torch.ones((n_in,), dtype=torch.int32, device=cuda),
                                   key, depth, max_dist)
    on = (on != 0) & (not last)
    in_idx = ins.view(torch.int32)[:, wavefront.STATE_IDX].long()
    m = 0 if last else int(ws.live[depth + 1])
    out = dst[:m] if m else ins[:0]
    where = torch.full((n,), -1, dtype=torch.int64, device=cuda)
    where[out.view(torch.int32)[:, wavefront.STATE_IDX].long()] = torch.arange(m, device=cuda)
    at = where[in_idx]  # each input row's place in K4's rows, -1 if K4 ended it
    kept = at >= 0
    assert int(kept.sum()) == m, "a kept ray is missing or written twice"
    live = torch.nonzero(kept)[:, 0]
    same_tile = live[1:] // tile == live[:-1] // tile
    assert bool((at[live[1:]] - at[live[:-1]] == 1)[same_tile].all()), \
        "a tile's kept rays are not together in their order"
    flips = int((kept != on).sum())
    assert flips <= 0.005 * n_in, f"{flips} of {n_in} rays live in K4 and die in the plain step"
    if not last:
        if flips == 0:  # the partition's rows, tile by tile
            part, _ = wavefront.stable_partition(on.to(torch.int32), new)
            assert torch.equal(torch.sort(out.view(torch.int32)[:, wavefront.STATE_IDX])[0],
                               torch.sort(part[:m].view(torch.int32)[:, wavefront.STATE_IDX])[0])
        both = kept & on
        k4, ref = out[at[both]], new[both]
        assert torch.equal(k4.view(torch.int32)[:, wavefront.STATE_UID],
                           ref.view(torch.int32)[:, wavefront.STATE_UID])
        a, b = k4[:, :12].double(), ref[:, :12].double()
        close = ((a - b).abs() <= 1e-4 + 1e-3 * b.abs()).all(dim=1)
        assert close.numel() == 0 or close.float().mean() >= 0.995
    dead = ~kept & ~on
    a, b = rad[in_idx[dead]].double(), new[dead][:, wavefront.STATE_RAD].double()
    close = ((a - b).abs() <= 1e-4 + 1e-3 * b.abs()).all(dim=1)
    assert close.numel() == 0 or close.float().mean() >= 0.995
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 127, 129, 2**20 + 3])
def test_k4_launch_matches_plain_partition_on_card(cuda, n):
    """Launch by launch on the same input rows; 2**20 + 3 rays make 32,769
    warp tiles, more than the card's resident warps, so warps take several
    tiles from the ticket and tiles reserve their places out of order."""
    scene = tbench.build(16, 16, spp=4, path_depth=DEPTH)
    data = scene.compile(device=cuda)
    o, d = scene.camera.generate_rays(9, torch.arange(-(-n // 4), dtype=torch.int32,
                                                      device=cuda) % 256, spp=4)
    o, d = o.reshape(-1, 3)[:n].contiguous(), d.reshape(-1, 3)[:n].contiguous()
    uids = torch.arange(n, dtype=torch.int32, device=cuda)
    ws = wavefront.Workspace(n, DEPTH, cuda)
    rad = torch.full((n, 3), float("nan"), device=cuda)
    bufs = [torch.empty((n, wavefront.ROW), device=cuda) for _ in range(2)]
    ins, _ = wavefront.pack_state(o, d, uids)
    for depth in range(DEPTH):
        last = depth == DEPTH - 1
        src = bufs[(depth - 1) % 2] if depth else None
        dst = None if last else bufs[depth % 2]
        before = wavefront.LAUNCHES
        ins = _launch_matches_plain(cuda, scene, data, ins, depth, last, src, dst, rad, ws, 9)
        assert wavefront.LAUNCHES == before + 1
    assert not bool(rad.isnan().any()), "every ray writes its radiance once"
    rad_k4, segs = wavefront.path_trace_wavefront(data, o, d, uids, 9, DEPTH,
                                                  scene.camera.max_trace_dist)
    k1_rad, k1_segs = bounce.path_trace_cuda(data, o, d, uids, 9, DEPTH,
                                             scene.camera.max_trace_dist)
    assert_paths_match(rad_k4.cpu().numpy(), segs.cpu(), k1_rad.cpu().numpy(), k1_segs.cpu())


@pytest.mark.gpu
def test_k4_without_dense_mesh_on_card(cuda):
    """The Cornell box has no dense mesh: K4 launches its instantiations
    without the walk, as K1 does."""
    scene = tcornell.build(32, 32, spp=4)
    data = scene.compile(device=cuda)
    assert not data.dense_mesh_ids
    for last in (False, True):
        assert wavefront.kernel_attrs(dense=False, last=last)[1] == 0
    o, d = scene.camera.generate_rays(4, torch.arange(1024, dtype=torch.int32, device=cuda),
                                      spp=4)
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    uids = torch.arange(4096, dtype=torch.int32, device=cuda)
    depth, max_dist = scene.camera.path_depth, scene.camera.max_trace_dist
    st = {}
    rad, segs = wavefront.path_trace_wavefront(data, o, d, uids, 4, depth, max_dist, stats=st)
    k1_rad, k1_segs = bounce.path_trace_cuda(data, o, d, uids, 4, depth, max_dist)
    assert_paths_match(rad.cpu().numpy(), segs.cpu(), k1_rad.cpu().numpy(), k1_segs.cpu(),
                       depth=depth)
    ref, ref_segs = tint.path_trace(data, o, d, uids, 4, depth, max_dist)
    assert_paths_match(rad.cpu().numpy(), segs.cpu(), ref.cpu().numpy(), ref_segs.cpu(),
                       depth=depth)
    assert st["tiles"].tolist() == [-(-m // 128) for m in st["live"].tolist()]


@pytest.mark.gpu
def test_k4_open_teapot_on_card(cuda):
    """The open teapot scene (black image): K4's segments and live counts
    entering each bounce against K1's per-ray segment counts, within the
    rays that flip winners."""
    scene = tteapot.build(64, 64, spp=4, shading=ShadingMode.PATH_TRACE)
    data = scene.compile(device=cuda)
    o, d = scene.camera.generate_rays(6, torch.arange(4096, dtype=torch.int32, device=cuda),
                                      spp=4)
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    n = o.shape[0]
    uids = torch.arange(n, dtype=torch.int32, device=cuda)
    depth, max_dist = scene.camera.path_depth, scene.camera.max_trace_dist
    st, k1_st = {}, {}
    _, segs = wavefront.path_trace_wavefront(data, o, d, uids, 6, depth, max_dist, stats=st)
    _, k1_segs = bounce.path_trace_cuda(data, o, d, uids, 6, depth, max_dist, stats=k1_st)
    k1_live = [int((k1_st["segs"] > b).sum()) for b in range(depth)]
    live = st["live"].tolist()
    slack = max(1, n // 200)
    assert abs(int(segs) - int(k1_segs)) <= depth * slack
    assert all(abs(a - b) <= slack for a, b in zip(live, k1_live)), (live, k1_live)
    assert live[2] < 0.1 * n, "most rays escape by bounce 2"
    assert st["tiles"].tolist() == [-(-m // 32) for m in live]
