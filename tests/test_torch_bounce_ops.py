"""The ops one bounce of the estimator launches (integrator.bounce_update),
counted on the CPU.

On the card every aten op of the staged and NEE executors is a launch the
host pays for, so the count of one bounce body is the CPU's view of the
cells' launches per bounce. The intersection is a stub returning a hit
record computed once outside the count: what is counted is the
estimator's glue (the draws, the windows, the miss and emission terms, the
BSDF, NEE's sample and the path's update), not the plain intersection.
Each mode's count may not rise above the bound written here; NEE off
launches nothing of NEE's.

On the card (marked `gpu`) the shading after the intersection is one launch
of S1 (ops/kernels/shade.py), NEE's sample two of N1 (ops/kernels/nee.py)
and the draws one of D1, so the same body is
counted there by its kernel launches, as the benchmark's
launches_per_bounce counts them: the host's cudaLaunch* / cuLaunch* calls
under torch.profiler. Run them there:

    python -m pytest tests/test_torch_bounce_ops.py -q -m gpu
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cs397raytracingsp22_tpu_torch.ops.intersect import intersect_scene_plain
from cs397raytracingsp22_tpu_torch.render import driver, integrator
from cs397raytracingsp22_tpu_torch.scenes import cornell
from cs397raytracingsp22_tpu_torch.utils import rng as rnglib

torch.set_num_threads(1)  # several test workers share the cores

KEY, DEPTH, MAX_DIST = 3, 1, 100.0

# The bounds: the ops of the two bodies this one replaced (one without
# NEE; NEE's with and without its sample), counted on the CPU on these
# inputs before they were merged.
MAX_OPS = {"nee_off": 687, "nee": 1451, "nee_last": 690}
# The bounds on the card: the launches of one body as measured on an H100
# 80GB HBM3 with S1 and N1: 7 without a NEE sample (the draws, the window,
# the segment count, S1); 14 with one (NEE's draws, N1's two launches, the
# shadow-ray count and their share of the glue added; 175 before N1).
MAX_LAUNCHES = {"nee_off": 7, "nee": 14, "nee_last": 7}


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _inputs(device):
    scene = cornell.build_config3(16, 16, spp=1, path_depth=4)
    sd = scene.compile(device=device)
    ids = torch.arange(256, dtype=torch.int32, device=device)
    o, d, uids = driver._gen_chunk_rays(scene.camera, ids, KEY, 0, 1, 1)
    n = o.shape[0]
    alive = torch.arange(n, device=device) % 5 != 0
    prev_nee = torch.arange(n, device=device) % 3 == 0
    t_max = torch.where(alive, MAX_DIST, 0.0)
    u_vol = integrator._bounce_draws(sd, KEY, uids, rnglib.SITE_BOUNCE0 + DEPTH)[2]
    hit = intersect_scene_plain(sd, o, d, integrator.PATH_T_MIN, t_max, u_vol)
    ones = torch.ones((n, 3), device=device)
    state = (o, d, ones, torch.zeros((n, 3), device=device), alive, uids)
    return sd, state, prev_nee, hit


def _body(inputs, mode):
    """One bounce body on the inputs, with the stub intersection."""
    sd, state, prev_nee, hit = inputs
    kw = {} if mode == "nee_off" else dict(prev_nee=prev_nee, do_nee=mode == "nee")

    def stub(scene, o, d, t_min, t_max, u_vol):
        return hit

    return integrator.bounce_update(sd, *state, KEY, DEPTH, MAX_DIST, intersect=stub, **kw)


@pytest.fixture(scope="module")
def bounce_inputs():
    """The Cornell box with its spheres (a NEE-able scene): 256 camera rays,
    a fifth of them dead and a third flagged by a previous NEE sample, and
    the hit record of the bounce's own window."""
    return _inputs("cpu")


@pytest.mark.parametrize("mode", sorted(MAX_OPS))
def test_bounce_update_op_count(bounce_inputs, mode):
    with _CountOps() as count:
        out = _body(bounce_inputs, mode)
    assert count.n <= MAX_OPS[mode], f"{count.n} ops, at most {MAX_OPS[mode]}"
    assert (out[5] is not None) == (mode == "nee"), "the flags are returned only after a sample"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(MAX_LAUNCHES))
def test_bounce_update_launches_on_card(cuda, mode):
    """One body's kernel launches on the card (after a warm body, which
    builds and loads the kernels), at most the bound; S1 once."""
    from torch.profiler import ProfilerActivity, profile

    from cs397raytracingsp22_tpu_torch.ops.kernels import shade

    inputs = _inputs(cuda)
    _body(inputs, mode)
    torch.cuda.synchronize()
    before = shade.LAUNCHES["shade"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = _body(inputs, mode)
        torch.cuda.synchronize()
    assert shade.LAUNCHES["shade"] == before + 1
    names = [e.name for e in prof.events()]
    launches = sum(name.startswith(("cudaLaunch", "cuLaunch")) for name in names)
    print(f"{mode}: {launches} launches")
    assert 0 < launches <= MAX_LAUNCHES[mode], f"{launches} launches, at most {MAX_LAUNCHES[mode]}"
    assert (out[5] is not None) == (mode == "nee")
