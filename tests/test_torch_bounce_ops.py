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


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def bounce_inputs():
    """The Cornell box with its spheres (a NEE-able scene): 256 camera rays,
    a fifth of them dead and a third flagged by a previous NEE sample, and
    the hit record of the bounce's own window."""
    scene = cornell.build_config3(16, 16, spp=1, path_depth=4)
    sd = scene.compile(device="cpu")
    o, d, uids = driver._gen_chunk_rays(scene.camera, torch.arange(256, dtype=torch.int32), KEY,
                                        0, 1, 1)
    n = o.shape[0]
    alive = torch.arange(n) % 5 != 0
    prev_nee = torch.arange(n) % 3 == 0
    t_max = torch.where(alive, MAX_DIST, 0.0)
    u_vol = integrator._bounce_draws(sd, KEY, uids, rnglib.SITE_BOUNCE0 + DEPTH)[2]
    hit = intersect_scene_plain(sd, o, d, integrator.PATH_T_MIN, t_max, u_vol)
    state = (o, d, torch.ones((n, 3)), torch.zeros((n, 3)), alive, uids)
    return sd, state, prev_nee, hit


@pytest.mark.parametrize("mode", sorted(MAX_OPS))
def test_bounce_update_op_count(bounce_inputs, mode):
    sd, state, prev_nee, hit = bounce_inputs
    kw = {} if mode == "nee_off" else dict(prev_nee=prev_nee, do_nee=mode == "nee")

    def stub(scene, o, d, t_min, t_max, u_vol):
        return hit

    with _CountOps() as count:
        out = integrator.bounce_update(sd, *state, KEY, DEPTH, MAX_DIST, intersect=stub, **kw)
    assert count.n <= MAX_OPS[mode], f"{count.n} ops, at most {MAX_OPS[mode]}"
    assert (out[5] is not None) == (mode == "nee"), "the flags are returned only after a sample"
