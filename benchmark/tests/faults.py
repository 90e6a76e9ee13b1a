"""Faults planted under the timed path, for the tests that see `correct`
come out false. `install(name)` patches the renderer in this process;
with BENCHMARK_TEST_FAULT set, the sitecustomize.py that
`sitecustomize_dir` writes installs it in every process of a run (the
ranks too)."""

import os

FAULTS = ("state_unchanged", "half_batch", "answer_altered", "exchange_left_out")


def install(name: str) -> None:
    import torch

    from cs397raytracingsp22_tpu_torch.parallel import sharding
    from cs397raytracingsp22_tpu_torch.render import driver

    orig = driver.render_chunk

    def state_unchanged(*a, **k):  # the chunk adds nothing to the accumulator
        rad, segs = orig(*a, **k)
        return torch.zeros_like(rad), segs

    def half_batch(scene, camera, pixel_ids, rng_key, sample_offset, spp, n_chains=1):
        keep = max(1, spp // 2)  # half the samples traced, the mean over them
        rad, segs = orig(scene, camera, pixel_ids, rng_key, sample_offset, keep, n_chains)
        return rad * (spp / keep), segs

    def answer_altered(scene, camera, pixel_ids, rng_key, sample_offset, spp, n_chains=1):
        # every 7th pixel's answer off by 0.1 a sample (a black pixel turns grey)
        rad, segs = orig(scene, camera, pixel_ids, rng_key, sample_offset, spp, n_chains)
        rad = rad.clone()
        rad[::7] += 0.1 * spp
        return rad, segs

    if name == "exchange_left_out":
        sharding.sum_over_ranks = lambda buf: buf
    else:
        driver.render_chunk = {"state_unchanged": state_unchanged, "half_batch": half_batch,
                               "answer_altered": answer_altered}[name]


def sitecustomize_dir(path: str) -> str:
    """A directory for PYTHONPATH whose sitecustomize.py installs the fault
    named by BENCHMARK_TEST_FAULT. It holds a copy of this file: importing
    the benchmark package there, before the interpreter has put the
    working directory on sys.path, would load another copy of it."""
    import shutil

    os.makedirs(path, exist_ok=True)
    shutil.copy(__file__, os.path.join(path, "bench_faults.py"))
    with open(os.path.join(path, "sitecustomize.py"), "w") as f:
        f.write("import os\n"
                "if os.environ.get('BENCHMARK_TEST_FAULT'):\n"
                "    import bench_faults\n"
                "    bench_faults.install(os.environ['BENCHMARK_TEST_FAULT'])\n")
    return path
