"""The torch port, its multi-device modules (parallel/), config 5
(scenes/drone_demo.py), its tools and utils/profiling.py among them,
imports without JAX, Triton or a CUDA device, and joins no process group."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import json, sys
import cs397raytracingsp22_tpu_torch as pkg
from cs397raytracingsp22_tpu_torch import cli
from cs397raytracingsp22_tpu_torch.ops import intersect
from cs397raytracingsp22_tpu_torch.ops.kernels import _build, bounce, scene_intersect, tri_scan_big
from cs397raytracingsp22_tpu_torch.ops.kernels import tri_scan, wavefront
from cs397raytracingsp22_tpu_torch.ops.kernels import bw_scan, dtype_rate, vpu_peak
from cs397raytracingsp22_tpu_torch.parallel import multihost, sharding
from cs397raytracingsp22_tpu_torch.render import driver, integrator, nee
from cs397raytracingsp22_tpu_torch.scenes import bench_scene, bench_teapot_32k, cornell, teapot
from cs397raytracingsp22_tpu_torch.scenes import drone_demo, kitchen_sink, textured_spheres
from cs397raytracingsp22_tpu_torch.tools import bench_mxu_scan, compare_k1, compare_k4, profile_split
from cs397raytracingsp22_tpu_torch.tools import vpu_peak as vpu_peak_tool
from cs397raytracingsp22_tpu_torch.tools import vpu_peak_shape, vpu_peak_smem, walk_counts
from cs397raytracingsp22_tpu_torch.tools import bench_config4_e2e, bench_teapot_6k
from cs397raytracingsp22_tpu_torch.tools import compare_reference_render, make_artifacts
from cs397raytracingsp22_tpu_torch.tools import preview_checkpoint
from cs397raytracingsp22_tpu_torch.utils import profiling, subdivide
import torch
print(json.dumps({
    "jax": any(m == "jax" or m.startswith("jax.") for m in sys.modules),
    "jax_package": any(m.startswith("cs397raytracingsp22_tpu.") or m == "cs397raytracingsp22_tpu"
                       for m in sys.modules),
    "triton": "triton" in sys.modules,
    "cuda_initialized": torch.cuda.is_initialized(),
    "process_group": torch.distributed.is_initialized(),
    "launches": [bounce.LAUNCHES, scene_intersect.LAUNCHES, tri_scan_big.LAUNCHES,
                 wavefront.LAUNCHES, tri_scan.LAUNCHES, vpu_peak.LAUNCHES, dtype_rate.LAUNCHES,
                 bw_scan.LAUNCHES, bw_scan.MMA_LAUNCHES],
    "kernels": list(_build.KERNELS),
    "api": sorted(pkg.__all__),
}))
"""


def test_import_needs_no_jax_triton_or_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    info = json.loads(out.stdout.strip().splitlines()[-1])
    assert info["jax"] is False
    assert info["jax_package"] is False
    assert info["triton"] is False
    assert info["cuda_initialized"] is False
    assert info["process_group"] is False
    assert info["launches"] == [0] * 9
    assert sorted(info["kernels"]) == sorted(
        f[:-3] for f in os.listdir(os.path.join(ROOT, "cs397raytracingsp22_tpu_torch", "csrc"))
        if f.endswith(".cu"))
    assert info["api"] == sorted([
        "Camera", "CameraProjectionMode", "ShadingMode", "Scene", "Sphere", "Triangle",
        "Plane", "ConvexVolume", "StaticMesh", "Lambertian", "Metal", "Dielectric",
        "ParameterizedMaterial", "Isotropic",
    ])
