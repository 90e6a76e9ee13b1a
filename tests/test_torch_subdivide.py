"""The port's mesh subdivision (utils/subdivide.py) writes the same OBJ
text, byte for byte, as tools/subdivide_teapot.py (run as a subprocess)
from assets/teapot_6k.obj: at target 9,000 (the CPU tests' big mesh) and
at target 32,768 (the 32,832-triangle mesh of scenes/bench_teapot_32k.py)."""

import os
import subprocess
import sys

import pytest

from cs397raytracingsp22_tpu_torch.scenes import bench_scene
from cs397raytracingsp22_tpu_torch.scenes import bench_teapot_32k
from cs397raytracingsp22_tpu_torch.utils import obj_loader, subdivide

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("target, n_tris", [(9000, 9000), (bench_teapot_32k.TARGET, 32832)])
def test_subdivide_writes_the_tools_obj_text(tmp_path, target, n_tris):
    ref, out = tmp_path / "tools.obj", tmp_path / "port.obj"
    src = bench_scene.TEAPOT_6K
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "subdivide_teapot.py"), src,
                    str(ref), str(target)], cwd=ROOT, env=env, check=True, capture_output=True,
                   timeout=300)
    assert subdivide.main([src, str(out), str(target)]) == 0
    assert out.read_bytes() == ref.read_bytes()
    assert obj_loader.load_obj(str(out)).indices.shape == (n_tris, 3)
    # the scene helper writes the same mesh into build/assets/
    with open(bench_scene.teapot_obj(target), "rb") as f:
        assert f.read() == ref.read_bytes()
