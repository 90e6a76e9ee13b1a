"""The bench scene with its teapot subdivided to 32,832 triangles.

Four times beyond the dense budget (8,192 triangles), so it renders
through the staged path: the scene-intersection kernel for the walls,
spheres and light, and the big-mesh BVH traversal kernel for the teapot.
The mesh is generated from assets/teapot_6k.obj into build/assets/ at
first use.

    python -m cs397raytracingsp22_tpu_torch.cli cs397raytracingsp22_tpu_torch/scenes/bench_teapot_32k.py
"""

from cs397raytracingsp22_tpu_torch.scenes import bench_scene

TARGET = 32768  # subdivision target; the split of equal-area triangles lands on 32,832


def build(width: int = 512, height: int = 512, spp: int = 64, path_depth: int = 8):
    return bench_scene.build(width, height, spp=spp, path_depth=path_depth,
                             obj_path=bench_scene.teapot_obj(TARGET))
