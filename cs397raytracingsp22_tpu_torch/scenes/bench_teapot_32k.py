"""The bench scene with its teapot subdivided to 32,832 triangles.

Four times beyond the dense budget (8,192 triangles), so the teapot is a
big mesh: the mega-bounce kernel K1 renders the scene, every bounce of a
path in one launch, and walks the teapot's BVH on every segment
(bounce_kernel_big, csrc/intersect.cuh::walk_big_mesh); the staged path's
kernels (K2, K3) take it only with next-event estimation. The CLI renders
it when given no scene, and the benchmark's cell bench32k.k1 measures it
(from its own copy of the mesh, benchmark/data/teapot_32k.obj). The mesh
is generated from assets/teapot_6k.obj into build/assets/ at first use.

    python -m cs397raytracingsp22_tpu_torch.cli cs397raytracingsp22_tpu_torch/scenes/bench_teapot_32k.py
"""

from cs397raytracingsp22_tpu_torch.scenes import bench_scene

TARGET = 32768  # subdivision target; the split of equal-area triangles lands on 32,832


def build(width: int = 512, height: int = 512, spp: int = 64, path_depth: int = 8):
    return bench_scene.build(width, height, spp=spp, path_depth=path_depth,
                             obj_path=bench_scene.teapot_obj(TARGET))
