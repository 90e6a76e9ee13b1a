"""k2_tree_roofline: K2's least time over its device time in the traced
sub-window, in %, on a scene rendered under next-event estimation whose
spheres K2 walks as a tree.

The least time of an image is the larger of its bytes over 3.35 TB/s and
its operations over 67 TFLOP/s (the H100 SXM's published HBM3 and FP32
peaks at 700 W), counted by the benchmark's own walk of the NEE path's
bounce rays and shadow rays (benchmark/reference/nee_sphere_walk.py) on
the paths of every 1021st camera ray of the first traced image, scaled to
the image. Nothing where K2 (`scene_intersect*`) did not run. The count
goes into the run's notes (`k2_tree_bound`)."""

K2 = "scene_intersect"


def read(run):
    tr = run.get("trace")
    if tr is None or not any(K2 in a.name for a in tr.kernels):
        return None
    from benchmark import check
    from benchmark.reference import nee_sphere_walk

    scene = check.reference_scene(run["cell"], run["device"])
    bound = nee_sphere_walk.k2_tree_image_bound(scene, check.image_seed(run["seed"], 0))
    run.setdefault("notes", {})["k2_tree_bound"] = bound
    return 100.0 * bound["seconds"] * tr.images / tr.union_s(lambda a: K2 in a.name)
