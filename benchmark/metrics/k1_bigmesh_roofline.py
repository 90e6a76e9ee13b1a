"""k1_bigmesh_roofline: K1's least time over its device time in the traced
sub-window, in %, on a scene with a mesh past the dense budget, which K1
walks through its BVH.

The least time of an image is the larger of its bytes over 3.35 TB/s and
its operations over 67 TFLOP/s (the H100 SXM's published HBM3 and FP32
peaks at 700 W), counted by the benchmark's own superleaf-tree count over
every mesh, whatever its size (benchmark/reference/bigmesh_walk.py), on
every 1021st camera ray of the first traced image, scaled to the image.
Nothing where K1 (`bounce_kernel`) did not run. K1's launches of an image
(one a chunk) cover all its camera rays, so the sub-window's least time is
the image's times the traced images."""

K1 = "bounce_kernel"


def read(run):
    tr = run.get("trace")
    if tr is None or not any(K1 in a.name for a in tr.kernels):
        return None
    from benchmark import check
    from benchmark.reference import bigmesh_walk

    scene = check.reference_scene(run["cell"], run["device"])
    bound = bigmesh_walk.k1_bigmesh_image_bound(scene, check.image_seed(run["seed"], 0))
    run.setdefault("notes", {})["k1_bigmesh_bound"] = bound
    return 100.0 * bound["seconds"] * tr.images / tr.union_s(lambda a: K1 in a.name)
