"""launches_per_image: kernels on the device in the traced sub-window over
its images (rank 0's card on a mesh). The count repeats exactly from seed
to seed on a path whose chunk count is fixed; it is the host-bound paths'
cost (render.driver, render.integrator)."""


def read(run):
    tr = run.get("trace")
    if tr is None or not tr.kernels:
        return None
    return len(tr.kernels) / tr.images
