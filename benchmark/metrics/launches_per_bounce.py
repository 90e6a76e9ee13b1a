"""launches_per_bounce: the host's kernel-launch calls (cudaLaunch*,
cuLaunch*) that start inside render.bounce spans, over the number of those
spans: what one bounce of the staged or NEE executor launches, counted
where the launches happen (rank 0 on a mesh). Nothing without the span."""

from benchmark import spans


def read(run):
    tr = run.get("trace")
    if tr is None:
        return None
    launches, bounces = spans.launches_in(tr, "render.bounce")
    return launches / bounces if bounces else None
