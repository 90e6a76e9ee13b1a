"""resolve_share: device time of the kernels launched in the span
mesh_resolve (ops.intersect's merged resolve of the mesh winners) over the
device's busy time, in %. Nothing where no mesh winner is resolved."""


def read(run):
    tr = run.get("trace")
    if tr is None or tr.busy_s == 0.0:
        return None
    seconds = tr.union_s(lambda a: a.span == "mesh_resolve")
    if seconds == 0.0:
        return None
    return 100.0 * seconds / tr.busy_s
