"""intersect_idle_share: the share of the traced window in which the card is
idle while the host's innermost program span is render.intersect or
mesh_resolve (ops.intersect: K2, K3, the general volumes and the merged
resolve), in %. Nothing without those spans."""

from benchmark import spans

SPANS = ("render.intersect", "mesh_resolve")


def read(run):
    return spans.idle_under(run, SPANS)
