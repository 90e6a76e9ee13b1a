"""allreduce_share: rank 0's NCCL all-reduce kernel time as a share of the
traced sub-window, in % (parallel.sharding's chunk exchange). Nothing where
no all-reduce kernel ran."""


def read(run):
    tr = run.get("trace")
    if tr is None:
        return None
    seconds = tr.union_s(lambda a: a.kind == "kernel" and "allreduce" in a.name.lower())
    if seconds == 0.0:
        return None
    return 100.0 * seconds / tr.window_s
