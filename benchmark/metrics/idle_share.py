"""idle_share: the share of the traced sub-window (first image's start to
the last one's end, host clock) in which nothing runs on the device (rank
0's card on a mesh), in %."""


def read(run):
    tr = run.get("trace")
    if tr is None or tr.window_s == 0.0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
