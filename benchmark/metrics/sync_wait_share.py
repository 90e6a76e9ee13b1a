"""sync_wait_share: host time inside render.live_count spans (the
executors' read of the live count a bounce, where the host waits for the
card) over the traced window, in %. Low means the card waits for the host.
On a mesh it also holds the wait for the slowest rank's all_reduce, which
runs before the next chunk's reads on the stream. Nothing without the
span."""

from benchmark import spans


def read(run):
    tr = run.get("trace")
    if tr is None or tr.window_s == 0.0 or not spans.spans_of(tr, ("render.live_count",)):
        return None
    return 100.0 * spans.host_seconds_in(tr, "render.live_count") / tr.window_s
