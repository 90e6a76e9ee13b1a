"""image_s_p95: the 95th percentile of every image's wall time in the
window (host clock, numpy's linear interpolation)."""

import numpy as np


def read(run):
    times = run.get("image_times")
    if not times:
        return None
    return float(np.percentile(np.asarray(times), 95))
