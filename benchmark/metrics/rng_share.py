"""rng_share: device time of the kernels launched in the renderer's draw
spans (raygen, bounce_rng, nee_rng: models.camera and utils.threefry) over
the device's busy time, in %."""

SPANS = ("raygen", "bounce_rng", "nee_rng")


def read(run):
    tr = run.get("trace")
    if tr is None or tr.busy_s == 0.0:
        return None
    seconds = tr.union_s(lambda a: a.span in SPANS)
    if seconds == 0.0:
        return None
    return 100.0 * seconds / tr.busy_s
