"""rng_idle_share: the share of the traced window in which the card is idle
while the host is inside the renderer's draw spans (raygen, bounce_rng,
nee_rng: models.camera and utils.threefry), innermost, in %: the host cost
of the draws, beside rng_share's device cost. Nothing without those spans."""

from benchmark import spans

SPANS = ("raygen", "bounce_rng", "nee_rng")


def read(run):
    return spans.idle_under(run, SPANS)
