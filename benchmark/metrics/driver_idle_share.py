"""driver_idle_share: the share of the traced window in which the card is
idle while the host's innermost program span is one of render.driver's
(render.image, render.chunk, render.k1, render.finish, render.checkpoint):
chunk set-up, accumulation and the image's finish, in %. Nothing without
those spans."""

from benchmark import spans

SPANS = ("render.image", "render.chunk", "render.k1", "render.finish", "render.checkpoint")


def read(run):
    return spans.idle_under(run, SPANS)
