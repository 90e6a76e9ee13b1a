"""Preview a running render from its checkpoint (mirrors the JAX package's
tools/preview_checkpoint.py).

    python -m cs397raytracingsp22_tpu_torch.tools.preview_checkpoint CKPT.npz OUT.png WIDTH HEIGHT [GAMMA]

`render_to_image(checkpoint_path=...)` of either package keeps the HDR
accumulator (the per-pixel sum in raster order) and its spp count after
every spp chunk. This tool tonemaps accum / spp_done with the final
image's channel bleed and gamma (ops/tonemap.py; GAMMA 2.2 unless given),
on the CPU, so a long render can be looked at without stopping it. A
checkpoint of another resolution than WIDTH × HEIGHT is refused (exit 1).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def preview(ckpt_path: str, width: int, height: int, gamma: float = 2.2):
    """(the (H, W, 3) uint8 preview, spp_done); ValueError when the
    checkpoint holds another number of pixels than width × height."""
    from cs397raytracingsp22_tpu_torch.ops import tonemap as tonemap_ops

    with np.load(ckpt_path, allow_pickle=False) as d:
        accum, spp_done = d["accum"], int(d["spp_done"])
    if accum.shape[0] != width * height:
        raise ValueError(f"checkpoint has {accum.shape[0]} pixels, not {width}x{height}")
    mean = (accum / max(spp_done, 1)).astype(np.float32).reshape(height, width, 3)
    return tonemap_ops.tonemap(torch.from_numpy(mean), gamma).numpy(), spp_done


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("checkpoint")
    p.add_argument("out")
    p.add_argument("width", type=int)
    p.add_argument("height", type=int)
    p.add_argument("gamma", type=float, nargs="?", default=2.2)
    args = p.parse_args(argv)
    from cs397raytracingsp22_tpu_torch.render.driver import save_png

    try:
        img, spp_done = preview(args.checkpoint, args.width, args.height, args.gamma)
    except ValueError as e:
        print(e)
        return 1
    save_png(img, args.out)
    print(f"[preview] {args.out}: {spp_done} spp accumulated")
    return 0


if __name__ == "__main__":
    sys.exit(main())
