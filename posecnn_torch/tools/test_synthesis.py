"""Frame dump: a dataset's first frames as colour, label and depth PNGs.

Port of `tools/test_synthesis.py` over the port's dataset factory: for
each of the first --num frames, <output>/<i:06d>-color.png, -label.png
(the class ids scaled to 0..255) and, where the frame has depth,
-depth.png (uint16), written by `utils.png.write_png`; one line a frame
with its classes and foreground pixel count. Host only (as the JAX tool).

Usage: python -m posecnn_torch.tools.test_synthesis [--imdb lov_syn_val] [--num 4] [--output output/synthesis]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--imdb", default="lov_syn_val")
    ap.add_argument("--num", type=int, default=4)
    ap.add_argument("--output", default="output/synthesis")
    args = ap.parse_args(argv)

    from posecnn_torch.data.factory import get_imdb
    from posecnn_torch.utils.png import write_png

    ds = get_imdb(args.imdb)
    os.makedirs(args.output, exist_ok=True)
    for i in range(args.num):
        f = ds.load_frame(i)
        base = os.path.join(args.output, f"{i:06d}")
        write_png(base + "-color.png", f.color)
        write_png(base + "-label.png",
                  (f.label.astype(np.float32) * (255.0 / max(ds.num_classes - 1, 1))).astype(np.uint8))
        if f.depth is not None:
            write_png(base + "-depth.png", f.depth.astype(np.uint16))
        print(f"{i:06d}: classes {sorted(set(int(c) for c in f.cls_indexes))} fg_px={int((f.label > 0).sum())}")
    print(f"wrote {args.num} frames to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
