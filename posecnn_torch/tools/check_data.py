"""Dataset sanity check: read every frame and check its shapes and values.

Port of `tools/check_data.py` over the port's dataset factory
(`data.factory.get_imdb`): each frame's colour image has 3 or more
channels, its label map the image's size and classes below the dataset's
count, its poses are (3, 4, N) and finite, its intrinsics (3, 3). A bad
frame is reported and counted; the exit code is 1 when any frame is bad.
It reads files on the host and does no device work (nor does the JAX
tool).

Usage: python -m posecnn_torch.tools.check_data [--imdb toy_train] [--max_frames N]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def check_frame(ds, f) -> None:
    """Raise AssertionError naming what is wrong with frame `f`."""
    assert f.color.ndim == 3 and f.color.shape[2] >= 3, f.color.shape
    assert f.label.shape == f.color.shape[:2], (f.label.shape, f.color.shape)
    assert f.label.max() < ds.num_classes, int(f.label.max())
    assert f.poses.shape[:2] == (3, 4), f.poses.shape
    assert np.isfinite(f.poses).all()
    assert f.intrinsic_matrix.shape == (3, 3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--imdb", default="toy_train")
    ap.add_argument("--max_frames", type=int, default=None)
    args = ap.parse_args(argv)

    from posecnn_torch.data.factory import get_imdb

    ds = get_imdb(args.imdb)
    n = ds.num_images if args.max_frames is None else min(args.max_frames, ds.num_images)
    bad = 0
    for i in range(n):
        try:
            check_frame(ds, ds.load_frame(i))
        except Exception as e:  # noqa: BLE001 - report and go on
            bad += 1
            print(f"frame {i} ({ds.image_index[i]}): BAD — {e}")
        if (i + 1) % 500 == 0:
            print(f"checked {i + 1}/{n}")
    print(f"done: {n - bad}/{n} frames ok")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
