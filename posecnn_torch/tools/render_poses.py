"""Pose overlay: a frame's objects rendered at their GT poses over its
colour image.

Port of `tools/render_poses.py`: each object of frame --frame as the convex
hull of its model points (`data.synthetic.Mesh.from_points`) rasterized at
its pose (`native.rasterize_mesh`, the host rasterizer), its rendered
colour blended over the frame at --alpha where it covers, written as
<output>/<frame:06d>-poses.png by `utils.png.write_png`. Host only (as the
JAX tool).

Usage: python -m posecnn_torch.tools.render_poses [--imdb lov_syn_val] [--frame 0]
           [--output output/render_poses] [--alpha 0.6]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def render(ds, f) -> np.ndarray:
    """The overlay's scene buffers for frame `f` of dataset `ds`."""
    from posecnn_torch.data.synthetic import Mesh
    from posecnn_torch.native import SceneBuffers, rasterize_mesh

    H, W = f.color.shape[:2]
    buf = SceneBuffers(H, W)
    for j in range(f.poses.shape[2]):
        c = int(f.cls_indexes[j])
        pts = np.asarray(ds._points_all[c])
        mesh = Mesh.from_points(pts[pts.any(axis=1)])
        rasterize_mesh(buf, mesh.vertices, mesh.faces, f.poses[:, :, j], f.intrinsic_matrix, c)
    return buf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--imdb", default="lov_syn_val")
    ap.add_argument("--frame", type=int, default=0)
    ap.add_argument("--output", default="output/render_poses")
    ap.add_argument("--alpha", type=float, default=0.6)
    args = ap.parse_args(argv)

    from posecnn_torch.data.factory import get_imdb
    from posecnn_torch.utils.png import write_png

    ds = get_imdb(args.imdb)
    f = ds.load_frame(args.frame)
    buf = render(ds, f)
    overlay = f.color.copy().astype(np.float32)
    mask = buf.label > 0
    rendered = buf.color[:, :, ::-1].astype(np.float32)  # RGB -> BGR
    overlay[mask] = (1 - args.alpha) * overlay[mask] + args.alpha * rendered[mask]
    os.makedirs(args.output, exist_ok=True)
    out = os.path.join(args.output, f"{args.frame:06d}-poses.png")
    write_png(out, overlay.astype(np.uint8))
    print(f"rendered {f.poses.shape[2]} objects -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
