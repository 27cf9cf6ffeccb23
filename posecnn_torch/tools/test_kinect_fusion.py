"""KinectFusion smoke tool: fuse a run of depth frames into a TSDF volume on
the card, raycast it, extract its surface.

Port of `tools/test_kinect_fusion.py` over `engine.kfusion.KinectFusion`:
the sorted `*-depth.png` files of --images (read as cv2's IMREAD_UNCHANGED
by `utils.png.imread`, divided by --factor_depth), the demo camera's K, a
volume of --grid^3 voxels over 3 m from (-1.5, -1.5, 0); the pose tracked
from the second frame on. Writes <output>/surface.npy (the surface points)
and <output>/raycast.png (the raycast depth of the last camera scaled to
0-255, by `utils.png.write_png`); prints each frame's tracked translation,
the surface's point count and the raycast's hit fraction. The exit code is
1 when no surface was found (or 2 without a card, unless --device cpu).

Usage: python -m posecnn_torch.tools.test_kinect_fusion --images DIR [--grid 128]
           [--factor_depth 10000] [--output output/kfusion] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

# the demo frames' camera (tools/test_kinect_fusion.py)
K_DEMO = np.array([[1066.778, 0, 312.9869], [0, 1067.487, 241.3109], [0, 0, 1]], np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", required=True, help="a directory of *-depth.png frames (uint16)")
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--factor_depth", type=float, default=10000.0)
    ap.add_argument("--output", default="output/kfusion")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from posecnn_torch.engine.kfusion import KinectFusion
    from posecnn_torch.utils.png import IMREAD_UNCHANGED, imread, write_png

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("test_kinect_fusion: no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
        return 2
    depths = sorted(glob.glob(os.path.join(args.images, "*-depth.png")))
    if not depths:
        print(f"no depth frames under {args.images}")
        return 1
    kf = KinectFusion(grid_size=args.grid, origin=(-1.5, -1.5, 0.0), voxel_size=3.0 / args.grid, device=args.device)
    for j, path in enumerate(depths):
        depth = imread(path, IMREAD_UNCHANGED).astype(np.float32) / args.factor_depth
        kf.feed_data(depth, K_DEMO)
        if j > 0:
            pose = kf.solve_pose()
            print(f"frame {j}: pose t = {np.asarray(pose)[:, 3]}")
        kf.fuse_depth()
    pts, _ = kf.extract_surface(max_points=8192)
    print(f"surface points: {pts.shape[0]}")
    H, W = depth.shape
    d, hit = kf.render(H, W)
    print(f"raycast hit fraction: {float(np.mean(hit)):.3f}")
    os.makedirs(args.output, exist_ok=True)
    np.save(os.path.join(args.output, "surface.npy"), pts)
    write_png(os.path.join(args.output, "raycast.png"),
              (np.clip(d / max(float(d.max()), 1e-6), 0, 1) * 255).astype(np.uint8))
    print(f"artifacts in {args.output}")
    return 0 if pts.shape[0] > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
