"""ICP smoke check on the card: perturb a known pose of a dataset's object,
refine it against the object's own points, report the recovered error.

Port of `tools/test_icp.py` over `engine.refine.icp_refine`: the object
(--cls) of the dataset's models, its first 2048 non-zero points, a random
rotation (RandomState(0)) at (0.05, -0.02, 0.9) m as the GT pose, the
target cloud its points under that pose, the start ~10 degrees and 3 cm
off; --iters Gauss-Newton steps. Prints the translation error and the ADD
before and after; the exit code is 1 unless the ADD at least halves.

Usage: python -m posecnn_torch.tools.test_icp [--imdb lov_syn_val] [--cls 3] [--iters 30] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def qmul(a, b) -> np.ndarray:
    """The Hamilton product of two wxyz quaternions."""
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def run(points: np.ndarray, iters: int, dev) -> dict:
    """The check on one object's points: the GT pose, the start, ICP;
    returns the errors (metres) before and after."""
    import torch

    from posecnn_torch.engine.refine import icp_refine
    from posecnn_torch.utils.quaternion import quat2mat

    def mat(q):
        return quat2mat(torch.as_tensor(np.asarray(q, np.float32))[None])[0].numpy()

    pts = points[points.any(axis=1)][:2048]
    rng = np.random.RandomState(0)
    a = rng.randn(4)
    a /= np.linalg.norm(a)
    R_gt = mat(a)
    t_gt = np.array([0.05, -0.02, 0.9], np.float32)
    target = pts @ R_gt.T + t_gt
    d = np.array([1.0, 0.06, -0.04, 0.05])
    d /= np.linalg.norm(d)
    q0 = qmul(a, d).astype(np.float32)
    t0 = t_gt + np.array([0.02, -0.015, 0.02], np.float32)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)[None]  # noqa: E731
    q, t = icp_refine(f32(q0), f32(t0), f32(pts), f32(target), torch.ones((1, target.shape[0]), dtype=torch.bool,
                                                                           device=dev), iters=iters)
    R, t = mat(q[0].cpu().numpy()), t[0].cpu().numpy()
    return {
        "t0": float(np.linalg.norm(t0 - t_gt)), "t": float(np.linalg.norm(t - t_gt)),
        "add0": float(np.linalg.norm(pts @ (mat(q0) - R_gt).T + (t0 - t_gt), axis=1).mean()),
        "add": float(np.linalg.norm(pts @ (R - R_gt).T + (t - t_gt), axis=1).mean()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--imdb", default="lov_syn_val")
    ap.add_argument("--cls", type=int, default=3)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from posecnn_torch.data.factory import get_imdb

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("test_icp: no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
        return 2
    ds = get_imdb(args.imdb)
    e = run(np.asarray(ds._points_all[args.cls]), args.iters, torch.device(args.device))
    print(f"translation error: {e['t0'] * 100:.2f} cm -> {e['t'] * 100:.2f} cm")
    print(f"ADD:               {e['add0'] * 100:.2f} cm -> {e['add'] * 100:.2f} cm")
    return 0 if e["add"] < e["add0"] * 0.5 else 1


if __name__ == "__main__":
    sys.exit(main())
