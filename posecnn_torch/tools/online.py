"""Online inference on the card: a directory watcher and a JSON-over-TCP server.

Port of `tools/online.py`, the counterpart of the reference's ROS node: one
process loads the model once and serves frames over two transports.

  --watch DIR   each `NNNNNN-color.png` in DIR, as it appears (polled every
                0.2 s; --once: those already there, then exit), gets a
                `NNNNNN-posecnn.json` beside it: {"frame", "detections"}.
  --serve PORT  a `socketserver.ThreadingTCPServer` on 127.0.0.1:PORT. A
                request is one line of JSON, {"file": PATH} or
                {"image_b64": BASE64 PNG BYTES}; its answer one line,
                {"ok": true, "detections": [...]} or {"ok": false,
                "error": MESSAGE} (a JPEG among them: no JPEG decoder here).

A detection is {"class", "box" [x1, y1, x2, y2], "score" (votes),
"quaternion_wxyz", "translation"}. The model (`build_engine`) is PoseCNN
with the config's knobs (`core.config.online_model_cfg`: TRAIN.NUM_CLASSES
and NUM_UNITS, TEST.VOTING_THRESHOLD, the TPU section's Hough settings), the
seed weights of RNG_SEED or --model (an npz or orbax snapshot, a vgg16.npy or
a TF1 checkpoint: `core.checkpoint.load_weights`), the demo camera's K and
0.1 m extents for every class, YCB's class names where there are 22
classes; a frame runs through `engine.test.make_inference_fn` and
`postprocess_detections`. Images are read by `utils.png` (`imread`, and
`imdecode` for the bytes of a request).

The server's threads share one model on one stream: each request's
inference runs under a lock, one at a time (the kernels' launch counters
and their first build are not safe to enter twice); reading and decoding
the image, and writing the answer, run outside it. --watch --once ends
with a line of the kernels' launches.

Usage: python -m posecnn_torch.tools.online (--watch DIR [--once] | --serve PORT) [--cfg FILE.yml]
           [--model SNAPSHOT] [--device cuda]
"""

from __future__ import annotations

import argparse
import base64
import glob
import json
import os
import socketserver
import sys
import threading
import time

import numpy as np

DEMO_K = np.array([[1066.778, 0, 312.9869], [0, 1067.487, 241.3109], [0, 0, 1]])


def build_engine(args):
    """process(im_bgr (H,W,3) uint8) -> (detections, label map (H,W)) for
    `args` (cfg_file, model, device)."""
    import torch

    from posecnn_torch.core import config as C
    from posecnn_torch.core.checkpoint import load_weights
    from posecnn_torch.core.convert import init_params_numpy, make_model
    from posecnn_torch.data.lov import YCB_CLASSES
    from posecnn_torch.engine.test import make_inference_fn, postprocess_detections
    from posecnn_torch.utils.meta import build_meta_data

    cfg = C.cfg_from_file(args.cfg_file) if args.cfg_file else C.Config()
    model_cfg = C.online_model_cfg(cfg)
    params = init_params_numpy(cfg.RNG_SEED, model_cfg)
    if args.model:
        params = load_weights(args.model, params)
    dev = torch.device(args.device)
    model = make_model(model_cfg, params, dev)
    infer = make_inference_fn(model_cfg, cfg.pixel_means(), dev)
    n = model_cfg.num_classes
    class_names = YCB_CLASSES if n == len(YCB_CLASSES) else [f"class_{i:02d}" for i in range(n)]
    extents = torch.full((n, 3), 0.1, device=dev)
    meta = torch.from_numpy(build_meta_data(DEMO_K)[None]).to(dev)
    lock = threading.Lock()

    def process(im_bgr: np.ndarray):
        raw = torch.from_numpy(np.ascontiguousarray(im_bgr[None])).to(dev)
        with lock:
            out = infer(model, raw, meta, extents)
            rois, poses = postprocess_detections(out)
            label = out["label_2d"][0].cpu().numpy()
        dets = [
            {
                "class": class_names[int(r[1])],
                "box": [float(v) for v in r[2:6]],
                "score": float(r[6]),
                "quaternion_wxyz": [float(v) for v in p[:4]],
                "translation": [float(v) for v in p[4:7]],
            }
            for r, p in zip(rois, poses)
        ]
        return dets, label

    return process


def watch_loop(process, directory: str, poll: float = 0.2, once: bool = False):
    """Detections for each new `*-color.png` of `directory` (one that is not
    a readable PNG is skipped, as cv2's None is there)."""
    from posecnn_torch.utils.png import IMREAD_COLOR, imread

    seen = set()
    while True:
        frames = sorted(glob.glob(os.path.join(directory, "*-color.png")))
        new = [f for f in frames if f not in seen]
        for path in new:
            seen.add(path)
            try:
                im = imread(path, IMREAD_COLOR)
            except (OSError, ValueError, NotImplementedError):
                continue
            t0 = time.time()
            dets, _ = process(im)
            name = os.path.basename(path).replace("-color.png", "")
            out_path = path.replace("-color.png", "-posecnn.json")
            with open(out_path, "w") as f:
                json.dump({"frame": name, "detections": dets}, f)
            print(f"{name}: {len(dets)} detections ({time.time() - t0:.3f}s) -> {out_path}", flush=True)
        if once and not new:
            return
        time.sleep(poll)


def serve(process, port: int):
    """Answer JSON-line requests on 127.0.0.1:`port` until the process ends."""
    from posecnn_torch.utils.png import IMREAD_COLOR, imdecode, imread

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for line in self.rfile:
                try:
                    req = json.loads(line)
                    if "file" in req:
                        im = imread(req["file"], IMREAD_COLOR)
                    else:
                        im = imdecode(base64.b64decode(req["image_b64"]), IMREAD_COLOR)
                    dets, _ = process(im)
                    resp = {"ok": True, "detections": dets}
                except Exception as e:  # noqa: BLE001 - reported to the client
                    resp = {"ok": False, "error": str(e)}
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()

    with socketserver.ThreadingTCPServer(("127.0.0.1", port), Handler) as srv:
        print(f"posecnn_torch online server on 127.0.0.1:{port}", flush=True)
        srv.serve_forever()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg", dest="cfg_file", default=None, help="an experiments/cfgs/*.yml config")
    ap.add_argument("--model", default=None, help="npz or orbax snapshot, vgg16.npy or TF1 checkpoint")
    ap.add_argument("--watch", default=None, help="directory to watch for frames")
    ap.add_argument("--serve", type=int, default=None, help="TCP port to serve on (127.0.0.1)")
    ap.add_argument("--once", action="store_true", help="process the frames already there, then exit")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not (args.serve or args.watch):
        ap.error("one of --watch or --serve is required")

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("online: no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
        return 2
    from posecnn_torch.test_net import _launches, _reset_launches

    process = build_engine(args)
    if args.serve:
        serve(process, args.serve)
    else:
        _reset_launches()
        watch_loop(process, args.watch, once=args.once)
        print(f"launches {json.dumps(_launches())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
