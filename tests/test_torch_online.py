"""The serving tools of the port (`posecnn_torch/tools/online.py`,
`tools/demo.py`) against the JAX package's `tools/online.py` and
`tools/demo.py`.

Frames are PNGs written here from crops of `data/lov_syn_val_v4` frames
(128x160; `data/demo_images` is not in the repository). Both packages run
the same weights (the port's seed weights at narrow widths, trunk_scale
0.125 and fc_dim 64, float32, written as an npz that both read with
--model), JAX unjitted but for its Hough voting (jitted, XLA moves the RoI
pool's last bin: ROADMAP Queue 3 item 11). The watch loop's JSON, the TCP server's answers to a file
request and a base64 PNG request, and the demo's detections must equal
JAX's: classes and scores exactly, boxes within 1e-3 px, quaternions and
translations within 1e-4 (the limits of tests/test_torch_posecnn.py); the
demo's label PNGs bit-equal. A JPEG request is answered ok: false, naming
the format.
"""

from __future__ import annotations

import base64
import dataclasses
import functools
import importlib.util
import json
import os
import shutil
import socket
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posecnn_tpu.models.posecnn as JP
from posecnn_torch.core import config as C
from posecnn_torch.core.convert import init_params_numpy
from posecnn_torch.tools import demo as port_demo
from posecnn_torch.tools import online as port_online
from posecnn_torch.utils.png import IMREAD_UNCHANGED, imread, write_png

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOOLS = os.path.join(ROOT, "tools")
TOY_CFG = os.path.join(ROOT, "experiments", "cfgs", "toy_pose.yml")
NARROW = dict(trunk_scale=0.125, fc_dim=64)
FRAMES = ("000000", "000003")


def _jax_tool(name: str):
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jitted_hough(hough):
    """JAX's Hough voting jitted inside an unjitted forward (unjitted, its
    scans run as Python loops: ~13 s a frame)."""
    compiled = {}

    def call(*args, **kw):
        key = tuple(sorted(kw.items()))
        if key not in compiled:
            compiled[key] = jax.jit(functools.partial(hough, **kw))
        with jax.disable_jit(False):
            return compiled[key](*args)

    return call


@pytest.fixture(scope="module")
def narrow():
    """Both packages' model configs at narrow widths in float32; JAX's Hough
    voting jitted."""
    with pytest.MonkeyPatch.context() as mp:
        orig = JP.PoseCNNConfig
        mp.setattr(JP, "PoseCNNConfig", lambda **kw: orig(**{**kw, **NARROW, "compute_dtype": jnp.float32}))
        mp.setattr(JP, "hough_voting", _jitted_hough(JP.hough_voting))
        for name in ("online_model_cfg", "demo_model_cfg"):
            f = getattr(C, name)
            mp.setattr(C, name, lambda cfg, _f=f: dataclasses.replace(_f(cfg), **NARROW, compute_dtype=torch.float32))
        yield


def _weights(path: str, cfg) -> str:
    """The port's seed weights of `cfg` as a train-state npz."""
    params = init_params_numpy(C.Config().RNG_SEED, cfg)
    np.savez(path, **{f"['params']['{s}']['{k}']": v for s, leaves in params.items() for k, v in leaves.items()})
    return path


@pytest.fixture(scope="module")
def work(tmp_path_factory, narrow):
    d = tmp_path_factory.mktemp("online")
    frames = d / "frames"
    frames.mkdir()
    for name in FRAMES:
        with np.load(os.path.join(ROOT, "data", "lov_syn_val_v4", f"{name}.npz")) as f:
            write_png(str(frames / f"{name}-color.png"), np.ascontiguousarray(f["color"][176:304, 240:400]))
            write_png(str(frames / f"{name}-depth.png"), (f["depth"][176:304, 240:400] * 10000).astype(np.uint16))
    toy = C.online_model_cfg(C.cfg_from_file(TOY_CFG))
    return {"dir": d, "frames": frames, "toy_npz": _weights(str(d / "toy.npz"), toy),
            "demo_npz": _weights(str(d / "demo.npz"), C.demo_model_cfg(C.Config()))}


@pytest.fixture(scope="module")
def engines(work):
    import argparse

    args = argparse.Namespace(cfg_file=TOY_CFG, model=work["toy_npz"], device="cpu")
    jprocess = _jax_tool("online").build_engine(args)
    done = {}

    def jax_process(im):
        """JAX's engine, unjitted; each frame run once."""
        key = im.tobytes()
        if key not in done:
            with jax.disable_jit():
                done[key] = jprocess(im)
        return done[key]

    return port_online.build_engine(args), jax_process


def _same_dets(got, ref, quat="quaternion_wxyz", trans="translation"):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g["class"] == r["class"] and g["score"] == r["score"]
        np.testing.assert_allclose(g["box"], r["box"], atol=1e-3)
        np.testing.assert_allclose(g[quat], r[quat], atol=1e-4)
        np.testing.assert_allclose(g[trans], r[trans], atol=1e-4)


def test_watch_loop_matches_jax(work, engines):
    port, jax_process = engines
    jonl = _jax_tool("online")
    out = {}
    for pkg, loop, process in (("port", port_online.watch_loop, port), ("jax", jonl.watch_loop, jax_process)):
        d = work["dir"] / f"watch_{pkg}"
        shutil.copytree(work["frames"], d)
        loop(process, str(d), poll=0.01, once=True)
        out[pkg] = {n: json.load(open(d / f"{n}-posecnn.json")) for n in FRAMES}
    n_dets = 0
    for n in FRAMES:
        assert out["port"][n]["frame"] == out["jax"][n]["frame"] == n
        _same_dets(out["port"][n]["detections"], out["jax"][n]["detections"])
        n_dets += len(out["port"][n]["detections"])
    assert n_dets > 0


def _request(port: int, req: dict) -> dict:
    deadline = time.time() + 60
    while True:
        try:
            s = socket.create_connection(("127.0.0.1", port), timeout=1)
            break
        except OSError:
            if time.time() > deadline:
                pytest.fail("server did not come up")
            time.sleep(0.1)
    with s:
        s.settimeout(300)
        s.sendall((json.dumps(req) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf)


def test_tcp_server_matches_jax(work, engines):
    """A file request and a base64 PNG request answer the detections of the
    frame (JAX's engine on the same weights); a JPEG is refused in the
    answer, and the server goes on serving."""
    import cv2

    port_process, jax_process = engines
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    threading.Thread(target=port_online.serve, args=(port_process, port), daemon=True).start()
    f0, f1 = (str(work["frames"] / f"{n}-color.png") for n in FRAMES)
    by_file = _request(port, {"file": f0})
    with open(f1, "rb") as f:
        by_b64 = _request(port, {"image_b64": base64.b64encode(f.read()).decode()})
    jpeg = cv2.imencode(".jpg", imread(f1))[1].tobytes()
    refused = _request(port, {"image_b64": base64.b64encode(jpeg).decode()})
    missing = _request(port, {"file": str(work["dir"] / "nope-color.png")})
    assert by_file["ok"] and by_b64["ok"]
    _same_dets(by_file["detections"], jax_process(imread(f0))[0])
    _same_dets(by_b64["detections"], jax_process(imread(f1))[0])
    assert refused == {"ok": False, "error": refused["error"]} and "not a PNG" in refused["error"]
    assert not missing["ok"] and "no file" in missing["error"]
    assert _request(port, {"file": f0}) == by_file


def test_demo_matches_jax(work, monkeypatch):
    """The demo over the frames with --visualize and --refine: the same
    detections and label PNGs as JAX's demo (the refine disabled in both:
    no lov_syn_train model points here), and an overlay a frame."""
    jdemo = _jax_tool("demo")
    outs = {p: work["dir"] / f"demo_{p}" for p in ("port", "jax")}
    argv = ["--images", str(work["frames"]), "--model", work["demo_npz"], "--device", "cpu", "--visualize",
            "--refine"]
    assert port_demo.main(argv + ["--output", str(outs["port"])]) == 0
    monkeypatch.setattr(sys, "argv", ["demo"] + argv + ["--output", str(outs["jax"])])
    with jax.disable_jit():
        jdemo.main()
    for n in FRAMES:
        got, ref = (json.load(open(outs[p] / f"{n}-dets.json")) for p in ("port", "jax"))
        _same_dets(got, ref, quat="pose_quat_wxyz", trans="pose_t")
        np.testing.assert_array_equal(imread(str(outs["port"] / f"{n}-label.png"), IMREAD_UNCHANGED),
                                      imread(str(outs["jax"] / f"{n}-label.png"), IMREAD_UNCHANGED))
    assert sorted(f for f in os.listdir(outs["port"]) if f.endswith("-vis.png")) == ["000000-vis.png",
                                                                                     "000001-vis.png"]
