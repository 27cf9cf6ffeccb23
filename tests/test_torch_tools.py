"""The port's tools (`posecnn_torch/tools/`) against the JAX package's
(`tools/*.py`), on the CPU.

  * check_data, test_icp, test_synthesis, render_poses: the same output
    lines and PNGs that decode equal (renders bit-equal on one machine, as
    the host rasterizer's are), on a YCB-Video tree written from the frozen
    frames (`tests/torch_parity.py:write_lov_tree`, POSECNN_DATA), whose
    models the frozen sets take; test_icp's errors within 1e-4 cm.
  * diag_rot: the report of both tools on one snapshot at narrow widths
    (trunk 1/8, fc 64, NUM_UNITS 8, float32; PoseCNNConfig narrowed in both
    packages), JAX's network unjitted (under jit XLA moves the RoI pool's
    last bin edge, ROADMAP Queue 3): the arms' rotation errors within 1e-3
    degrees, the translation errors within 1e-6 m, the counts equal.
  * isolate_pose: 2 steps at narrow widths on the tree, losses finite, the
    trajectory's keys JAX's `evaluate` keys.
  * analyze_z (tools/analyze_z.py, NumPy only, not ported) on detections in
    test_net's `detections.npz` layout from the port's test_net and from
    JAX's, on the same small frames and weights (`tests/test_torch_eval.py`:
    its poses agree to 1e-4): the two analyses within 1e-3 relative.
  * supervise_train: every case of tests/test_supervisor.py with the port's
    module, and its run directory against the one train_net writes.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import inspect
import io
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_supervisor as JAX_SUPERVISOR_TESTS
from posecnn_torch.tools import check_data, diag_rot, isolate_pose, render_poses, supervise_train, test_icp
from posecnn_torch.tools import test_synthesis
from tests.torch_parity import write_lov_tree

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOOLS = os.path.join(ROOT, "tools")
NARROW = dict(trunk_scale=0.125, fc_dim=64, num_units=8)


@pytest.fixture(scope="module")
def lov_data(tmp_path_factory):
    """POSECNN_DATA at a YCB-Video tree of frames v4/000000-000003 (and 2
    data_syn frames) for the module's tests."""
    root = str(tmp_path_factory.mktemp("data"))
    write_lov_tree(root, frames=range(4), syn_frames=range(16, 18))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("POSECNN_DATA", root)
        yield root


def _jax_tool(name: str, argv):
    """(exit code, stdout) of tools/<name>.py's main() with `argv`."""
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf, old = io.StringIO(), sys.argv
    sys.argv = [name] + list(argv)
    try:
        with contextlib.redirect_stdout(buf):
            rc = mod.main()
    finally:
        sys.argv = old
    return rc, buf.getvalue()


def _port_tool(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(list(argv))
    return rc, buf.getvalue()


@pytest.mark.parametrize("imdb,n", [("toy_train", 6), ("lov_syn_val", 3)])
def test_check_data_matches_jax(imdb, n, lov_data):
    assert _port_tool(check_data, ["--imdb", imdb, "--max_frames", str(n)]) == \
        _jax_tool("check_data", ["--imdb", imdb, "--max_frames", str(n)]) == (0, f"done: {n}/{n} frames ok\n")


def test_check_data_reports_a_bad_frame(monkeypatch, capsys):
    """A frame whose label holds a class past the dataset's count is BAD,
    counted, and the exit code is 1."""
    from posecnn_torch.data import factory
    from posecnn_torch.data.toy import toy

    class Bad(toy):
        def load_frame(self, i):
            f = super().load_frame(i)
            if i == 1:
                f.label[0, 0] = self.num_classes
            return f

    monkeypatch.setattr(factory, "get_imdb", lambda name: Bad("train"))
    assert check_data.main(["--max_frames", "3"]) == 1
    out = capsys.readouterr().out
    assert "frame 1 " in out and "BAD" in out and out.endswith("done: 2/3 frames ok\n")


def _numbers(text: str):
    return [float(v) for v in re.findall(r"-?\d+\.\d+", text)]


@pytest.mark.parametrize("cls", [3, 16])
def test_test_icp_matches_jax(cls, lov_data):
    """The same lines; the errors within 1e-4 cm (two decimals printed);
    the exit code 0 (the ADD at least halves)."""
    rc, out = _port_tool(test_icp, ["--imdb", "lov_syn_val", "--cls", str(cls), "--device", "cpu"])
    jrc, jout = _jax_tool("test_icp", ["--imdb", "lov_syn_val", "--cls", str(cls)])
    assert rc == jrc == 0
    assert re.sub(r"-?\d+\.\d+", "N", out) == re.sub(r"-?\d+\.\d+", "N", jout)
    np.testing.assert_allclose(_numbers(out), _numbers(jout), atol=1e-2 + 1e-9)
    from posecnn_torch.data.factory import get_imdb

    e = test_icp.run(np.asarray(get_imdb("lov_syn_val")._points_all[cls]), 30, torch.device("cpu"))
    assert e["add"] < 0.5 * e["add0"] and e["t"] < e["t0"]


def _pngs(d):
    import cv2

    return {f: cv2.imread(os.path.join(d, f), cv2.IMREAD_UNCHANGED) for f in sorted(os.listdir(d))}


def test_test_synthesis_matches_jax(lov_data, tmp_path):
    """Colour, scaled label and uint16 depth PNGs of 3 frames decode equal
    to the JAX tool's (cv2.imwrite); the same lines."""
    rc, out = _port_tool(test_synthesis, ["--imdb", "lov_syn_val", "--num", "3", "--output", str(tmp_path / "p")])
    _, jout = _jax_tool("test_synthesis", ["--imdb", "lov_syn_val", "--num", "3", "--output", str(tmp_path / "j")])
    assert rc == 0 and out.replace(str(tmp_path / "p"), "D") == jout.replace(str(tmp_path / "j"), "D")
    got, ref = _pngs(tmp_path / "p"), _pngs(tmp_path / "j")
    assert sorted(got) == sorted(ref) and len(got) == 9
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k
    assert got["000000-depth.png"].dtype == np.uint16 and got["000000-label.png"].max() > 0


@pytest.mark.parametrize("frame", [0, 2])
def test_render_poses_matches_jax(frame, lov_data, tmp_path):
    """The pose overlay (the host rasterizer's hulls at the GT poses)
    bit-equal to the JAX tool's PNG."""
    rc, out = _port_tool(render_poses, ["--imdb", "lov_syn_val", "--frame", str(frame), "--output", str(tmp_path / "p")])
    _jax_tool("render_poses", ["--imdb", "lov_syn_val", "--frame", str(frame), "--output", str(tmp_path / "j")])
    got, ref = _pngs(tmp_path / "p"), _pngs(tmp_path / "j")
    name = f"{frame:06d}-poses.png"
    assert rc == 0 and list(got) == list(ref) == [name] and "rendered 5 objects" in out
    np.testing.assert_array_equal(got[name], ref[name])


@pytest.fixture
def narrow_configs(monkeypatch):
    """PoseCNNConfig of both packages at narrow widths and float32, as the
    tools build it from the defaults."""
    import posecnn_torch.config as PC
    import posecnn_tpu.models.posecnn as JP

    monkeypatch.setattr(PC, "PoseCNNConfig", functools.partial(PC.PoseCNNConfig, compute_dtype=torch.float32,
                                                               **NARROW))
    monkeypatch.setattr(JP, "PoseCNNConfig", functools.partial(JP.PoseCNNConfig, compute_dtype=jnp.float32,
                                                               **NARROW))
    return PC.PoseCNNConfig


def test_diag_rot_matches_jax(lov_data, narrow_configs, tmp_path, monkeypatch):
    """Both tools on one narrow snapshot (the port's seeded weights, a light
    snapshot), frame v4/000000: the same keys; each arm's rotation errors
    within 1e-3 degrees and translation errors within 1e-6 m of JAX's, its
    counts equal; the GT arm votes on GT labels (z error ~0)."""
    from posecnn_torch.core.checkpoint import save_checkpoint
    from posecnn_torch.core.convert import init_params_numpy, make_model
    from posecnn_torch.engine import train as T

    cfg = narrow_configs(num_classes=22, is_train=False, vertex_reg=True, pose_reg=True)
    state = T.create_train_state(make_model(cfg, init_params_numpy(2, cfg), "cpu"), T.TrainHParams())
    snap = save_checkpoint(str(tmp_path / "snap"), state, 1, prefix="narrow", include_opt_state=False)
    args = ["--model", snap, "--frames", "1", "--imdb", "lov_syn_val_v4", "--device", "cpu"]
    assert _port_tool(diag_rot, args + ["--out", str(tmp_path / "port.json")])[0] == 0
    monkeypatch.setattr(jax, "jit", lambda f, *a, **k: f)  # the JAX tool's network, unjitted
    _jax_tool("diag_rot", args + ["--out", str(tmp_path / "jax.json")])
    got, ref = (json.loads((tmp_path / f"{s}.json").read_text()) for s in ("port", "jax"))
    assert sorted(got) == sorted(ref) and got["frames"] == ref["frames"] == 1
    for arm in ("gt_hough", "pred_hough"):
        assert sorted(got[arm]) == sorted(ref[arm]) and got[arm]["n_rot"] == ref[arm]["n_rot"]
        for k, atol in (("rot_median_deg", 1e-3), ("rot_p90_deg", 1e-3), ("z_median_m", 1e-6), ("xy_median_m", 1e-6)):
            assert (got[arm][k] is None) == (ref[arm][k] is None), (arm, k)
            if ref[arm][k] is not None:
                assert abs(got[arm][k] - ref[arm][k]) <= atol, (arm, k, got[arm][k], ref[arm][k])
    assert got["gt_hough"]["n_rot"] > 0 and got["gt_hough"]["z_median_m"] < 1e-5


# the keys of a trajectory entry of tools/isolate_pose.py (`evaluate`, and
# `iter`; `loss_pose` after a step)
ISOLATE_KEYS = {"rot_median_deg", "rot_p90_deg", "add_mean_m", "z_median_m", "xy_median_m", "n_dets", "iter"}
# the port's report against the JAX tool's: loss_pose relative; the
# evaluations absolute (degrees, metres). Measured: loss_pose 1.1e-7, the
# rotation errors 5.4e-5 degrees, ADD 3.4e-9 m, xy 8.8e-9 m, z equal
ISOLATE_LIMITS = {"loss_pose": 1e-5, "rot_median_deg": 1e-3, "rot_p90_deg": 1e-3, "add_mean_m": 1e-6,
                  "z_median_m": 1e-6, "xy_median_m": 1e-6}


def test_isolate_pose_runs_on_a_tree(lov_data, narrow_configs, tmp_path, monkeypatch):
    """Both tools, 2 steps (batch 2) on 2 rendered scenes at narrow widths
    with roi pooling (the JAX tool's PoseCNNConfig defaults), from JAX's
    PRNGKey(3) weights (handed to the port through `init_params_numpy`);
    the JAX tool unjitted. The report's config and trajectory in the JAX
    tool's layout with its keys, evaluations at steps 0 and 2; loss_pose
    finite and within ISOLATE_LIMITS of JAX's, as are the evaluations;
    n_dets equal; step times."""
    from posecnn_torch.core import convert as PCV
    from posecnn_tpu.models.posecnn import init_posecnn_params

    def jax_weights(seed, cfg):
        import posecnn_tpu.models.posecnn as JP

        jcfg = JP.PoseCNNConfig(num_classes=cfg.num_classes, is_train=True, vertex_reg=True, pose_reg=True)
        return jax.tree_util.tree_map(np.asarray, init_posecnn_params(jax.random.PRNGKey(seed), jcfg))

    monkeypatch.setattr(PCV, "init_params_numpy", jax_weights)
    args = ["--iters", "2", "--frames", "2", "--report_every", "2", "--device", "cpu"]
    rc, out = _port_tool(isolate_pose, args + ["--out", str(tmp_path / "port")])
    assert rc == 0 and "eval @ 2:" in out
    # the JAX tool's step and inference unjitted (its host batch as jax arrays, as jit would take it)
    monkeypatch.setattr(jax, "jit", lambda f, *a, **k: lambda *args: f(*jax.tree_util.tree_map(jnp.asarray, args)))
    _jax_tool("isolate_pose", args + ["--out", str(tmp_path / "jax")])
    report, ref = (json.loads((tmp_path / s / "report.json").read_text()) for s in ("port", "jax"))
    assert report["config"] == ref["config"] == {"iters": 2, "frames": 2, "batch": 2, "lr": 0.001, "margin": 0.0001,
                                                 "hough_from_gt": True}
    traj, ref_traj = report["trajectory"], ref["trajectory"]
    assert [m["iter"] for m in traj] == [m["iter"] for m in ref_traj] == [0, 2]
    assert [set(m) for m in traj] == [set(m) for m in ref_traj]
    assert set(traj[0]) == ISOLATE_KEYS and all(set(m) == ISOLATE_KEYS | {"loss_pose"} for m in traj[1:])
    assert all(np.isfinite(m["loss_pose"]) and m["n_dets"] > 0 for m in traj[1:])
    for m, r in zip(traj, ref_traj):
        assert m["n_dets"] == r["n_dets"], (m, r)
        for k, lim in ISOLATE_LIMITS.items():
            if k not in r:
                continue
            assert (m[k] is None) == (r[k] is None), (m["iter"], k)
            if r[k] is not None:
                err = abs(m[k] - r[k]) / (abs(r[k]) if k == "loss_pose" else 1.0)
                assert err <= lim, (m["iter"], k, m[k], r[k])
    assert len(report["timing"]["step_ms"]) == 2


def test_analyze_z_on_port_detections(tmp_path):
    """tools/analyze_z.py on the port's and on JAX's detections of the same
    4 small frames (tests/test_torch_eval.py's frames, weights and test_net
    settings), written in test_net's detections.npz layout, against GT files
    of those frames: the two reports within 1e-3 relative (the poses agree
    to 1e-4), matching the same detections."""
    from posecnn_torch.config import PIXEL_MEANS
    from posecnn_torch.core.convert import make_model
    from posecnn_torch.data.imdb import YCB_SYMMETRIC_EVAL, PoseEvaluator
    from posecnn_torch.engine import test as PT
    from tests import test_torch_eval as E
    from tests.torch_parity import goldens, load_npz, slice_cfgs

    ref, _, _ = E._jax_test_net()
    g = load_npz(goldens().SLICE_GOLDEN)
    _, cfg = slice_cfgs(g, jnp.float32, torch.float32, use_crop_pool=True)
    data = E.SmallFrames()
    ev = PoseEvaluator(data.classes, data._extents, data._points, list(YCB_SYMMETRIC_EVAL))
    res = PT.test_net(make_model(cfg, E.cube_weights(g, cfg.num_classes), "cpu"), cfg, data, PIXEL_MEANS,
                      evaluator=ev, max_frames=E.N_EVAL_FRAMES, nms_threshold=0.3, log=None, pose_refine=True,
                      icp_plane_weight=1.0)
    val = tmp_path / "val"
    val.mkdir()
    for i in range(E.N_EVAL_FRAMES):
        f = data.load_frame(i)
        np.savez(val / f"{i:06d}.npz", cls_indexes=f.cls_indexes, poses=f.poses)
    reports = {}
    for who, results in (("port", res), ("jax", ref)):
        # test_net's layout (posecnn_torch/test_net.py, tools/test_net.py)
        arrays = {f"{fi:06d}_{k}": np.asarray(v) for fi, r in enumerate(results) for k, v in r.items()
                  if v is not None}
        np.savez_compressed(tmp_path / f"{who}.npz", **arrays)
        _jax_tool("analyze_z", ["--dets", str(tmp_path / f"{who}.npz"), "--val", str(val), "--out",
                                str(tmp_path / f"{who}.json")])
        reports[who] = json.loads((tmp_path / f"{who}.json").read_text())
    got, want = reports["port"], reports["jax"]
    assert got["n_matched"] == want["n_matched"] > 0 and got["verdict"] == want["verdict"]
    for k in ("xy_err_median_m", "z_err_median_m", "z_fit_slope", "z_fit_intercept_m", "z_gt_range_m",
              "z_pred_range_m", "z_signed_err_by_gt_decile"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-6, err_msg=k)


def _supervisor_cases():
    cases = []
    for cname, cls in vars(JAX_SUPERVISOR_TESTS).items():
        if cname.startswith("Test") and inspect.isclass(cls):
            cases += [(cname, m) for m in sorted(vars(cls)) if m.startswith("test_")]
    return cases


@pytest.mark.parametrize("cls,case", _supervisor_cases())
def test_supervisor_cases_through_port(cls, case, tmp_path):
    """Each case of tests/test_supervisor.py (the metrics row reader, the
    snapshot finder and its prefix filter, the run directory override, the
    SIGTERM-then-SIGKILL policy with real child processes) with the port's
    module as `sup`."""
    method = getattr(getattr(JAX_SUPERVISOR_TESTS, cls)(), case)
    kw = {"sup": supervise_train}
    if "tmp_path" in inspect.signature(method).parameters:
        kw["tmp_path"] = tmp_path
    method(**kw)


@pytest.mark.parametrize("cfg,network,want", [
    ("toy_pose.yml", "vgg16_convs", "vgg16_convs"),
    ("rgbd_scene_single_color_fcn8.yml", "vgg16_convs", "fcn8_vgg"),
    ("rgbd_scene_single_color_fcn8.yml", "resnet50", "resnet50"),
    ("lov_det.yml", "vgg16_convs", "vgg16_det"),
])
def test_supervisor_run_dir_is_train_nets(cfg, network, want):
    """run_meta_for: output/<EXP_DIR>/<imdb>/<network> as train_net names
    it, the cfg's SNAPSHOT_PREFIX and SNAPSHOT_ITERS."""
    from posecnn_torch.core import config as C

    path = os.path.join(ROOT, "experiments", "cfgs", cfg)
    c = C.cfg_from_file(path)
    out, prefix, every = supervise_train.run_meta_for(path, "toy_train", network, None)
    assert out == C.get_output_dir(c, "toy_train", want) and out.endswith(os.path.join("toy_train", want))
    assert (prefix, every) == (c.TRAIN.SNAPSHOT_PREFIX, c.TRAIN.SNAPSHOT_ITERS)
    assert supervise_train.run_dir_for(path, "toy_train", network, "/tmp/x") == "/tmp/x"
