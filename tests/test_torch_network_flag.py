"""`--network vgg16` (and any flag outside vgg16_det, resnet50, fcn8_vgg and
vgg16_full) trains and scores PoseCNN in both packages' CLIs.

JAX's `tools/train_net.py:83-105` and `tools/test_net.py:60-109` branch on
those four names alone and build PoseCNN for any other; the run directory
keeps the flag's name (`get_output_dir(imdb, net_name)`). Both packages run
toy_pose.yml on the CPU at narrow widths (the JAX config's PoseCNNConfig and
the port's builders with trunk_scale 0.125, fc_dim 64), each under a
ROOT_DIR of its own, and must end with the same run directory. JAX's CLIs
run in a process of their own.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import pytest

from posecnn_torch.core import config as C

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOOLS = os.path.join(ROOT, "tools")
TOY_CFG = os.path.join(ROOT, "experiments", "cfgs", "toy_pose.yml")
NARROW = dict(trunk_scale=0.125, fc_dim=64)


# runs tools/<name>.py as a script on one CPU device (the suite's 8 virtual
# devices would split the toy batch of 2 over a data axis of 8), with JAX's
# PoseCNNConfig narrowed
_JAX_DRIVER = """
import runpy, sys
import jax
jax.config.update("jax_platforms", "cpu")
import posecnn_tpu.models.posecnn as JP
orig = JP.PoseCNNConfig
JP.PoseCNNConfig = lambda **kw: orig(**{**kw, **%r})
sys.argv = sys.argv[1:]
sys.path.insert(0, %r)
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def _jax_cli(name: str, argv) -> str:
    """stdout of `tools/<name>.py argv` in a process of its own."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    out = subprocess.run([sys.executable, "-c", _JAX_DRIVER % (NARROW, TOOLS), os.path.join(TOOLS, f"{name}.py"),
                          *argv], cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _dirs(root: str) -> set:
    """The directories under root/output, relative to root."""
    return {os.path.relpath(d, root) for d, _, _ in os.walk(os.path.join(root, "output"))}


def test_network_vgg16_trains_and_scores_posecnn_in_both_clis(tmp_path, monkeypatch):
    from posecnn_torch import test_net, train_net

    for name in ("train_model_cfg", "test_model_cfg"):
        f = getattr(C, name)
        monkeypatch.setattr(C, name, lambda cfg, n, _f=f: dataclasses.replace(_f(cfg, n), **NARROW))
    roots = {}
    for pkg in ("jax", "port"):
        roots[pkg] = str(tmp_path / pkg)
        cfg = tmp_path / f"toy_{pkg}.yml"
        cfg.write_text(open(TOY_CFG).read() + f"ROOT_DIR: {roots[pkg]}\n")
        train = ["--cfg", str(cfg), "--network", "vgg16", "--iters", "1"]
        test = ["--cfg", str(cfg), "--network", "vgg16", "--imdb", "toy_val", "--max_frames", "1"]
        if pkg == "jax":
            assert "done solving" in _jax_cli("train_net", train + ["--imdb", "toy_train"])
            _jax_cli("test_net", test)
        else:
            assert train_net.main(train + ["--device", "cpu"]) == 0
            assert test_net.main(test + ["--device", "cpu"]) == 0
    run = os.path.join("output", "toy", "toy_train", "vgg16")
    assert run in _dirs(roots["jax"])
    assert _dirs(roots["port"]) == _dirs(roots["jax"])
    assert os.path.exists(os.path.join(roots["port"], run, "caffenet_fast_rcnn_iter_1.npz"))
    for pkg in roots:
        assert os.path.exists(os.path.join(roots[pkg], "output", "toy", "toy_val", "vgg16", "eval_summary.json"))


@pytest.mark.parametrize("flag", ["vgg16", "vgg16_3d", "vgg16_gan", "dcgan"])
def test_run_dir_keeps_the_flag(flag):
    from posecnn_torch.train_net import run_dir_name

    cfg = C.cfg_from_file(TOY_CFG)
    assert C.pick_network(cfg.NETWORK, flag) == "vgg16_convs"
    assert run_dir_name(cfg, flag) == flag
