"""TPU.DEBUG_NANS in the port (`posecnn_torch/utils/debug_nans.py`) against
JAX's `jax_debug_nans`: FloatingPointError where JAX raises (a NaN
constant, log(-1), a NaN in the backward, the video model's NaN-filled
start state when run eagerly), nothing on an inf or a finite step; the
calls JAX jits checked at their outputs, as JAX checks a jitted function
(the video train step raises nothing, in either); and
`train_net` / `test_net --cfg` with the setting on the CPU at narrow
widths, a toy run through both with no error.

JAX's flag is process-wide; each JAX check here turns it on and back off.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_torch.core import config as C
from posecnn_torch.utils.debug_nans import DebugNans, debug_nans

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOY_CFG = os.path.join(ROOT, "experiments", "cfgs", "toy_pose.yml")


def _jax_raises(fn) -> bool:
    jax.config.update("jax_debug_nans", True)
    try:
        fn()
        return False
    except FloatingPointError:
        return True
    finally:
        jax.config.update("jax_debug_nans", False)


def _port_raises(fn) -> bool:
    try:
        with debug_nans():
            fn()
        return False
    except FloatingPointError:
        return True


def _grad_sqrt_at_zero_jax():
    return jax.grad(lambda x: jnp.sum(jnp.sqrt(x) * 0.0))(jnp.zeros(2))


def _grad_sqrt_at_zero_port():
    x = torch.zeros(2, requires_grad=True)
    (torch.sqrt(x) * 0.0).sum().backward()


CASES = {
    # name: (JAX's function, the port's, whether both raise)
    "nan_constant": (lambda: jnp.full((2,), jnp.nan), lambda: torch.full((2,), float("nan")), True),
    "log_of_minus_one": (lambda: jnp.log(jnp.asarray(-1.0)), lambda: torch.log(torch.tensor(-1.0)), True),
    "zero_over_zero": (lambda: jnp.zeros(3) / jnp.zeros(3), lambda: torch.zeros(3) / torch.zeros(3), True),
    "inf_passes": (lambda: jnp.log(jnp.zeros(2)), lambda: torch.log(torch.zeros(2)), False),
    "finite": (lambda: jnp.exp(jnp.ones(4)) * 2, lambda: torch.exp(torch.ones(4)) * 2, False),
    "nan_in_backward": (_grad_sqrt_at_zero_jax, _grad_sqrt_at_zero_port, True),
    "integer_outputs": (lambda: jnp.arange(4) // 2, lambda: torch.arange(4) // 2, False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_raises_where_jax_raises(name):
    jf, pf, raises = CASES[name]
    assert _jax_raises(jf) == raises
    assert _port_raises(pf) == raises


def test_names_the_operation_and_skips_unwritten_allocations():
    with pytest.raises(FloatingPointError, match="aten.log"):
        with debug_nans():
            torch.log(torch.tensor([1.0, -1.0]))
    with debug_nans() as mode:
        torch.empty(1000)  # uninitialised memory: not a value
        torch.ones(3) + 1
    assert isinstance(mode, DebugNans) and mode.checked >= 2
    with debug_nans(False) as off:
        torch.full((1,), float("nan"))
    assert off is None


def test_video_start_state_raises_eagerly_as_in_jax():
    """The recurrent state starts with NaN points: JAX's eager
    init_video_state raises at its jnp.full, and so does the port's (its
    whole step runs eagerly; JAX's jitted video train step checks only its
    outputs and does not)."""
    from posecnn_tpu.models.video import init_video_state as jax_init
    from posecnn_torch.models.video import init_video_state

    assert _jax_raises(lambda: jax_init(1, 4, 4, 2))
    assert _port_raises(lambda: init_video_state(1, 4, 4, 2))


def test_jitted_calls_are_checked_at_their_outputs_as_jax():
    """A call the JAX package jits: a 0/0 that a select drops raises nothing,
    a NaN that reaches an output raises naming the first NaN operation;
    JAX's jit alike. The video train step (jitted in JAX, `jitted` in the
    port) starts from NaN points and raises nothing in either."""
    from posecnn_torch.engine import train as T
    from posecnn_torch.models import video as V
    from posecnn_torch.utils.debug_nans import jitted
    from tests.torch_parity import goldens

    def kept(x):
        return (x / x) * 2.0

    assert not _jax_raises(lambda: jax.jit(lambda x: jnp.where(x > 0, x / x, 0.0))(jnp.zeros(2)))
    assert _jax_raises(lambda: jax.jit(kept)(jnp.zeros(2)))
    assert not _port_raises(lambda: jitted(lambda x: torch.where(x > 0, x / x, 0.0), "f")(torch.zeros(2)))
    with pytest.raises(FloatingPointError, match=r"aten\.div.*the first NaN of g"):
        with debug_nans():
            jitted(kept, "g")(torch.zeros(2))
    G = goldens()
    cfg = V.VideoConfig(compute_dtype=torch.float32, **G.VIDEO_CFG)
    hp = T.TrainHParams(**G.VIDEO_HP)
    state = T.create_train_state(V.make_video_model(cfg, G.video_params(), "cpu"), hp)
    x = {k: torch.from_numpy(v) for k, v in G.video_inputs().items()}
    with debug_nans() as mode:
        out = T.make_video_train_step(cfg, hp)(state, x)
    assert np.isfinite(float(out["loss"])) and mode.checked > 100


def _narrow(monkeypatch):
    for name in ("train_model_cfg", "test_model_cfg"):
        orig = getattr(C, name)
        monkeypatch.setattr(C, name, lambda cfg, n, _f=orig: dataclasses.replace(_f(cfg, n), trunk_scale=0.125,
                                                                                 fc_dim=64))


def test_train_net_and_test_net_with_debug_nans(tmp_path, monkeypatch):
    """The config is no longer refused; a toy train_net (2 steps, forward and
    backward under the check) and test_net on its snapshot finish, the
    training record counting the outputs checked."""
    from posecnn_torch import test_net, train_net

    _narrow(monkeypatch)
    cfg = tmp_path / "toy_nans.yml"
    cfg.write_text(open(TOY_CFG).read() + "TPU:\n  DEBUG_NANS: True\n")
    assert C.unsupported(C.cfg_from_file(str(cfg))) == [] == C.unsupported(C.cfg_from_file(str(cfg)), train=False)
    out = tmp_path / "train"
    assert train_net.main(["--cfg", str(cfg), "--iters", "2", "--device", "cpu", "--output", str(out)]) == 0
    timing = json.loads((out / "train_timing.json").read_text())
    assert timing["end_step"] == 2 and timing["debug_nans_checked_outputs"] > 1000
    ev = tmp_path / "eval"
    assert test_net.main(["--cfg", str(cfg), "--imdb", "toy_val", "--max_frames", "1", "--device", "cpu",
                          "--model", str(out / "caffenet_fast_rcnn_iter_2.npz"), "--output", str(ev)]) == 0
    assert (ev / "eval_summary.json").exists()
