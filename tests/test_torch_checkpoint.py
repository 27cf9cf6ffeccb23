"""Snapshots of the port (`posecnn_torch/core/checkpoint.py`) against the JAX
package's (`posecnn_tpu/core/checkpoint.py`), and the port's `Solver`:
snapshots, resume, the final-snapshot gate, the resume generator and
SIGTERM (ports of tests/test_train.py's solver tests).

A snapshot written by the port restores through JAX's `restore_checkpoint`
into `create_train_state` of the same small config, and a JAX snapshot
restores into the port, light (params and step) and full (with the
momentum trace), with and without clipping (the trace's key path differs).
Tolerance: none; every array must be equal after the layout conversion
(OIHW <-> HWIO, fc (out,in) <-> (in,out)), as float32 round trips exactly.
"""

import itertools
import os
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.core import checkpoint as JC
from posecnn_tpu.engine.train import TrainHParams as JaxHP
from posecnn_tpu.engine.train import create_train_state as jax_create_train_state
from posecnn_tpu.models.posecnn import PoseCNNConfig as JaxCfg
from posecnn_torch.config import PoseCNNConfig
from posecnn_torch.core import checkpoint as C
from posecnn_torch.core.convert import init_params_numpy, make_model, params_to_numpy
from posecnn_torch.engine import train as T

torch.set_num_threads(1)

SMALL = dict(num_classes=4, num_units=8, trunk_scale=0.125, fc_dim=64, is_train=True, use_crop_pool=True)


def _port_state(seed: int, clip: float, step: int = 0, trace_seed=None) -> T.TrainState:
    cfg = PoseCNNConfig(compute_dtype=torch.float32, **SMALL)
    state = T.create_train_state(make_model(cfg, init_params_numpy(seed, cfg), "cpu"),
                                 T.TrainHParams(clip_grad_norm=clip), step=step)
    if trace_seed is not None:
        g = torch.Generator().manual_seed(trace_seed)
        for t in state.optimizer.trace:
            t.copy_(torch.randn(t.shape, generator=g))
    return state


def _port_trace(state) -> dict:
    names = {id(p): n for n, p in state.model.named_parameters()}
    return params_to_numpy({names[id(p)]: t for p, t in zip(state.optimizer.params, state.optimizer.trace)})


def _jax_trace(opt_state, clip: float):
    return opt_state[1][0].trace if clip > 0 else opt_state[0].trace


def _assert_nested_equal(a: dict, b: dict, skip_upscore: bool = False):
    keys = {k for k in a if not (skip_upscore and k.startswith("upscore"))}
    assert keys == {k for k in b if not (skip_upscore and k.startswith("upscore"))}
    for layer in keys:
        assert set(a[layer]) == set(b[layer]), layer
        for leaf in a[layer]:
            np.testing.assert_array_equal(np.asarray(a[layer][leaf]), np.asarray(b[layer][leaf]), err_msg=layer)


@pytest.mark.parametrize("clip", [10.0, 0.0], ids=["clip", "no_clip"])
@pytest.mark.parametrize("full", [True, False], ids=["full", "light"])
def test_port_snapshot_restores_in_jax(tmp_path, clip, full):
    state = _port_state(seed=3, clip=clip, step=7, trace_seed=1)
    path = C.save_checkpoint(str(tmp_path), state, step=7, prefix="p", include_opt_state=full)
    assert os.path.basename(path) == "p_iter_7.npz"
    with np.load(path) as d:
        keys = set(d.files)
        assert d["['step']"].dtype == np.int32 and d["['step']"].shape == ()
    assert "['params']['conv1_1']['weights']" in keys and "['params']['upscore']['weights']" in keys
    trace_key = ("['opt_state'][1][0].trace" if clip else "['opt_state'][0].trace") + "['conv1_1']['weights']"
    assert (trace_key in keys) == full
    jcfg = JaxCfg(compute_dtype=jnp.float32, **SMALL)
    target = jax_create_train_state(jcfg, JaxHP(clip_grad_norm=clip), jax.random.PRNGKey(1))
    params, opt_state, step = JC.restore_checkpoint(path, target)
    assert int(step) == 7
    _assert_nested_equal(jax.tree_util.tree_map(np.asarray, params), params_to_numpy(state.model.state_dict()))
    trace = jax.tree_util.tree_map(np.asarray, _jax_trace(opt_state, clip))
    if full:
        _assert_nested_equal(trace, _port_trace(state), skip_upscore=True)
        assert all(not trace[k]["weights"].any() for k in trace if k.startswith("upscore"))
    else:  # a light snapshot keeps the target's fresh trace
        assert all(not a.any() for a in jax.tree_util.tree_leaves(trace))


@pytest.mark.parametrize("clip", [10.0, 0.0], ids=["clip", "no_clip"])
@pytest.mark.parametrize("full", [True, False], ids=["full", "light"])
def test_jax_snapshot_restores_in_port(tmp_path, clip, full):
    jcfg = JaxCfg(compute_dtype=jnp.float32, **SMALL)
    params, opt_state, _ = jax_create_train_state(jcfg, JaxHP(clip_grad_norm=clip), jax.random.PRNGKey(2))
    rng = np.random.RandomState(0)
    opt_state = jax.tree_util.tree_map(lambda x: jnp.asarray(rng.randn(*x.shape), x.dtype), opt_state)
    path = JC.save_checkpoint(str(tmp_path), (params, opt_state, jnp.asarray(11, jnp.int32)), step=11,
                              prefix="j", include_opt_state=full)
    state = _port_state(seed=5, clip=clip)
    assert C.restore_checkpoint(path, state) is state and state.step == 11
    _assert_nested_equal(params_to_numpy(state.model.state_dict()), jax.tree_util.tree_map(np.asarray, params))
    if full:
        _assert_nested_equal(_port_trace(state), jax.tree_util.tree_map(np.asarray, _jax_trace(opt_state, clip)),
                             skip_upscore=True)
    else:
        assert all(not t.any() for t in state.optimizer.trace)


def test_prune_and_stale_tmp_match_jax(tmp_path):
    """`_prune_old` keeps the newest max_to_keep of a prefix and removes
    stale `.npz.tmp` files, as JAX's does on the same directory; the latest
    snapshot ignores `.tmp` files and other prefixes."""
    listings = []
    for mod, name in ((C, "port"), (JC, "jax")):
        d = tmp_path / name
        d.mkdir()
        for f in ("s_iter_5.npz", "s_iter_40.npz", "s_iter_10.npz", "s_iter_20.npz", "s_iter_50.npz.tmp",
                  "t_iter_99.npz", "s_iter_x.npz", "notes.txt"):
            (d / f).write_bytes(b"")
        assert os.path.basename(mod.latest_checkpoint(str(d), "s")) == "s_iter_40.npz"
        mod._prune_old(str(d), "s", 2)
        listings.append(sorted(os.listdir(d)))
    assert listings[0] == listings[1] == ["notes.txt", "s_iter_20.npz", "s_iter_40.npz", "s_iter_x.npz",
                                          "t_iter_99.npz"]
    assert C.latest_checkpoint(str(tmp_path / "missing"), "s") is None
    state = _port_state(seed=0, clip=10.0)
    for step in (1, 2, 3):
        C.save_checkpoint(str(tmp_path / "real"), state, step=step, prefix="s", max_to_keep=2)
    assert sorted(os.listdir(tmp_path / "real")) == ["s_iter_2.npz", "s_iter_3.npz"]
    # npz and orbax are the formats (orbax: tests/test_torch_legacy_ckpt.py)
    with pytest.raises(ValueError, match="npz or orbax"):
        C.save_checkpoint(str(tmp_path), state, step=1, fmt="zip")


def _toy_step(record: list, sleep: float = 0.0):
    """A step for the Solver tests: records one draw and moves the step
    counter (the model is the small PoseCNN, which the snapshots hold)."""

    def step(state, batch, draws):
        record.append(float(draws.uniform("u", (1,), batch["data"].device)))
        state.step += 1
        if sleep:
            time.sleep(sleep)
        return {"loss": torch.tensor(1.0)}

    return step


BANK = {"data": torch.zeros((1, 2, 2, 3), dtype=torch.uint8)}


def test_solver_resume_roundtrip(tmp_path):
    """snapshot -> resume restores the parameters, the trace and the step
    (tests/test_train.py:223)."""
    solver = T.Solver(_toy_step([]), output_dir=str(tmp_path), snapshot_iters=10**9, display=10**9)
    state = _port_state(seed=0, clip=10.0, step=7, trace_seed=4)
    solver.snapshot(state, 7)
    fresh = _port_state(seed=1, clip=10.0)
    lines = []
    restored, start = solver.resume(fresh, log=lines.append)
    assert start == 7 and restored.step == 7 and lines and "at iteration 7" in lines[0]
    for (k, a), b in zip(state.model.state_dict().items(), restored.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(state.optimizer.trace, restored.optimizer.trace):
        assert torch.equal(a, b)
    assert T.Solver(_toy_step([]), output_dir=str(tmp_path / "empty")).resume(_port_state(0, 10.0), log=None)[1] == 0


def test_solver_snapshot_final_gate(tmp_path):
    """snapshot_final=False skips the end-of-run snapshot; the default
    writes it when the run does not end on a periodic one; a light
    snapshot has no trace (tests/test_train.py:362)."""
    for final, expect in ((False, []), (True, ["s_iter_3.npz"])):
        out = tmp_path / f"final_{final}"
        solver = T.Solver(_toy_step([]), output_dir=str(out), snapshot_iters=2, snapshot_prefix="s",
                          display=10**9, snapshot_final=final, snapshot_opt_state=False)
        solver.train(itertools.repeat(BANK), _port_state(0, 10.0), 3, log=None, handle_signals=False)
        assert sorted(f for f in os.listdir(out) if "iter_" in f) == sorted(["s_iter_2.npz"] + expect)
    with np.load(out / "s_iter_3.npz") as d:
        assert int(d["['step']"]) == 3 and not any(k.startswith("['opt_state']") for k in d.files)


def test_solver_resume_generator_is_deterministic_and_fresh():
    """The step generator is seeded from (seed, start_iter): the same draws
    for the same resume point, other draws than step 0's after a resume
    (the counterpart of JAX's fold_in, tests/test_train.py:639-644)."""
    runs = {}
    for start in (0, 5, 5, 6):
        rec = []
        T.Solver(_toy_step(rec)).train(itertools.repeat(BANK), _port_state(0, 10.0, step=start), start + 3, log=None,
                                       start_iter=start, handle_signals=False)
        runs.setdefault(start, []).append(rec)
    assert runs[5][0] == runs[5][1]
    assert runs[0][0] != runs[5][0] and runs[5][0] != runs[6][0]
    assert T.resume_seed(3, 0) == 3
    ref = torch.Generator().manual_seed(3)
    assert runs[0][0][0] == float(torch.rand((1,), generator=ref))


def test_solver_logs_display_rows_and_metrics_csv(tmp_path):
    """A log line at a run's first step and every `display` steps; the
    metrics CSV gets a row (step first) only at display steps."""
    lines = []
    T.Solver(_toy_step([]), output_dir=str(tmp_path), display=2, snapshot_final=False).train(
        itertools.repeat(BANK), _port_state(0, 10.0), 5, log=lines.append, handle_signals=False)
    assert [ln.split()[1] for ln in lines] == ["1/5", "2/5", "4/5"]
    rows = (tmp_path / "train_metrics.csv").read_text().splitlines()
    assert rows[0].startswith("step,time,loss,sec_per_iter") and [r.split(",")[0] for r in rows[1:]] == ["2", "4"]


def test_solver_sigterm_snapshot_survives_broken_log(tmp_path):
    """A SIGTERM whose log pipe is already broken still writes the snapshot
    at the step reached, and the old handler comes back
    (tests/test_train.py:311)."""

    def broken_log(msg):
        raise BrokenPipeError(32, "Broken pipe")

    before = signal.getsignal(signal.SIGTERM)
    rec = []
    timer = threading.Timer(0.3, lambda: os.kill(os.getpid(), signal.SIGTERM))
    timer.start()
    try:
        state, _ = T.Solver(_toy_step(rec, sleep=0.01), output_dir=str(tmp_path), display=1,
                            snapshot_prefix="s").train(itertools.repeat(BANK), _port_state(0, 10.0), 10**6,
                                                       log=broken_log)
    finally:
        timer.cancel()
    snaps = [f for f in os.listdir(tmp_path) if "iter_" in f]
    assert snaps == [f"s_iter_{state.step}.npz"] and 0 < state.step < 10**6 and len(rec) == state.step
    assert signal.getsignal(signal.SIGTERM) == before


def test_flagship_solver_settings_match_the_capstone():
    """FLAGSHIP_SOLVER and EXP_DIR against experiments/cfgs/lov_syn_capstone.yml
    read by the JAX package's config loader (the Solver arguments of
    tools/train_net.py:282-300)."""
    from posecnn_tpu.core.config import cfg_fresh
    from posecnn_torch.config import EXP_DIR, FLAGSHIP_SOLVER, RNG_SEED
    from tests.torch_parity import goldens

    c = cfg_fresh(f"{goldens().ROOT}/experiments/cfgs/lov_syn_capstone.yml")
    assert FLAGSHIP_SOLVER == dict(
        snapshot_iters=c.TRAIN.SNAPSHOT_ITERS, snapshot_prefix=c.TRAIN.SNAPSHOT_PREFIX,
        snapshot_opt_state=c.TPU.CHECKPOINT_OPT_STATE, snapshot_final=c.TRAIN.SNAPSHOT_FINAL, display=c.TRAIN.DISPLAY,
        snapshot_format=c.TPU.CHECKPOINT_FORMAT,
    )
    assert EXP_DIR == c.EXP_DIR and RNG_SEED == c.RNG_SEED and c.TPU.CHECKPOINT_FORMAT == "npz"
