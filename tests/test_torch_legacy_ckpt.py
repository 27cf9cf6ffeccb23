"""The legacy weight readers and the orbax snapshot format of the port
(`posecnn_torch/core/checkpoint.py`, `core/tf1_bundle.py`,
`tools/convert_reference_ckpt.py`) against the JAX package's.

vgg16.npy, TF1 checkpoints (written by TensorFlow here, read by the port
without it) and `restore_partial` are merged into the same JAX-layout
numpy dict by both packages; the results must be bit-equal. The coverage
report of `convert_reference_ckpt` must equal JAX's. An orbax snapshot
written by JAX restores in the port and one written by the port restores in
JAX, full and light, with and without clipping: every array equal. The TF1
tests skip without TensorFlow, the orbax ones without tensorstore or orbax,
as `tests/test_checkpoint_converters.py` skips.
"""

import importlib.util
import os
import sys

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
from posecnn_torch.core.convert import init_params_numpy, params_to_numpy
from posecnn_torch.core.tf1_bundle import TF1Checkpoint
from posecnn_torch.tools import convert_reference_ckpt as PT_TOOL
from tests.test_torch_checkpoint import SMALL, _assert_nested_equal, _jax_trace, _port_state, _port_trace

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
NARROW = dict(num_classes=4, num_units=8, trunk_scale=0.125, fc_dim=64)


def _params(input_format="COLOR"):
    return init_params_numpy(0, PoseCNNConfig(input_format=input_format, **NARROW))


def _jax_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_vgg16_npy_matches_jax(tmp_path):
    """Each op's leaves land in its scope and its `_p` copy (RGBD's second
    trunk), a leaf of another shape and an unknown op are skipped, the rest
    keeps its values; bit-equal to JAX's load_vgg16_npy on the same dict."""
    params = _params("RGBD")
    rng = np.random.RandomState(0)
    npy = {name: {"weights": rng.randn(*params[name]["weights"].shape).astype(np.float32),
                  "biases": rng.randn(*params[name]["biases"].shape).astype(np.float32)}
           for name in ("conv1_1", "conv3_2", "fc7")}
    npy["fc8"] = {"weights": np.ones((4096, 1000), np.float32), "biases": np.ones(1000, np.float32)}
    npy["conv6"] = {"weights": np.ones((3, 3, 4, 4), np.float32)}
    path = str(tmp_path / "vgg16.npy")
    np.save(path, npy, allow_pickle=True)
    logged = []
    got = C.load_vgg16_npy(path, params, log=logged.append)
    ref = _jax_np(JC.load_vgg16_npy(path, params))
    _assert_nested_equal(got, ref)
    for scope in ("conv1_1", "conv1_1_p", "conv3_2", "conv3_2_p", "fc7"):
        np.testing.assert_array_equal(got[scope]["weights"], npy[scope.split("_p")[0]]["weights"])
    np.testing.assert_array_equal(got["fc8"]["weights"], params["fc8"]["weights"])
    np.testing.assert_array_equal(got["conv2_1"]["weights"], params["conv2_1"]["weights"])
    assert "conv1_1_p/weights assigned" in logged and any(m.startswith("skip fc8/weights") for m in logged)


def test_restore_partial_matches_jax():
    target = _params()
    source = {"conv1_1": {"weights": np.ones_like(target["conv1_1"]["weights"])},
              "fc6": {"weights": np.ones((3, 3), np.float32)}, "nope": {"weights": np.zeros(1, np.float32)}}
    got = C.restore_partial(source, target)
    _assert_nested_equal(got, _jax_np(JC.restore_partial(source, target)))
    assert got["conv1_1"]["weights"].all() and not np.array_equal(got["fc6"]["weights"], np.ones((3, 3)))


def _tf1():
    tf = pytest.importorskip("tensorflow").compat.v1
    tf.disable_eager_execution()
    return tf


def _write_tf1(tf, prefix: str, values: dict, extra=True) -> str:
    graph = tf.Graph()
    with graph.as_default():
        for name, v in values.items():
            scope, leaf = name.split("/", 1)
            with tf.variable_scope(scope, reuse=tf.AUTO_REUSE):
                tf.get_variable(leaf, initializer=v)
        if extra:
            tf.get_variable("global_step", initializer=np.int64(123))
            tf.get_variable("Variable", initializer=np.float32(0.0))
            tf.Variable(b"a string", name="note")
        saver = tf.train.Saver()
        with tf.Session() as sess:
            sess.run(tf.global_variables_initializer())
            return saver.save(sess, prefix)


def test_tf1_reader_matches_tensorflow_and_jax(tmp_path):
    """A Saver checkpoint written by TensorFlow: the bundle reader lists the
    same variables and shapes as TF's reader and reads every numeric one
    bit-equal (float32, int64, a scalar); load_tf1_checkpoint gives JAX's
    result (the Momentum slot, global_step, Variable, a 3-part name and a
    leaf of another shape skipped); a string tensor raises naming it."""
    import tensorflow as tf2

    tf = _tf1()
    params = _params()
    rng = np.random.RandomState(1)
    values = {f"{s}/{k}": rng.randn(*params[s][k].shape).astype(np.float32)
              for s, k in (("conv1_1", "weights"), ("conv1_1", "biases"), ("fc6", "weights"), ("score", "biases"))}
    values["conv1_1/weights/Momentum"] = np.full(params["conv1_1"]["weights"].shape, 9.0, np.float32)
    values["conv2_1/weights"] = np.zeros((1, 1, 3, 3), np.float32)  # another shape
    values["fc7/deep/weights"] = np.zeros((2,), np.float32)
    prefix = _write_tf1(tf, str(tmp_path / "model.ckpt"), values)
    ref_reader = tf2.train.load_checkpoint(prefix)
    reader = TF1Checkpoint(prefix)
    assert reader.shapes() == {k: tuple(v) for k, v in ref_reader.get_variable_to_shape_map().items()}
    for name in reader.shapes():
        if name == "note":
            with pytest.raises(NotImplementedError, match="note.*DT_STRING"):
                reader.get_tensor(name)
            continue
        a, b = reader.get_tensor(name), ref_reader.get_tensor(name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    got = C.load_tf1_checkpoint(prefix, params)
    _assert_nested_equal(got, _jax_np(JC.load_tf1_checkpoint(prefix, params)))
    for name in ("conv1_1/weights", "conv1_1/biases", "fc6/weights", "score/biases"):
        s, k = name.split("/")
        np.testing.assert_array_equal(got[s][k], values[name])
    np.testing.assert_array_equal(got["conv2_1"]["weights"], params["conv2_1"]["weights"])
    assert TF1Checkpoint(str(tmp_path)).prefix == prefix  # a directory: its `checkpoint` file's latest


def _jax_tool():
    tools = os.path.join(ROOT, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    spec = importlib.util.spec_from_file_location("jax_convert_reference_ckpt",
                                                  os.path.join(tools, "convert_reference_ckpt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_convert_reference_ckpt_matches_jax(tmp_path, monkeypatch):
    """JAX's tool fabricates the released variable inventory (narrow widths);
    the port's conversion of that file gives JAX's report and its merged
    values; a file with a missing and a mis-shaped variable fails in both;
    the port's CLI fabricates (with TF) and writes an npz of the values."""
    from posecnn_tpu.models.posecnn import init_posecnn_params

    import posecnn_torch.core.convert as CV

    tf = _tf1()
    jmod = _jax_tool()
    jparams = init_posecnn_params(jax.random.PRNGKey(0), JaxCfg(compute_dtype=jnp.float32, vertex_reg=True,
                                                                pose_reg=True, is_train=False, **NARROW))
    params = init_params_numpy(0, PoseCNNConfig(compute_dtype=torch.float32, vertex_reg=True, pose_reg=True,
                                                is_train=False, **NARROW))
    assert PT_TOOL.expected_reference_variables(params) == jmod.expected_reference_variables(jparams)
    ckpt, values = jmod.fabricate_reference_ckpt(str(tmp_path), jparams)
    merged, report = PT_TOOL.convert(ckpt, params)
    jmerged, jreport = jmod.convert(ckpt, jparams)
    assert report == jreport and report["ok"] and report["n_restored"] == len(values)
    for name in values:
        s, k = name.split("/")
        np.testing.assert_array_equal(merged[s][k], np.asarray(jmerged[s][k]))
        np.testing.assert_array_equal(merged[s][k], values[name])

    bad = _write_tf1(tf, str(tmp_path / "bad" / "bad.ckpt"),
                     {"conv1_1/weights": np.zeros((1, 1, 3, 64), np.float32)}, extra=False)
    _, report = PT_TOOL.convert(bad, params)
    _, jreport = jmod.convert(bad, jparams)
    assert report == jreport and not report["ok"] and report["shape_mismatch"] and report["missing_in_ckpt"]

    # the CLI draws the flagship's shapes: narrowed here
    orig = CV.init_params_numpy
    monkeypatch.setattr(CV, "init_params_numpy", lambda seed, cfg: orig(seed, PoseCNNConfig(
        **{**cfg.__dict__, "trunk_scale": 0.125, "fc_dim": 64})))
    out, fab = tmp_path / "conv.npz", tmp_path / "fab"
    fab.mkdir()
    assert PT_TOOL.main(["--fabricate", str(fab), "--out", str(out), "--num-classes", "4", "--num-units", "8"]) == 0
    with np.load(out) as d:
        assert int(d["['step']"]) == 160000
        np.testing.assert_array_equal(d["['params']['fc6']['weights']"],
                                      TF1Checkpoint(str(fab / "model.ckpt")).get_tensor("fc6/weights"))


def _orbax():
    pytest.importorskip("tensorstore")
    pytest.importorskip("orbax.checkpoint")


@pytest.mark.parametrize("clip", [10.0, 0.0], ids=["clip", "no_clip"])
@pytest.mark.parametrize("full", [True, False], ids=["full", "light"])
def test_jax_orbax_snapshot_restores_in_port(tmp_path, clip, full):
    _orbax()
    jcfg = JaxCfg(compute_dtype=jnp.float32, **SMALL)
    params, opt_state, _ = jax_create_train_state(jcfg, JaxHP(clip_grad_norm=clip), jax.random.PRNGKey(2))
    rng = np.random.RandomState(0)
    opt_state = jax.tree_util.tree_map(lambda x: jnp.asarray(rng.randn(*x.shape), x.dtype), opt_state)
    path = JC.save_checkpoint(str(tmp_path), (params, opt_state, jnp.asarray(11, jnp.int32)), step=11,
                              prefix="j", include_opt_state=full, fmt="orbax")
    assert os.path.isdir(path) and C.latest_checkpoint(str(tmp_path), "j") == path
    state = _port_state(seed=5, clip=clip)
    assert C.restore_checkpoint(path, state) is state and state.step == 11
    _assert_nested_equal(params_to_numpy(state.model.state_dict()), _jax_np(params))
    if full:
        _assert_nested_equal(_port_trace(state), _jax_np(_jax_trace(opt_state, clip)), skip_upscore=True)
    else:
        assert all(not t.any() for t in state.optimizer.trace)


@pytest.mark.parametrize("clip", [10.0, 0.0], ids=["clip", "no_clip"])
@pytest.mark.parametrize("full", [True, False], ids=["full", "light"])
def test_port_orbax_snapshot_restores_in_jax(tmp_path, clip, full):
    _orbax()
    state = _port_state(seed=3, clip=clip, step=7, trace_seed=1)
    path = C.save_checkpoint(str(tmp_path), state, step=7, prefix="p", include_opt_state=full, fmt="orbax")
    assert os.path.basename(path) == "p_iter_7" and os.path.isdir(path)
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".orbax-checkpoint-tmp")]
    jcfg = JaxCfg(compute_dtype=jnp.float32, **SMALL)
    target = jax_create_train_state(jcfg, JaxHP(clip_grad_norm=clip), jax.random.PRNGKey(1))
    params, opt_state, step = JC.restore_checkpoint(path, target)
    assert int(step) == 7
    _assert_nested_equal(_jax_np(params), params_to_numpy(state.model.state_dict()))
    trace = _jax_np(_jax_trace(opt_state, clip))
    if full:
        _assert_nested_equal(trace, _port_trace(state), skip_upscore=True)
    else:
        assert all(not a.any() for a in jax.tree_util.tree_leaves(trace))
    # the port reads its own back, and test_net's reader takes the directory
    fresh = _port_state(seed=9, clip=clip)
    C.restore_checkpoint(path, fresh)
    _assert_nested_equal(params_to_numpy(fresh.model.state_dict()), params_to_numpy(state.model.state_dict()))
    shapes = {k: {leaf: a.shape for leaf, a in v.items()} for k, v in params_to_numpy(state.model.state_dict()).items()
              if not k.startswith("upscore")}
    _assert_nested_equal(C.restore_params(path, shapes), {k: v for k, v in params_to_numpy(
        state.model.state_dict()).items() if not k.startswith("upscore")})


def test_orbax_prune_and_missing_tensorstore(tmp_path, monkeypatch):
    """Old orbax directories and interrupted writes are pruned as JAX prunes
    them; without tensorstore, fmt="orbax" and the config raise ImportError
    naming it."""
    _orbax()
    state = _port_state(seed=0, clip=10.0)
    for step in (1, 2, 3):
        C.save_checkpoint(str(tmp_path / "o"), state, step=step, prefix="s", max_to_keep=2, fmt="orbax")
    (tmp_path / "o" / "s_iter_4.orbax-checkpoint-tmp").mkdir()
    C._prune_old(str(tmp_path / "o"), "s", 2)
    assert sorted(os.listdir(tmp_path / "o")) == ["s_iter_2", "s_iter_3"]
    from posecnn_torch.core import config as CFG

    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        C.save_checkpoint(str(tmp_path / "o"), state, step=5, prefix="s", fmt="orbax")
    cfg = CFG.cfg_from_file(os.path.join(ROOT, "experiments", "cfgs", "toy_pose.yml"))
    cfg.TPU.CHECKPOINT_FORMAT = "orbax"
    with pytest.raises(ImportError, match="tensorstore"):
        CFG.train_model_cfg(cfg, 4)
    assert CFG.unsupported(cfg) == []


def test_tf1_golden_reads_as_its_twin():
    """The committed TF1 checkpoint (`tools/make_torch_goldens.py:
    write_tf1_golden`, which chip_smoke.py reads on the card, where there is
    no TensorFlow) reads bit-equal to its npz twin, and to TensorFlow's
    reader where TensorFlow is installed."""
    from tests.torch_parity import goldens

    G = goldens()
    reader = TF1Checkpoint(G.TF1_GOLDEN)
    with np.load(G.TF1_TWIN) as twin:
        assert set(twin.files) == set(G.TF1_VARS) <= set(reader.shapes())
        for name in twin.files:
            np.testing.assert_array_equal(reader.get_tensor(name), twin[name], err_msg=name)
    assert set(reader.shapes()) - set(G.TF1_VARS) == {"conv1_1/weights/Momentum", "global_step", "Variable"}
    tf2 = pytest.importorskip("tensorflow")
    ref = tf2.train.load_checkpoint(G.TF1_GOLDEN)
    for name in reader.shapes():
        np.testing.assert_array_equal(reader.get_tensor(name), ref.get_tensor(name), err_msg=name)
