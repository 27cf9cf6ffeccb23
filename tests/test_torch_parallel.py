"""The port's data and tensor parallelism (`posecnn_torch/parallel/`, the
mesh step of `engine/train.py`) against the one-process step and against
the JAX package's sharded step.

Ranks are subprocesses over gloo (`parallel.launch.run_ranks`, the workers
of `tests/torch_parallel_worker.py`), which import torch and posecnn_torch
only and check that no jax module was loaded. The JAX side runs in this
process on the conftest's 8 CPU devices. Sizes are tests/test_multihost.py's:
C=4, 32x32, trunk_scale 0.25, fc 64, float32, Hough on the GT labels,
`live_pose_batch` scenes of 4 images; two steps on one batch.

Tolerances: the port at a mesh against the port's one-process step on the
global batch (sums in another order only): loss terms and the gradient
norm within 1e-5 relative, parameters after both steps within 1e-5 of
each tensor's largest magnitude. Against JAX's sharded step, those of the
one-device parity test (tests/test_torch_train.py): loss terms within 1e-5
relative, parameters within 2e-5 of their largest move plus two f32 ulps.
"""

import ast
import dataclasses
import inspect
import json
import os
import re
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_torch.parallel import launch
from posecnn_torch.parallel import mesh as M
from tests import torch_parallel_worker as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY_CFG = os.path.join(ROOT, "experiments", "cfgs", "toy_pose.yml")
# each launch's time limit (a rank that fails stops the others), and the
# limit of all of this file's launches together, from its first test on
RANK_TIMEOUT, FILE_TIMEOUT = 300, 600
LOSS_RTOL, PARAM_TOL = 1e-5, 1e-5
_DEADLINE = []

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _file_deadline():
    _DEADLINE.append(time.monotonic() + FILE_TIMEOUT)
    yield
    _DEADLINE.clear()


def _time_left():
    left = min(RANK_TIMEOUT, _DEADLINE[0] - time.monotonic())
    assert left > 0, f"this file's launches passed their {FILE_TIMEOUT} s"
    return left


def _ranks(argv, n, out, on_start=None):
    logs = [os.path.join(out, f"rank{r}.log") for r in range(n)]
    rcs = launch.run_ranks(["-m", "tests.torch_parallel_worker", *argv], n, logs=logs, timeout=_time_left(),
                           cwd=ROOT, on_start=on_start)
    texts = [open(p).read() for p in logs]
    assert rcs == [0] * n, f"ranks exited {rcs}:\n" + "\n".join(t[-3000:] for t in texts)
    return texts


@pytest.fixture(scope="module")
def world_runs(tmp_path_factory):
    """The steps workers at world 2 and world 4: {case: npz} and the dirs."""
    out = {}
    for world in (2, 4):
        d = str(tmp_path_factory.mktemp(f"world{world}"))
        _ranks(["steps", d], world, d)
        out[world] = d
    return out


def _result(world_runs, name):
    """(the first step's terms, the parameters after the steps as
    {'layer/leaf': array}) of a case's mesh run."""
    with np.load(os.path.join(world_runs[W.CASES[name][0]], f"{name}.npz")) as d:
        losses = {k[5:]: float(d[k]) for k in d.files if k.startswith("loss/")}
        params = {k[len("param/"):]: d[k] for k in d.files if k.startswith("param/")}
    return losses, params


_ONE = {}


def _one_process(name):
    """The port's one-process step on the case's global batch."""
    if name not in _ONE:
        losses, _, params, _ = W.run_steps(name)
        _ONE[name] = (losses, W.flat_params(params))
    return _ONE[name]


def _param_errors(got, ref):
    return {k: float(np.abs(got[k] - a).max()) / max(float(np.abs(a).max()), 1e-30) for k, a in ref.items()}


def _check_against_one_process(name, world_runs):
    losses, params = _result(world_runs, name)
    ref_losses, ref_params = _one_process(name)
    assert set(losses) == set(ref_losses)
    rel = {k: abs(losses[k] - v) / max(abs(v), 1e-12) for k, v in ref_losses.items()}
    bad = {k: v for k, v in rel.items() if v > LOSS_RTOL}
    assert not bad, f"{name}: loss terms / grad norm off: {bad} ({losses} vs {ref_losses})"
    err = _param_errors(params, ref_params)
    worst = max(err, key=err.get)
    assert err[worst] <= PARAM_TOL, f"{name}: parameter {worst} off by {err[worst]:.3g} of its largest magnitude"
    return losses


@pytest.mark.parametrize("name", ["dp", "tp", "mesh22", "dp_draws", "dp_cut", "dp_gtany", "full_dp", "full_tp",
                                  "full_draws", "full_mesh22", "match_dp", "video_dp"])
def test_mesh_step_equals_one_process_step(name, world_runs):
    """The step at (2,1), at (1,2) with clipping, at
    (2,2) with clipping, with dropout and the noise field drawn at the
    global shape, with the global max_gt cut dropping image 3's GT row
    (rank 1 keeps image 2's row at local index 0), and with GT rows on rank
    0's images only (the adaptation head: Hough's batch-wide domains stay
    0 on rank 1), equals the one-process step on the global batch. So do
    VGG16FULL's step at (2,1), (1,2) and (2,2) and with its dropout draws
    split by image, the step with TRAIN.MATCHING over images of four
    intrinsics (every rank renders with the global batch's first image's),
    and the video step at (2,1) (the batch split over its second axis)."""
    losses = _check_against_one_process(name, world_runs)
    if name == "video_dp":
        assert losses["loss_cls"] > 0 and "loss_pose" not in losses
    elif name != "full_draws":  # dropout moves FULL's detections off the GT rows placed at them
        assert losses["loss_pose"] > 0
    if name == "dp_gtany":
        assert losses["loss_domain"] > 0
    if name == "match_dp":
        assert losses["loss_matching"] > 0
    if name in ("tp", "mesh22", "full_tp", "full_mesh22"):
        assert losses["grad_norm"] > W.HP.get("clip_grad_norm", 10.0)  # clipping was active


def test_mutant_gather_backward_fails_parity(world_runs):
    """A mutant: g's backward as a summing reduce-scatter (the slice of the model
    group's sum, as torch.distributed.nn's all_gather) scales each split
    gradient by the model axis's size; the one-process parity sees it."""
    losses, params = _result(world_runs, "tp_mutant")
    ref_losses, ref_params = _one_process("tp")
    assert abs(losses["grad_norm"] - ref_losses["grad_norm"]) / ref_losses["grad_norm"] > 0.1
    err = _param_errors(params, ref_params)
    assert max(err.values()) > 100 * PARAM_TOL, err
    # the unsplit layers upstream also move, through f's all-reduced dL/dx
    assert err["fc8/weights"] > PARAM_TOL and err["fc6/weights"] > PARAM_TOL


def test_matching_case_tells_the_first_images_apart():
    """The matching case's batch makes ROADMAP Queue 3 item 55 visible:
    the one-process loss_matching with rank 1's first image's intrinsics
    (image 2's) read for every row is more than 1e-3 apart from the one
    with the global first image's. So the mesh run, within 1e-5 of the
    one-process step (`test_mesh_step_equals_one_process_step[match_dp]`),
    read the global first image's on rank 1 too."""
    from posecnn_torch.config import PoseCNNConfig
    from posecnn_torch.engine import train as T

    cfg_kw, hp_kw, batch, points, symmetry, extents, params = W.case_inputs("match_dp")
    cfg, hp = PoseCNNConfig(compute_dtype=torch.float32, **cfg_kw), T.TrainHParams(**hp_kw)
    consts = [torch.from_numpy(a) for a in (points, symmetry, extents)]
    got = []
    for first in (0, 2):
        b = dict(batch, meta_data=batch["meta_data"].copy())
        b["meta_data"][0] = batch["meta_data"][first]
        model, _ = W._case_model("match_dp", cfg_kw, params, None)
        with torch.no_grad():
            _, terms = T.compute_losses(model, cfg, hp, T.to_device(b, "cpu"), *consts,
                                        T.Draws(torch.Generator().manual_seed(W.SEED)),
                                        points_raw=torch.from_numpy(W.case_points_raw("match_dp")))
        got.append(float(terms["loss_matching"]))
    assert got[0] > 0 and abs(got[0] - got[1]) > 1e-3 * got[0], got


def _jax_sharded(name):
    """JAX's make_train_step (VGG16FULL: with its forward and 0.7 gate; the
    video model: make_video_train_step) over MeshSpec(case's mesh) on the 8
    CPU devices: the first step's terms and the params after STEPS steps.
    With TRAIN.MATCHING, JAX's quaternion norm's gradient at zero is taken
    as 0 (`make_torch_goldens._quat2mat_zero_safe`; JAX's own is NaN on
    the rows without a class, ROADMAP Queue 3 item 57)."""
    import posecnn_tpu.ops.matching_loss as JML
    from posecnn_tpu.engine import train as JT
    from posecnn_tpu.models.posecnn import PoseCNNConfig as JCfg
    from posecnn_tpu.models.posecnn_full import posecnn_full_forward
    from posecnn_tpu.models.video import VideoConfig as JVCfg
    from posecnn_tpu.parallel import mesh as JM
    from tests.torch_parity import goldens

    _, (data, model), _, _, variant = W.CASES[name]
    cfg_kw, hp_kw, batch, points, symmetry, extents, params = W.case_inputs(name)
    raw = W.case_points_raw(name)
    JM.set_tp_min_size(W.TP_MIN)
    saved = JML.quat2mat
    JML.quat2mat = goldens()._quat2mat_zero_safe
    try:
        mesh = JM.make_mesh(JM.MeshSpec(data=data, model=model))
        hp = JT.TrainHParams(**hp_kw)
        p = jax.tree_util.tree_map(jnp.asarray, params)
        state = (p, JT.make_optimizer(hp).init(p), jnp.asarray(0, jnp.int32))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        if variant == "video":
            vstep = JT.make_video_train_step(JVCfg(compute_dtype=jnp.float32, **cfg_kw), hp, mesh)

            def step(st, b, _rng):
                return vstep(st, b)
        else:
            kw = dict(forward_fn=posecnn_full_forward, ce_threshold=0.7) if variant == "full" else {}
            step = JT.make_train_step(JCfg(compute_dtype=jnp.float32, **cfg_kw), hp, mesh, jnp.asarray(points),
                                      jnp.asarray(symmetry), jnp.asarray(extents), donate=False,
                                      points_raw=None if raw is None else jnp.asarray(raw), **kw)
        first = None
        for _ in range(W.STEPS):
            state, metrics = step(state, jb, jax.random.PRNGKey(0))
            if first is None:
                first = {k: float(v) for k, v in metrics.items()}
        return first, W.flat_params(jax.tree_util.tree_map(np.asarray, state[0])), W.flat_params(params)
    finally:
        JML.quat2mat = saved
        JM.set_tp_min_size(1 << 22)


@pytest.mark.parametrize("name", ["dp", "tp", "mesh22", "full_dp", "full_tp", "full_mesh22", "match_dp",
                                  "video_dp"])
def test_mesh_step_equals_jax_sharded_step(name, world_runs):
    """The port at (2,1), (1,2) and (2,2) against JAX's sharded
    step on the same MeshSpec, weights, batch and TP threshold: PoseCNN,
    VGG16FULL, PoseCNN with TRAIN.MATCHING, and the video model at (2,1)."""
    losses, params = _result(world_runs, name)
    jlosses, jparams, init = _jax_sharded(name)
    assert all(np.isfinite(v) for v in jlosses.values()), jlosses
    rel = {k: abs(losses[k] - v) / max(abs(v), 1e-12) for k, v in jlosses.items()}
    assert max(rel.values()) <= 1e-5, rel
    for k, a in params.items():
        ref, p0 = jparams[k], init[k]
        move = float(np.abs(ref - p0).max())
        ulp = 2 * float(np.abs(np.spacing(ref)).max())
        err = float(np.abs(a - ref).max())
        assert err <= 2e-5 * move + ulp, f"{name} {k}: {err:.3g} (move {move:.3g})"


def test_world2_snapshot_loads_in_jax_and_at_every_mesh(world_runs, tmp_path):
    """The (1,2) run's snapshot, gathered to rank 0 (tp_iter_2.npz),
    holds the whole parameters (the one-process step's within 1e-5), loads
    in JAX's restore_checkpoint key for key, back into a one-process port
    state bit-equal, and (in the workers) into a fresh (1,2) state whose
    rows equal the trained state's."""
    from posecnn_torch.config import PoseCNNConfig
    from posecnn_torch.core.checkpoint import restore_checkpoint
    from posecnn_torch.core.convert import make_model, params_to_numpy
    from posecnn_torch.engine import train as T
    from posecnn_tpu.core import checkpoint as JC
    from posecnn_tpu.engine import train as JT
    from posecnn_tpu.models.posecnn import PoseCNNConfig as JCfg

    d = world_runs[2]
    path = os.path.join(d, "tp_iter_2.npz")
    with open(os.path.join(d, "tp_restore.json")) as f:
        assert json.load(f)["split"]
    cfg_kw, hp_kw, *_, params = W.case_inputs("tp")
    with np.load(path) as z:
        files = {k: z[k] for k in z.files}
    _, ref = _one_process("tp")
    err = _param_errors({k: files["['params']" + "".join(f"['{p}']" for p in k.split("/"))] for k in ref}, ref)
    assert max(err.values()) <= PARAM_TOL, err
    # JAX reads it
    jstate = JT.create_train_state(JCfg(compute_dtype=jnp.float32, **cfg_kw), JT.TrainHParams(**hp_kw),
                                   jax.random.PRNGKey(0))
    restored = JC.restore_checkpoint(path, jstate)
    assert int(restored[2]) == W.STEPS
    for layer, leaves in restored[0].items():
        for leaf, a in leaves.items():
            assert np.array_equal(np.asarray(a), files[f"['params']['{layer}']['{leaf}']"]), (layer, leaf)
    # the port at world 1 reads it
    state = T.create_train_state(make_model(PoseCNNConfig(compute_dtype=torch.float32, **cfg_kw), params, "cpu"),
                                 T.TrainHParams(**hp_kw))
    restore_checkpoint(path, state)
    back = params_to_numpy(state.model.state_dict())
    assert state.step == W.STEPS
    for layer, leaves in back.items():
        for leaf, a in leaves.items():
            assert np.array_equal(a, files[f"['params']['{layer}']['{leaf}']"]), (layer, leaf)
    trace = [k for k in files if k.startswith("['opt_state'][1][0].trace")]
    assert trace and all(np.isfinite(files[k]).all() for k in trace)


def test_live_pose_batch_equals_jax():
    """The NumPy copy gives JAX's arrays for the same RandomState."""
    from posecnn_torch.utils.gate_batch import live_pose_batch
    from posecnn_tpu.utils.gate_batch import live_pose_batch as jax_live

    for with_aug in (True, False):
        got = live_pose_batch(4, 32, 32, 4, np.random.RandomState(0), with_aug=with_aug)
        ref = jax_live(4, 32, 32, 4, np.random.RandomState(0), with_aug=with_aug)
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert got[k].dtype == np.asarray(v).dtype and np.array_equal(got[k], np.asarray(v)), k


def _jax_split_layers(port_cfg, threshold, full=False):
    from posecnn_tpu.models.posecnn import PoseCNNConfig as JCfg
    from posecnn_tpu.models.posecnn import init_posecnn_params
    from posecnn_tpu.models.posecnn_full import init_posecnn_full_params
    from posecnn_tpu.parallel import mesh as JM

    kw = {f.name: getattr(port_cfg, f.name) for f in dataclasses.fields(port_cfg)}
    kw["compute_dtype"] = jnp.float32
    init = init_posecnn_full_params if full else init_posecnn_params
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), JCfg(**kw)))
    JM.set_tp_min_size(threshold)
    try:
        mesh = JM.make_mesh(JM.MeshSpec(data=4, model=2))
        split = set()
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
            spec = JM.param_sharding(mesh, jax.tree_util.keystr(path), leaf).spec
            if any(s is not None for s in spec):
                split.add(path[0].key)
    finally:
        JM.set_tp_min_size(1 << 22)
    return split


@pytest.mark.parametrize("which", ["flagship", "dryrun", "full"])
def test_param_sharding_picks_jax_set(which):
    """At a model axis of 2, the port splits the layers JAX splits:
    the flagship training config at 1 << 22 {fc6, fc7}; the dry run's
    (trunk_scale 0.125, fc 256) at 1 << 14 conv4_1-conv5_3, fc6, fc7;
    VGG16FULL's (lov_color_2d_full.yml) at 1 << 22 {fc6, fc7}."""
    from posecnn_torch.config import flagship_train_cfg
    from posecnn_torch.core import config as C
    from posecnn_torch.core.convert import _layer_name
    from posecnn_torch.models.posecnn import PoseCNN
    from posecnn_torch.models.posecnn_full import PoseCNNFull
    from posecnn_torch.parallel.dryrun import dryrun_config

    full_cfg = C.train_model_cfg(C.cfg_from_file(os.path.join(ROOT, "experiments", "cfgs", "lov_color_2d_full.yml")),
                                 22)
    cfg, threshold, want = {
        "flagship": (flagship_train_cfg()[0], 1 << 22, {"fc6", "fc7"}),
        "dryrun": (dryrun_config()[0], 1 << 14,
                   {"conv4_1", "conv4_2", "conv4_3", "conv5_1", "conv5_2", "conv5_3", "fc6", "fc7"}),
        "full": (full_cfg, 1 << 22, {"fc6", "fc7"}),
    }[which]
    M.set_tp_min_size(threshold)
    try:
        names = M.sharded_names((PoseCNNFull if which == "full" else PoseCNN)(cfg, device="meta"), M.Mesh(1, 2))
    finally:
        M.set_tp_min_size(1 << 22)
    port = {_layer_name(n.rsplit(".", 1)[0]) for n in names}
    assert all(n.endswith(".weight") for n in names)
    assert port == want == _jax_split_layers(cfg, threshold, full=which == "full")


def test_data_sharded_keys_are_the_steps_list():
    """The port's per-image keys are the JAX step's
    batch_shardings list (`engine/train.py:358-365`), not JAX's
    DATA_SHARDED_KEYS, which lacks noise_sigma and chroma_dhls and adds
    data_gan and gan_z."""
    from posecnn_tpu.engine import train as JT
    from posecnn_tpu.parallel import launch as JL

    src = inspect.getsource(JT.make_train_step)
    step_keys = ast.literal_eval(re.search(r"if k in (\([^)]*\)):", src).group(1))
    assert tuple(launch.DATA_SHARDED_KEYS) == tuple(step_keys) == M.BATCH_KEYS
    assert set(JL.DATA_SHARDED_KEYS) ^ set(step_keys) == {"noise_sigma", "chroma_dhls", "data_gan", "gan_z"}


def test_shard_batch_moves_pose_rows_to_local_images():
    """On the host: rank d keeps images d*b..(d+1)*b of the per-image
    blobs and the whole 'poses' table, column 0 less d*b."""
    from posecnn_torch.utils.gate_batch import live_pose_batch

    batch = live_pose_batch(4, 32, 32, 4, np.random.RandomState(0))
    for d in range(2):
        part = M.shard_batch(M.Mesh(2, 1, rank=d), batch)
        for k in M.BATCH_KEYS:
            if k in batch:
                assert np.array_equal(part[k], batch[k][2 * d:2 * d + 2]), k
        assert np.array_equal(part["poses"][:, 1:], batch["poses"][:, 1:])
        assert np.array_equal(part["poses"][:, 0], batch["poses"][:, 0] - 2 * d)
        assert launch.process_local_batch_size(M.Mesh(2, 1, rank=d), 4) == 2
        local = {k: v[2 * d:2 * d + 2] if k in launch.DATA_SHARDED_KEYS else v for k, v in batch.items()}
        assert np.array_equal(launch.global_batch_from_local(M.Mesh(2, 1, rank=d), local)["poses"], part["poses"])


def test_sigterm_to_one_rank_stops_both(tmp_path):
    """train_net --cfg toy_pose.yml at 2 ranks (narrow, float32); a
    SIGTERM sent to rank 1 alone, once rank 0 has logged step 1, stops both
    ranks after the same step, with one snapshot at that step."""
    out = str(tmp_path / "train")
    log0 = str(tmp_path / "rank0.log")

    def watch(procs):
        def run():
            t_end = time.monotonic() + _time_left()
            while time.monotonic() < t_end:
                if os.path.exists(log0) and re.search(r"iter 1/", open(log0).read()):
                    procs[1].send_signal(signal.SIGTERM)
                    return
                time.sleep(0.05)

        threading.Thread(target=run, daemon=True).start()

    _ranks(["train", out, "--cfg", TOY_CFG, "--iters", "1000", "--device", "cpu", "--output", out], 2,
           str(tmp_path), on_start=watch)
    with open(os.path.join(out, "train_timing.json")) as f:
        timing = json.load(f)
    end = timing["end_step"]
    snaps = sorted(n for n in os.listdir(out) if n.endswith(".npz"))
    assert 1 <= end < 50 and snaps == [f"caffenet_fast_rcnn_iter_{end}.npz"], (end, snaps)
    assert [r["end_step"] for r in timing["by_rank"]] == [end, end]
    assert timing["world_size"] == 2 and timing["mesh"] == {"data": 2, "model": 1}


# The limit on test_train_net_world2_equals_world1's snapshots: each rank runs the trunk at B=1 where the
# one-process run has B=2, and the CPU's convolutions sum in another order
# at another batch size (conv5_3 of this trunk at 96x128: 7.1e-7 of its
# largest magnitude apart, B=2 against 1 + 1; exact at 32x32, B=4 against
# 2 + 2, which the mesh-step cases use); ReLU and max-pool decisions near
# their thresholds carry that into the pose branch's gradients (measured:
# fc6's bias 3.55e-5, every trunk tensor below 1.5e-6)
TOY_PARAM_TOL = 1e-4


def test_train_net_world2_equals_world1(tmp_path):
    """train_net --cfg toy_pose.yml --iters 2 (narrow, float32; CHROMATIC,
    dropout at keep 0.5, GRAD_CLIP 10) at 2 ranks logs the one-process run's
    metrics (within 1e-5 relative) and ends in its snapshot (within
    TOY_PARAM_TOL of each tensor's largest magnitude); the metrics and the
    timing record come from rank 0 alone."""
    snaps, rows = {}, {}
    for n in (1, 2):
        out = str(tmp_path / f"w{n}")
        argv = ["train", out, "--cfg", TOY_CFG, "--iters", "2", "--device", "cpu", "--output", out]
        _ranks(argv, n, str(tmp_path)) if n > 1 else _single(argv, str(tmp_path))
        with np.load(os.path.join(out, "caffenet_fast_rcnn_iter_2.npz")) as z:
            snaps[n] = {k: z[k] for k in z.files}
        lines = open(os.path.join(out, "train_metrics.csv")).read().splitlines()
        assert len(lines) == 2 and lines[1].startswith("2,")
        rows[n] = dict(zip(lines[0].split(","), map(float, lines[1].split(","))))
    for k in ("loss_regu", "loss_cls", "loss_vertex", "loss_pose", "loss", "lr", "grad_norm"):
        assert abs(rows[2][k] - rows[1][k]) <= LOSS_RTOL * abs(rows[1][k]), (k, rows)
    assert set(snaps[1]) == set(snaps[2])
    for k, ref in snaps[1].items():
        err = float(np.abs(snaps[2][k] - ref).max()) / max(float(np.abs(ref).max()), 1e-30)
        assert err <= TOY_PARAM_TOL, (k, err)


def _single(argv, out):
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if not k.startswith("POSECNN_")}
    res = subprocess.run([sys.executable, "-m", "tests.torch_parallel_worker", *argv], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=_time_left())
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]


def test_dryrun_multichip_four_ranks(monkeypatch):
    """The multichip dry run at 4 ranks on gloo, mesh (2,2): one step,
    loss_pose > 0, the narrow trunk's conv4_1-conv5_3 and fc6, fc7 split."""
    from posecnn_torch.entry import dryrun_multichip

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # four ranks share the test's cores

    out = dryrun_multichip(4, device="cpu", timeout=_time_left())
    assert out["metrics"]["loss_pose"] > 0 and out["mesh"] == {"data": 2, "model": 2}
    assert out["backend"] == "gloo" and all(np.isfinite(v) for v in out["metrics"].values())
    assert {n.split(".")[-2] for n in out["split"]} == {"conv4_1", "conv4_2", "conv4_3", "conv5_1", "conv5_2",
                                                       "conv5_3", "fc6", "fc7"}


def test_device_bank_refused_at_two_ranks():
    """TPU.DEVICE_BANK at world size 2 raises, naming it;
    so do the networks whose step has no mesh (FCN-8s), not VGG16FULL;
    at one rank nothing does."""
    from posecnn_torch import train_net
    from posecnn_torch.core import config as C

    cfg = C.cfg_from_file(TOY_CFG)
    train_net.refuse_at_world(cfg, "vgg16_convs", 2)
    cfg.TPU.DEVICE_BANK = True
    train_net.refuse_at_world(cfg, "vgg16_convs", 1)
    with pytest.raises(ValueError, match="TPU.DEVICE_BANK"):
        train_net.refuse_at_world(cfg, "vgg16_convs", 2)
    cfg.TPU.DEVICE_BANK = False
    train_net.refuse_at_world(cfg, "vgg16_full", 2)  # VGG16FULL's step takes the mesh
    with pytest.raises(NotImplementedError, match="fcn8_vgg"):
        train_net.refuse_at_world(cfg, "fcn8_vgg", 2)


@pytest.mark.parametrize("env,error", [
    ({}, None),
    ({"POSECNN_NUM_PROCESSES": "1"}, None),
    ({"POSECNN_COORDINATOR": "localhost", "POSECNN_NUM_PROCESSES": "2", "POSECNN_PROCESS_ID": "0"}, "host:port"),
    ({"POSECNN_NUM_PROCESSES": "2", "POSECNN_PROCESS_ID": "0"}, "needs all of"),
    ({"POSECNN_COORDINATOR": "localhost:1234", "POSECNN_NUM_PROCESSES": "2", "POSECNN_PROCESS_ID": "2"}, "not in"),
])
def test_initialize(env, error, monkeypatch):
    """initialize() is a no-op with nothing set or one process, and
    raises on a malformed or partial setting (nothing falls back to one
    process)."""
    for k in (*launch.ENV_VARS, "POSECNN_BACKEND"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if error is None:
        assert launch.initialize() == 1
        assert not torch.distributed.is_initialized()
    else:
        with pytest.raises(ValueError, match=error):
            launch.initialize()


@pytest.mark.parametrize("cuda", [False, True])
def test_initialize_default_device(cuda, monkeypatch):
    """initialize() with the variables set and no `device` takes the rank's
    card: with no CUDA it raises rather than joining over gloo on the CPU;
    with CUDA it joins over NCCL on cuda:<local rank> (the join is recorded
    here, not made)."""
    for k in (*launch.ENV_VARS, "POSECNN_BACKEND", "POSECNN_LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("POSECNN_COORDINATOR", "localhost:29999")
    monkeypatch.setenv("POSECNN_NUM_PROCESSES", "2")
    monkeypatch.setenv("POSECNN_PROCESS_ID", "1")
    joined = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: joined.append(("set_device", str(d))))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: joined.append((backend, kw["rank"], kw["world_size"])))
    if not cuda:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.initialize()
        assert joined == [] and not torch.distributed.is_initialized()
    else:
        assert launch.initialize() == 2
        assert joined == [("set_device", "cuda:1"), ("nccl", 1, 2)]
    # the CPU when asked for: gloo
    joined.clear()
    assert launch.initialize(device="cpu") == 2
    assert joined == [("gloo", 1, 2)]
