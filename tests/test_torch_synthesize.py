"""The synthesis mix (TRAIN.SYNTHESIZE), cv2's resize, the input rescale
(TRAIN/TEST.SCALES_BASE) and the cfg-driven CLIs on the fixture trees,
against the JAX package.

- Host batches of lov_color_2d.yml, lov_depth_2d.yml, lov_rgbd_2d.yml and
  lov_single_color_synthesize.yml over a YCB-Video tree with a data_syn
  directory (`tests/torch_parity.py:write_lov_tree`), key for key and bit
  for bit against JAX's `GtSynthesizeLayer`, with backgrounds as PNG paths
  (sizes taking cv2's copy, area and bilinear paths) and as arrays in
  memory: real and synthetic batches, synthetic frames pasted over
  backgrounds; the rendered source (SYN_ONLINE) too.
- `utils.resize` against `cv2.resize`: INTER_NEAREST exact for every dtype;
  INTER_LINEAR exact for uint8 and for float32 of 2 or more than 4
  channels, and within 1e-6 of the image's largest magnitude for float32
  of 1, 3 or 4 (cv2 runs another loop there, module docstring of
  `utils/resize.py`). `scale_frame` equal to JAX's; TEST.SCALES_BASE
  through test_net against JAX's.
- `train_net --cfg lov_color_2d.yml --imdb lov_train` and
  `linemod_ape_pose.yml --imdb linemod_ape_train` on the CPU at narrow
  widths with finite losses; test_net on LINEMOD with its diameter
  threshold. A JPEG in ADAPT_ROOT or among the backgrounds raises.
"""

from __future__ import annotations

import dataclasses
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.data import factory as JF
from posecnn_tpu.data import layer as JL
from posecnn_tpu.data import minibatch as JM
from posecnn_tpu.data.imdb import PoseEvaluator as JaxEvaluator
from posecnn_tpu.data.synthetic import OfflineSynReader as JaxReader
from posecnn_tpu.data.synthetic import build_ycb_synthesizer as jax_synthesizer
from posecnn_tpu.engine import test as JT
from posecnn_torch import train_net
from posecnn_torch.config import PIXEL_MEANS
from posecnn_torch.core import config as C
from posecnn_torch.core.convert import make_model
from posecnn_torch.data import factory as F
from posecnn_torch.data import layer as L
from posecnn_torch.data import minibatch as M
from posecnn_torch.data.imdb import PoseEvaluator
from posecnn_torch.data.linemod import LINEMOD_DIAMETERS
from posecnn_torch.engine import test as PT
from posecnn_torch.utils.png import write_png
from posecnn_torch.utils.resize import INTER_LINEAR, INTER_NEAREST, resize
from tests.torch_parity import golden_weights, goldens, load_npz, slice_cfgs, v4_frame, write_lov_tree

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CFGS = os.path.join(ROOT, "experiments", "cfgs")
SYN_CFGS = {"lov_color_2d": "lov_train", "lov_depth_2d": "lov_train", "lov_rgbd_2d": "lov_train",
            "lov_single_color_synthesize": "lov_single_004_sugar_box_train"}
# background sizes: 1280x960 (cv2's area path at exactly 2), 640x480 (a
# copy), 500x375 and 97x61 (bilinear)
BG_SIZES = ((960, 1280), (480, 640), (375, 500), (61, 97))
N_BATCHES = 10


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A data root: the YCB-Video tree (16 frames, data_syn of 16) and
    backgrounds as PNG files under SUN2012/data/Images (COLOR, RGBD) and
    RGBD-Scenes (DEPTH)."""
    root = str(tmp_path_factory.mktemp("data"))
    write_lov_tree(root)
    rng = np.random.RandomState(11)
    for k, (h, w) in enumerate(BG_SIZES):
        for sub in (os.path.join("SUN2012", "data", "Images", f"s{k % 2}"), "RGBD-Scenes"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
            write_png(os.path.join(root, sub, f"bg{k}.png"), rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    return root


def _cfg(name: str, root: str, **train):
    return C.cfg_replace(C.cfg_from_file(os.path.join(CFGS, name + ".yml")),
                         TRAIN={"SYNROOT": os.path.join(root, "LOV", "data_syn"), "SYNNUM": 16, **train})


def _background_arrays():
    rng = np.random.RandomState(12)
    return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in BG_SIZES]


def _layers(cfg, imdb_name: str, root: str, backgrounds: str):
    """(JAX layer, port layer, [JAX syn calls, port syn calls]) as each
    package's train_net builds them; `backgrounds` "paths" (the bank under
    the data root) or "arrays"."""
    calls = [0, 0]
    a, b = JF.get_imdb(imdb_name), F.get_imdb(imdb_name)
    mcfg = C.minibatch_cfg(cfg, b.num_classes)
    jmcfg = JM.MinibatchConfig(**{f.name: getattr(mcfg, f.name) for f in dataclasses.fields(mcfg)})
    syn, bgs = train_net.synthetic_source(cfg, b, log=lambda m: None)
    T_ = cfg.TRAIN
    if T_.SYN_ONLINE:
        synth = jax_synthesizer(a, width=T_.SYN_WIDTH, height=T_.SYN_HEIGHT, t_near=T_.SYN_TNEAR, t_far=T_.SYN_TFAR)
        jsyn_raw = lambda i, rng: synth.render_scene(rng)  # noqa: E731
    else:
        reader = JaxReader(T_.SYNROOT, num=T_.SYNNUM)
        jsyn_raw = lambda i, rng: reader.load_frame((T_.SYNITER + rng.randint(reader.num)) % reader.num)  # noqa: E731
    jbgs = JL.build_background_paths(root, cfg.INPUT)
    assert jbgs == bgs and len(bgs) == len(BG_SIZES)
    if backgrounds == "arrays":
        jbgs, bgs = _background_arrays(), _background_arrays()

    def counted(fn, k):
        def call(i, rng):
            calls[k] += 1
            return fn(i, rng)
        return call

    kw = dict(ims_per_batch=T_.IMS_PER_BATCH, synthesize=True, syn_ratio=T_.SYN_RATIO, seed=cfg.RNG_SEED)
    return (JL.GtSynthesizeLayer(a, jmcfg, syn_frames=counted(jsyn_raw, 0), backgrounds=jbgs, **kw),
            L.GtSynthesizeLayer(b, mcfg, syn_frames=counted(syn, 1), backgrounds=bgs, **kw), calls)


def _assert_batches_equal(ja, pb, n: int) -> list:
    out = []
    for i in range(n):
        x, y = ja.forward(), pb.forward()
        assert sorted(x) == sorted(y), (i, sorted(x), sorted(y))
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape and np.array_equal(x[k], y[k]), (i, k)
        out.append(y)
    assert ja.rng.randint(1 << 30) == pb.rng.randint(1 << 30)  # the streams are in step
    return out


@pytest.mark.parametrize("backgrounds", ["paths", "arrays"])
@pytest.mark.parametrize("name", sorted(SYN_CFGS))
def test_synthesize_host_batches_bit_equal(tree, monkeypatch, name, backgrounds):
    """N_BATCHES host batches of each SYNTHESIZE cfg key for key against
    JAX's layer: both sources drawn, the synthetic frames pasted over the
    backgrounds (the batch's image differs from the data_syn frame)."""
    monkeypatch.setenv("POSECNN_DATA", tree)
    cfg = _cfg(name, tree)
    ja, pb, calls = _layers(cfg, SYN_CFGS[name], tree, backgrounds)
    ys = _assert_batches_equal(ja, pb, N_BATCHES)
    syn_batches = calls[1] // cfg.TRAIN.IMS_PER_BATCH
    assert calls[0] == calls[1] and 0 < syn_batches < N_BATCHES, calls
    assert ys[0]["data"].shape == (2, 480, 640, 3) and ys[0]["data"].dtype == np.uint8
    if name == "lov_color_2d":
        assert {"chroma_dhls", "noise_sigma", "gt_centers"} <= set(ys[0])


def test_lov_batch_golden_is_current_and_the_port_matches_it(tmp_path, monkeypatch):
    """tests/golden/torch_port_lov_batch.npz (JAX's first two host batches
    of lov_color_2d.yml on a tree without backgrounds) is what
    tools/make_torch_goldens.py makes now, and the port's train_net layer
    gives them (chip_smoke.py phase 15 (a) holds the card host to the same
    golden)."""
    from tests.torch_parity import check_lov_batch_golden, port_lov_batches

    G = goldens()
    ref = load_npz(G.LOV_BATCH_GOLDEN)
    new = G.lov_batch_golden()
    assert sorted(new) == sorted(ref) and all(np.array_equal(new[k], ref[k]) for k in ref)
    lov_root = write_lov_tree(str(tmp_path))
    monkeypatch.setenv("POSECNN_DATA", str(tmp_path))
    got = check_lov_batch_golden(port_lov_batches(lov_root), ref)
    assert got["arrays"] >= 14 and got["digests"] == 4


def test_synthesize_online_and_composite(tree, monkeypatch):
    """SYN_ONLINE: scenes rendered over lov("train")'s models in both
    packages, 8 batches bit-equal; and the composite itself: a data_syn
    frame over a 2x background is the area-averaged background with the
    frame's labelled pixels pasted in, as JAX's composite_background."""
    monkeypatch.setenv("POSECNN_DATA", tree)
    ja, pb, calls = _layers(_cfg("lov_color_2d", tree, SYN_ONLINE=True), "lov_train", tree, "arrays")
    _assert_batches_equal(ja, pb, 8)
    assert calls[0] == calls[1] > 0
    fr = v4_frame(20)
    for bg in _background_arrays():
        got = M.composite_background(fr.color, fr.label, bg)
        ref = JM.composite_background(fr.color, fr.label, bg)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


RESIZE_SHAPES = [(480, 640, 3), (37, 53, 3), (100, 77), (9, 5, 4), (960, 1280, 3), (3, 3, 2), (17, 30, 5)]
RESIZE_CASES = [dict(dsize=(640, 480)), dict(dsize=(50, 70)), dict(dsize=(641, 479)), dict(fx=0.5, fy=0.5),
                dict(fx=0.6, fy=0.6), dict(fx=1.25, fy=1.25), dict(fx=2.0, fy=2.0), dict(fx=0.33, fy=1.7)]


@pytest.mark.parametrize("shape", RESIZE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_resize_matches_cv2(shape):
    """uint8 bilinear and every nearest resize equal to cv2's; float32
    bilinear equal for 2 or 5 channels, within 1e-6 of the image's largest
    magnitude for 1, 3 and 4."""
    rng = np.random.RandomState(sum(shape))
    u8 = rng.randint(0, 256, shape).astype(np.uint8)
    f32 = rng.randn(*shape).astype(np.float32)
    for kw in RESIZE_CASES:
        ds, fx, fy = kw.get("dsize"), kw.get("fx", 0), kw.get("fy", 0)
        try:
            ref = cv2.resize(u8, ds, None, fx, fy, interpolation=cv2.INTER_LINEAR)
        except cv2.error:  # an empty result (3x3 at 0.33)
            with pytest.raises(ValueError, match="empty"):
                resize(u8, ds, fx, fy, INTER_LINEAR)
            continue
        got = resize(u8, ds, fx, fy, INTER_LINEAR)
        assert got.shape == ref.shape and got.dtype == ref.dtype and np.array_equal(got, ref), kw
        for a in (u8, u8.astype(np.uint16) * 257, u8.astype(np.int32) - 7, f32):
            assert np.array_equal(resize(a, ds, fx, fy, INTER_NEAREST),
                                  cv2.resize(a, ds, None, fx, fy, interpolation=cv2.INTER_NEAREST)), (kw, a.dtype)
        ref = cv2.resize(f32, ds, None, fx, fy, interpolation=cv2.INTER_LINEAR)
        got = resize(f32, ds, fx, fy, INTER_LINEAR)
        assert got.shape == ref.shape and got.dtype == np.float32
        if len(shape) == 3 and shape[2] in (2, 5):
            assert np.array_equal(got, ref), kw
        else:
            assert np.abs(got - ref).max() <= 1e-6 * np.abs(f32).max(), kw


@pytest.mark.parametrize("scale", [0.5, 0.75, 1.25])
def test_scale_frame_and_scaled_batches_match_jax(scale):
    """scale_frame of a frame with a mask and a vertmap equal to JAX's, and
    host batches of toy_pose.yml's settings at TRAIN.SCALES_BASE `scale`
    over two v4 frames bit-equal to JAX's get_minibatch (K scaled in
    meta_data)."""
    fr = dataclasses.replace(v4_frame(1), mask=(v4_frame(1).label % 3).astype(np.int32),
                             vertmap=np.random.RandomState(0).randn(480, 640, 3).astype(np.float32))
    jfr = JM.Frame(**{f.name: getattr(fr, f.name) for f in dataclasses.fields(fr)})
    got, ref = M.scale_frame(fr, scale), JM.scale_frame(jfr, scale)
    for f in ("color", "label", "depth", "mask", "vertmap", "center"):
        x, y = getattr(got, f), getattr(ref, f)
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), f
    mcfg = dataclasses.replace(M.MinibatchConfig(), scale=scale, device_targets=True, add_noise=True)
    jmcfg = JM.MinibatchConfig(**{f.name: getattr(mcfg, f.name) for f in dataclasses.fields(mcfg)})
    frames = [v4_frame(0), v4_frame(2)]
    jframes = [JM.Frame(**{f.name: getattr(x, f.name) for f in dataclasses.fields(x)}) for x in frames]
    x = JM.get_minibatch(jframes, jmcfg, None, None, None, rng=np.random.RandomState(4))
    y = M.get_minibatch(frames, mcfg, np.random.RandomState(4))
    assert sorted(x) == sorted(y)
    for k in x:
        assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


_JAX_SCALED = {}


@pytest.mark.parametrize("im_scale", [0.75])
def test_test_scales_base_matches_jax(im_scale):
    """test_net at TEST.SCALES_BASE 0.75 (96x128 frames scaled to 72x96,
    padded to 80x96, K scaled; the label map cropped and resized back, the
    boxes divided by the scale) on the small slice's weights, float32,
    against JAX's unjitted test_net: rois, poses and the label confusion."""
    from tests.test_torch_eval import SmallFrames

    g = load_npz(goldens().SLICE_GOLDEN)
    jcfg, cfg = slice_cfgs(g, jnp.float32, torch.float32, use_crop_pool=True)
    w = golden_weights(g)
    data = SmallFrames()
    if im_scale not in _JAX_SCALED:
        params = {}
        for k, v in w.items():
            _, layer, leaf = k.strip("[]'").split("']['")
            params.setdefault(layer, {})[leaf] = jnp.asarray(v)
        ev = JaxEvaluator(data.classes, data._extents, data._points, [])
        with jax.disable_jit():
            res = JT.test_net(params, jcfg, data, PIXEL_MEANS, evaluator=ev, max_frames=2, nms_threshold=0.3,
                              log=None, im_scale=im_scale)
        _JAX_SCALED[im_scale] = (res, ev.hist.copy())
    ref, ref_hist = _JAX_SCALED[im_scale]
    ev = PoseEvaluator(data.classes, data._extents, data._points, [])
    res = PT.test_net(make_model(cfg, w, "cpu"), cfg, data, PIXEL_MEANS, evaluator=ev, max_frames=2,
                      nms_threshold=0.3, log=None, im_scale=im_scale)
    assert sum(len(r["rois"]) for r in res) > 0
    for r, j in zip(res, ref):
        assert r["rois"].shape == j["rois"].shape
        np.testing.assert_array_equal(r["rois"][:, :2], j["rois"][:, :2])
        np.testing.assert_allclose(r["rois"], j["rois"], atol=1e-3)
        np.testing.assert_allclose(r["poses"], j["poses"], atol=1e-4)
    np.testing.assert_array_equal(ev.hist, ref_hist)


NARROW = dict(trunk_scale=0.125, fc_dim=64)


def _narrow(monkeypatch):
    for name in ("train_model_cfg", "test_model_cfg"):
        orig = getattr(C, name)
        monkeypatch.setattr(C, name, lambda cfg, n, _f=orig: dataclasses.replace(_f(cfg, n), **NARROW))


def test_train_net_synthesize_and_linemod_cli_on_cpu(tree, tmp_path, monkeypatch, capsys):
    """train_net --cfg lov_color_2d.yml (SYNROOT at the tree's data_syn,
    SYNNUM 16) --imdb lov_train --iters 2 and linemod_ape_pose.yml --imdb
    linemod_ape_train --iters 2 on the CPU at narrow widths: finite
    losses, a snapshot; test_net --imdb linemod_ape_test scores with
    ape's 0.1 x diameter threshold."""
    from posecnn_torch import test_net
    from tests.torch_parity import write_linemod_tree

    _narrow(monkeypatch)
    monkeypatch.setenv("POSECNN_DATA", tree)
    write_linemod_tree(tree, frames=range(2))
    cfg = tmp_path / "lov_color_2d.yml"
    cfg.write_text(open(os.path.join(CFGS, "lov_color_2d.yml")).read().replace(
        "  SYNNUM: 80000\n", f"  SYNNUM: 16\n  SYNROOT: {os.path.join(tree, 'LOV', 'data_syn')}\n"))
    assert C.unsupported(C.cfg_from_file(str(cfg))) == []
    out = tmp_path / "lov"
    assert train_net.main(["--cfg", str(cfg), "--imdb", "lov_train", "--iters", "2", "--device", "cpu",
                           "--output", str(out)]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if "iter 1/2" in ln][0]
    assert np.isfinite(float(line.split("loss_vertex: ")[1].split()[0]))
    assert (out / "vgg16_fcn_color_single_frame_2d_pose_add_iter_2.npz").exists()
    lm_cfg = os.path.join(CFGS, "linemod_ape_pose.yml")
    lm = tmp_path / "lm"
    assert train_net.main(["--cfg", lm_cfg, "--imdb", "linemod_ape_train", "--iters", "2", "--device", "cpu",
                           "--output", str(lm)]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if "iter 1/2" in ln][0]
    assert np.isfinite(float(line.split("loss_pose: ")[1].split()[0]))
    snap = lm / "vgg16_fcn_color_linemod_ape_pose_iter_2.npz"
    seen = []
    orig = PoseEvaluator.__init__

    def record(self, *a, **kw):
        seen.append(kw)
        orig(self, *a, **kw)

    monkeypatch.setattr(PoseEvaluator, "__init__", record)
    ev = tmp_path / "lm_eval"
    assert test_net.main(["--cfg", lm_cfg, "--imdb", "linemod_ape_test", "--model", str(snap), "--device", "cpu",
                          "--output", str(ev)]) == 0
    assert np.array_equal(seen[0]["diameters"], [0.0, LINEMOD_DIAMETERS[0]]) and seen[0]["flip_z_classes"] == []
    assert abs(LINEMOD_DIAMETERS[0] - 0.10209865663) < 1e-15
    assert json.loads((ev / "eval_timing.json").read_text())["frames"] == 2


def test_jpeg_adaptation_frames_and_backgrounds_are_refused(tree, tmp_path, monkeypatch):
    """A JPEG among ADAPT_ROOT's first ADAPT_NUM files raises before the
    first step, naming it; PNG frames there are read (unlabelled, BGR as
    cv2 reads them); a JPEG background in the bank raises when the source
    is built, and one drawn from a list given in memory when it is read."""
    adapt = tmp_path / "adapt"
    adapt.mkdir()
    im = np.random.RandomState(1).randint(0, 256, (24, 32, 3)).astype(np.uint8)
    write_png(str(adapt / "a.png"), im)
    cfg = C.cfg_replace(C.cfg_from_file(os.path.join(CFGS, "lov_color_sugar_box_adapt.yml")),
                        TRAIN={"ADAPT_ROOT": str(adapt), "ADAPT_NUM": 4})
    assert C.unsupported(cfg) == []
    f = train_net.adaptation_source(cfg)(0, np.random.RandomState(0))
    assert f.is_adaptation and np.array_equal(f.color, cv2.imread(str(adapt / "a.png"))) and not f.label.any()
    cv2.imwrite(str(adapt / "b.jpg"), im)
    with pytest.raises(NotImplementedError, match="b.jpg"):
        train_net.adaptation_source(cfg)
    root = tmp_path / "data"
    (root / "SUN2012" / "data" / "Images").mkdir(parents=True)
    cv2.imwrite(str(root / "SUN2012" / "data" / "Images" / "x.jpg"), im)
    monkeypatch.setenv("POSECNN_DATA", str(root))
    with pytest.raises(NotImplementedError, match="x.jpg"):
        train_net.synthetic_source(_cfg("lov_color_2d", tree), F.get_imdb("toy_train"), log=print)
    fr = dataclasses.replace(v4_frame(0), is_synthetic=True)
    with pytest.raises(NotImplementedError, match="x.jpg"):
        M.get_minibatch([fr], M.MinibatchConfig(device_targets=True), np.random.RandomState(0),
                        backgrounds=[str(root / "SUN2012" / "data" / "Images" / "x.jpg")])
