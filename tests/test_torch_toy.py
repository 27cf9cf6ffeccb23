"""The port's toy dataset, factory and host data pipeline against the JAX
package's (`posecnn_torch.data.{toy,factory,minibatch,layer}`).

Frames and batches must be bit-equal: the same `RandomState` draws in the
same order. Two quirks of the reference are held as they are: `toy_val`
is built like `toy_train` (same seed, so the same frames), and a flipped
roidb entry i >= 64 renders the new scene `load_frame(i)` and mirrors it.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import pytest

from posecnn_tpu.data import factory as JF
from posecnn_tpu.data import layer as JL
from posecnn_tpu.data import minibatch as JM
from posecnn_tpu.data.toy import toy as JaxToy
from posecnn_torch.core import config as C
from posecnn_torch.data import factory as F
from posecnn_torch.data import layer as L
from posecnn_torch.data import minibatch as M
from posecnn_torch.data.toy import toy as Toy

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FRAME_KEYS = ("color", "label", "depth", "cls_indexes", "poses", "center", "intrinsic_matrix", "factor_depth")


def assert_frames_equal(a, b, where=""):
    for k in FRAME_KEYS:
        x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), (where, k)


@pytest.mark.parametrize("split", ["train", "val"])
def test_toy_frames_bit_equal(split):
    """Every frame of toy_<split>, and the models, extents and K."""
    a, b = JaxToy(split), Toy(split)
    assert a.name == b.name and a.classes == b.classes and a.num_images == b.num_images == 64
    for k in ("_extents", "_symmetry", "_points_all", "_colors", "K"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert all(np.array_equal(x, y) for x, y in zip(a._points, b._points))
    for i in range(a.num_images):
        assert_frames_equal(a.load_frame(i), b.load_frame(i), i)


def test_toy_flipped_entries_bit_equal():
    """Frames 64..127, the flipped roidb entries, through flip_frame: new
    scenes, mirrored (colour, label, depth, centres, poses with fx -> -fx
    and cx -> W - cx)."""
    a, b = JaxToy("train"), Toy("train")
    for i in range(64, 128):
        fa, fb = a.load_frame(i), b.load_frame(i)
        assert_frames_equal(fa, fb, i)
        assert_frames_equal(JM.flip_frame(fa), M.flip_frame(fb), i)
    fb = b.load_frame(64)
    assert not np.array_equal(fb.color, b.load_frame(0).color[:, ::-1])  # not a mirror of frame 0
    ff = M.flip_frame(fb)
    assert np.array_equal(ff.color, fb.color[:, ::-1]) and np.array_equal(ff.center[:, 0], 128 - fb.center[:, 0])
    back = M.flip_frame(ff)  # mirroring twice gives the frame back
    np.testing.assert_allclose(back.poses, fb.poses, atol=1e-6)
    assert np.array_equal(back.color, fb.color) and not back.flipped


def test_factory_matches_jax(tmp_path, monkeypatch):
    """toy_train and toy_val as the JAX factory builds them: toy_val holds
    toy_train's frames; the port knows the JAX factory's names; an unknown
    name raises KeyError listing the known, and lov_train, known now,
    raises FileNotFoundError where no YCB-Video tree is under the data
    root."""
    assert F.list_imdbs() == JF.list_imdbs()
    assert {"lov_syn_val_v4", "toy_train", "toy_val", "lov_train"} <= set(F.list_imdbs())
    for name in ("toy_train", "toy_val"):
        a, b = JF.get_imdb(name), F.get_imdb(name)
        assert type(b).__name__ == "toy" and a.name == b.name and a.seed == b.seed == 0
        assert_frames_equal(a.load_frame(3), b.load_frame(3), name)
    assert_frames_equal(F.get_imdb("toy_val").load_frame(3), F.get_imdb("toy_train").load_frame(3))
    assert F.get_imdb("lov_syn_val_v4").num_images == 256
    with pytest.raises(KeyError, match="Known: \\['gmu_scene_train', "):
        F.get_imdb("lov_nothing")
    monkeypatch.setenv("POSECNN_DATA", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="points.xyz"):
        F.get_imdb("lov_train")


def test_append_flipped_images_matches_jax():
    a, b = JaxToy("train"), Toy("train")
    a.append_flipped_images()
    b.append_flipped_images()
    assert a.roidb == b.roidb and a.num_images == b.num_images == 128 and a.image_index == b.image_index
    assert [e["flipped"] for e in b.roidb] == [False] * 64 + [True] * 64


def _jax_mcfg(c, num_classes):
    return JM.MinibatchConfig(
        num_classes=num_classes, pixel_means=c.pixel_means(), scale=float(c.TRAIN.SCALES_BASE[0]),
        chromatic=c.TRAIN.CHROMATIC, add_noise=c.TRAIN.ADD_NOISE, vertex_reg=True, vertex_w_inside=10.0,
        max_gt=c.TPU.MAX_GT, device_targets=c.TPU.DEVICE_TARGETS, input_format=c.INPUT,
    )


def _layers(seed=3):
    cfg = C.cfg_from_file(os.path.join(ROOT, "experiments", "cfgs", "toy_pose.yml"))
    a, b = JaxToy("train"), Toy("train")
    a.append_flipped_images()
    b.append_flipped_images()
    ja = JL.GtSynthesizeLayer(a, _jax_mcfg(cfg, 4), ims_per_batch=cfg.TRAIN.IMS_PER_BATCH, seed=seed)
    pb = L.GtSynthesizeLayer(b, C.minibatch_cfg(cfg, 4), ims_per_batch=cfg.TRAIN.IMS_PER_BATCH, seed=seed)
    return ja, pb


def test_host_batches_bit_equal():
    """The first 8 batches of GtSynthesizeLayer under toy_pose.yml (flipped
    entries included, chromatic deltas drawn on the host), key by key."""
    ja, pb = _layers()
    flipped = 0
    for n in range(8):
        x, y = ja.forward(), pb.forward()
        assert sorted(x) == sorted(y) == ["chroma_dhls", "data", "gt_centers", "gt_label_2d", "meta_data", "poses"]
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape and np.array_equal(x[k], y[k]), (n, k)
        flipped += int((ja.stream._perm[ja.stream._cur - 2:ja.stream._cur] >= 64).sum())
    assert flipped > 0  # a flipped entry was among them
    assert y["data"].shape == (2, 96, 128, 3) and y["data"].dtype == np.uint8 and y["gt_centers"].shape == (2, 24, 4)
    assert ja.rng.randint(1 << 30) == pb.rng.randint(1 << 30)  # the streams are in step


def test_index_stream_matches_jax():
    a, b = JL.IndexStream(5, np.random.RandomState(1)), L.IndexStream(5, np.random.RandomState(1))
    for count in (2, 3, 4, 7, 1):
        assert np.array_equal(a.next(count), b.next(count))
    with pytest.raises(ValueError):
        L.IndexStream(0, np.random.RandomState(0)).next(1)


@pytest.mark.parametrize("over", [
    dict(device_targets=False), dict(input_format="RGBD", device_targets=False),
    dict(input_format="DEPTH", vertex_reg_3d=True, scale=0.5, device_targets=False),
    dict(gan=True, device_targets=False), dict(vertex_reg_3d=True, gan=True, scale=0.5, device_targets=False),
    dict(scale=0.5, device_targets=False), dict(input_format="NORMAL", scale=2.0, device_targets=False),
])
def test_get_minibatch_refuses_unported_branches(over):
    """The dense host targets (device_targets False), once refused here, now
    give JAX's batch bit for bit for the depth inputs, the 3D targets, the
    GAN blobs and rescaled frames too, the RandomState left in step (more
    cases: tests/test_torch_dense_targets.py). A 3D frame gets a seeded
    vertmap (the toy frames have none); a dense batch without the points,
    symmetry and extents it carries raises ValueError."""
    ja, pb = JaxToy("train"), Toy("train")
    kw = {"num_classes": 4, "add_noise": True, **over}
    vm = np.random.RandomState(1).uniform(-0.05, 0.05, (96, 128, 3)).astype(np.float32)
    fa = [ja.load_frame(i) for i in (0, 3)]
    fb = [pb.load_frame(i) for i in (0, 3)]
    if kw.get("vertex_reg_3d"):
        for f in fa + fb:
            f.vertmap = vm
    ra, rb = np.random.RandomState(0), np.random.RandomState(0)
    x = JM.get_minibatch(fa, JM.MinibatchConfig(**kw), ja._extents, ja._points_all, ja._symmetry, rng=ra)
    y = M.get_minibatch(fb, M.MinibatchConfig(**kw), rb, extents=pb._extents, points=pb._points_all,
                        symmetry=pb._symmetry)
    assert sorted(x) == sorted(y) and {"vertex_targets", "points"} <= set(y)
    for k in x:
        assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape and np.array_equal(x[k], y[k]), k
    assert y["data"].dtype == np.float32 and ra.rand() == rb.rand()
    with pytest.raises(ValueError, match="points"):
        M.get_minibatch(fb, M.MinibatchConfig(**kw), np.random.RandomState(0), extents=pb._extents)


def test_get_minibatch_matches_jax_without_chromatic():
    """No chromatic rows and no draws: the same batch, the rng untouched;
    more GT rows than MAX_GT are cut as JAX cuts them."""
    ja, pb = JaxToy("train"), Toy("train")
    for max_gt in (24, 2):
        kw = dict(num_classes=4, chromatic=False, max_gt=max_gt, device_targets=True)
        ra, rb = np.random.RandomState(0), np.random.RandomState(0)
        x = JM.get_minibatch([ja.load_frame(i) for i in (1, 2, 5)], JM.MinibatchConfig(**kw), None, None, None,
                             rng=ra)
        y = M.get_minibatch([pb.load_frame(i) for i in (1, 2, 5)], M.MinibatchConfig(**kw), rb)
        assert sorted(x) == sorted(y) and "chroma_dhls" not in y
        for k in x:
            assert np.array_equal(x[k], y[k]), k
        assert ra.rand() == rb.rand()


def test_rescale_points_is_symmetric_flag():
    d = Toy("train")
    for flag in (True, False):
        a = JM.rescale_points(d._points_all, d._extents, d._symmetry, flag)
        b = M.rescale_points(d._points_all, d._extents, d._symmetry, flag)
        assert np.array_equal(a, b)
    assert not np.array_equal(M.rescale_points(d._points_all, d._extents, d._symmetry, True)[3],
                              M.rescale_points(d._points_all, d._extents, d._symmetry, False)[3])


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "prefetch" and t.is_alive()]


def _wait_no_prefetch_threads(timeout=5.0):
    t_end = time.monotonic() + timeout
    while _prefetch_threads() and time.monotonic() < t_end:
        time.sleep(0.01)
    return not _prefetch_threads()


def test_prefetch_passes_worker_exception():
    """An exception in the worker reaches the consumer, after the items
    made before it, and the thread ends."""

    def source():
        yield {"i": 0}
        yield {"i": 1}
        raise RuntimeError("bad frame")

    it = L.prefetch(source(), depth=1)
    assert next(it) == {"i": 0} and next(it) == {"i": 1}
    with pytest.raises(RuntimeError, match="bad frame"):
        next(it)
    assert _wait_no_prefetch_threads()


def test_prefetch_stops_cleanly():
    """Closing the consumer ends the worker, though the queue is full and
    the source endless; a finite source ends the stream; the source runs on
    the worker."""
    made = []

    def endless():
        i = 0
        while True:
            made.append(i)
            yield {"i": i, "t": threading.current_thread().name}
            i += 1

    it = L.prefetch(endless(), depth=2)
    first = next(it)
    assert first == {"i": 0, "t": "prefetch"}
    time.sleep(0.05)
    it.close()
    assert _wait_no_prefetch_threads()
    assert len(made) <= 5  # bounded by the queue
    assert [d["i"] for d in L.prefetch(iter([{"i": 0}, {"i": 1}]), depth=4)] == [0, 1]
    assert _wait_no_prefetch_threads()
