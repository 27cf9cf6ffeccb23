"""The overlays of `posecnn_torch/engine/visualize.py` against the JAX
package's cv2-drawn ones (`posecnn_tpu/engine/visualize.py`), and the
--vis hooks of the port's CLIs.

Limits: `class_colors` equal for 1..256 classes; the label blend, the
rectangles (cv2.rectangle, thickness 1) and the crosses (cv2.drawMarker)
pixel-equal; the anti-aliased box edges (cv2.line LINE_AA, which the port
draws its own way) held on segments inside the image: every pixel the
port changes within 1 px (8-neighbourhood) of a pixel cv2 changes, and at
least 95% of the pixels cv2 moves more than half way to the colour within
1 px of a pixel the port changes. Where a segment leaves the image, cv2
(5.0) draws the part beyond the border along the border; the port cuts
the segment, and its pixels are held within 1 px of the ideal segment
instead. Text: the port's pixels in the class colour and inside cv2's
`getTextSize` box +-2 px; the text boxes are left out of the whole-image
comparisons. Whole images: outside the box edges' zone (pixels within
1.5 px of an ideal segment) and the text boxes, pixel-equal to JAX's
PNGs; on the flagship frames v4/000000-000004, whose GT boxes project
inside the image.
"""

from __future__ import annotations

import json
import os

import cv2
import numpy as np
import pytest
from scipy.ndimage import binary_dilation

from posecnn_tpu.data import layer as JL
from posecnn_tpu.data import minibatch as JM
from posecnn_tpu.data.toy import toy as JaxToy
from posecnn_tpu.engine import visualize as JV
from posecnn_torch.core import config as C
from posecnn_torch.data import layer as L
from posecnn_torch.data.lov_syn import LovSynVal
from posecnn_torch.data.toy import toy as Toy
from posecnn_torch.engine import visualize as V
from posecnn_torch.engine.test import project_box_corners
from posecnn_torch.utils.quaternion_np import mat2quat

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
NEIGHBOURS = np.ones((3, 3), bool)


def test_class_colors_equal_cv2():
    """The palette for every class count 1..256, and every hue at full
    saturation and value, equal to cv2's HSV2BGR."""
    for n in range(1, 257):
        np.testing.assert_array_equal(V.class_colors(n), JV.class_colors(n), err_msg=str(n))
    hsv = np.stack([np.arange(180), np.full(180, 255), np.full(180, 255)], -1).astype(np.uint8)[:, None]
    np.testing.assert_array_equal(V.hsv_to_bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


def test_rectangles_and_crosses_pixel_equal():
    """draw_rectangle and draw_cross against cv2.rectangle (thickness 1)
    and cv2.drawMarker (MARKER_CROSS, size 8) on random images, with
    corners and centres inside, on and beyond the border."""
    rng = np.random.RandomState(0)
    for _ in range(500):
        im = rng.randint(0, 256, (40, 50, 3)).astype(np.uint8)
        p1, p2 = (tuple(int(v) for v in rng.randint(-20, 70, 2)) for _ in range(2))
        col = tuple(int(v) for v in rng.randint(0, 256, 3))
        a, b = im.copy(), im.copy()
        cv2.rectangle(a, p1, p2, col, 1)
        V.draw_rectangle(b, p1, p2, np.asarray(col, np.uint8))
        np.testing.assert_array_equal(a, b, err_msg=f"rectangle {p1} {p2}")
        a, b = im.copy(), im.copy()
        cv2.drawMarker(a, p1, col, markerType=cv2.MARKER_CROSS, markerSize=8, thickness=1)
        V.draw_cross(b, p1, np.asarray(col, np.uint8))
        np.testing.assert_array_equal(a, b, err_msg=f"cross {p1}")


def _aa_check(base, cv, port, col):
    """(pixels the port changes off cv2's 8-neighbourhood, share of cv2's
    more-than-half-way pixels next to a port pixel, their count)."""
    ca, cb = (cv != base).any(-1), (port != base).any(-1)
    off = int((cb & ~binary_dilation(ca, NEIGHBOURS)).sum())
    diff = np.abs(col.astype(int) - base.astype(int))
    half = ((2 * np.abs(cv.astype(int) - base.astype(int)) > diff) & (diff > 0)).any(-1)
    near = int((half & binary_dilation(cb, NEIGHBOURS)).sum())
    return off, near, int(half.sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aa_lines_against_cv2(seed):
    """draw_line_aa against cv2.line(LINE_AA, thickness 1) on 1000 random
    segments inside a 60x80 image (a third of them a few pixels long, some
    of no length): no port pixel off cv2's 8-neighbourhood, and >= 95% of
    cv2's more-than-half-way pixels next to a port pixel."""
    rng = np.random.RandomState(seed)
    H, W = 60, 80
    near = total = 0
    for t in range(1000):
        im = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
        p1 = np.array([rng.randint(0, W), rng.randint(0, H)])
        p2 = np.array([rng.randint(0, W), rng.randint(0, H)])
        if t % 3 == 0:
            p2 = np.clip(p1 + rng.randint(-3, 4, 2), 0, [W - 1, H - 1])
        col = rng.randint(0, 256, 3).astype(np.uint8)
        a, b = im.copy(), im.copy()
        cv2.line(a, tuple(int(v) for v in p1), tuple(int(v) for v in p2), tuple(int(v) for v in col), 1, cv2.LINE_AA)
        V.draw_line_aa(b, p1, p2, col)
        off, n, h = _aa_check(im, a, b, col)
        assert off == 0, (t, p1, p2)
        near, total = near + n, total + h
    assert total > 10000 and near >= 0.95 * total, (near, total)


def _segment_distance(shape, p0, p1) -> np.ndarray:
    """Each pixel's distance to the segment p0-p1 (x, y)."""
    ys, xs = np.mgrid[:shape[0], :shape[1]].astype(np.float64)
    p0, p1 = np.asarray(p0, np.float64), np.asarray(p1, np.float64)
    d = p1 - p0
    t = np.clip(((xs - p0[0]) * d[0] + (ys - p0[1]) * d[1]) / max(d @ d, 1e-12), 0, 1)
    return np.hypot(xs - p0[0] - t * d[0], ys - p0[1] - t * d[1])


def test_aa_lines_leaving_the_image():
    """Segments with ends far outside the image (to 1e9) draw only pixels
    within 1 px of the ideal segment, and one wholly outside draws
    nothing."""
    rng = np.random.RandomState(3)
    H, W = 60, 80
    for _ in range(300):
        p1, p2 = rng.randint(-60, 140, 2), rng.randint(-60, 140, 2)
        im = np.zeros((H, W, 3), np.uint8)
        V.draw_line_aa(im, p1, p2, np.array([255, 255, 255], np.uint8))
        drawn = im.any(-1)
        assert (_segment_distance((H, W), p1, p2)[drawn] < 1.0 + 1e-9).all(), (p1, p2)
    im = np.zeros((H, W, 3), np.uint8)
    V.draw_line_aa(im, (-10**9, 5), (10**9, 7), (255, 0, 0))
    assert im[..., 0].any() and im.shape == (H, W, 3)
    im[:] = 0
    V.draw_line_aa(im, (-50, -5), (200, -3), (255, 0, 0))
    assert not im.any()


def _names():
    names = set(LovSynVal().classes) | set(Toy("train").classes)
    return sorted(names | {"ape", "benchvise", "eggbox", "glue", "Wjgyp_", "iii", "mmm", "A-Z.09", "{|}~!"})


def test_text_inside_cv2_text_box():
    """draw_text of the datasets' class names (and other characters): every
    pixel it draws is in the class colour and inside cv2.getTextSize's box
    of Hershey simplex 0.4 (from org.x to org.x + width, org.y - height to
    org.y + baseline) +-2 px; each name draws something."""
    col = np.array([20, 200, 90], np.uint8)
    for name in _names():
        im = np.zeros((80, 400, 3), np.uint8)
        V.draw_text(im, name, (10, 40), col)
        ys, xs = np.nonzero(im.any(-1))
        (w, h), base = cv2.getTextSize(name, cv2.FONT_HERSHEY_SIMPLEX, 0.4, 1)
        assert len(xs) and (im[ys, xs] == col).all(), name
        assert xs.min() >= 10 - 2 and xs.max() <= 10 + w + 2, (name, xs.min(), xs.max(), w)
        assert ys.min() >= 40 - h - 2 and ys.max() <= 40 + base + 2, (name, ys.min(), ys.max(), h, base)


def _text_boxes(shape, rois, classes) -> np.ndarray:
    """The pixels of cv2's text boxes (+-2 px) of `PredictionVisualizer`'s
    class names."""
    mask = np.zeros(shape, bool)
    for r in rois:
        c = int(r[1])
        if 0 < c < len(classes):
            x, y = int(r[2]), max(int(r[3]) - 3, 10)
            (w, h), base = cv2.getTextSize(classes[c], cv2.FONT_HERSHEY_SIMPLEX, 0.4, 1)
            mask[max(y - h - 2, 0):max(y + base + 3, 0), max(x - 2, 0):max(x + w + 3, 0)] = True
    return mask


def _line_zone(shape, segments) -> np.ndarray:
    zone = np.zeros(shape, bool)
    for p0, p1 in segments:
        zone |= _segment_distance(shape, p0, p1) <= 1.5
    return zone


def _prediction_case(i: int):
    """(frame, out, rois, poses, the box edges' segments) of flagship frame
    i: the GT label map (at half size for odd i, which the visualizer
    resizes, nearest), a roi from each GT object's label extent with its GT
    pose (the last one's z set to 0: no 3D box), a roi of class 0 and one of
    a class past the list (both skipped)."""
    d = LovSynVal()
    f = d.load_frame(i)
    label = f.label.astype(np.int32)
    if i % 2:
        label = label[::2, ::2]
    rois, poses, segments = [], [], []
    for j in range(f.poses.shape[2]):
        c = int(f.cls_indexes[j])
        ys, xs = np.nonzero(f.label == c)
        if not len(xs):
            continue
        rois.append([0, c, xs.min(), ys.min(), xs.max(), ys.max(), 1.0])
        q, t = mat2quat(f.poses[:, :3, j]), f.poses[:, 3, j]
        poses.append(np.concatenate([q, t]))
    poses[-1][6] = 0.0
    for r, p in zip(rois, poses):
        if p[6] > 0:
            uv = project_box_corners(d._extents[int(r[1])], p[:4], p[4:7], f.intrinsic_matrix).astype(int)
            assert ((uv >= 0) & (uv < [640, 480])).all()  # the case's precondition: boxes in view
            segments += [(uv[a], uv[b]) for a, b in V.BOX_EDGES]
    rois += [[0, 0, 5, 5, 50, 50, 1.0], [0, len(d.classes), 100, 100, 200, 200, 1.0]]
    poses += [np.array([1, 0, 0, 0, 0, 0, 1.0]), np.array([1, 0, 0, 0, 0, 0, 1.0])]
    return d, f, {"label_2d": label[None]}, np.asarray(rois, np.float32), np.asarray(poses, np.float32), segments


@pytest.mark.parametrize("i", [0, 1, 2, 3, 4])
def test_prediction_visualizer_against_jax(i, tmp_path):
    """PredictionVisualizer's PNG against the JAX package's on a flagship
    frame: pixel-equal outside the box edges' zone and the text boxes (the
    blend, the nearest resize of a half-size label map, the rectangles),
    and different somewhere only inside them; the PNG decodes to the
    port's render."""
    d, f, out, rois, poses, segments = _prediction_case(i)
    JV.PredictionVisualizer(str(tmp_path / "jax"), d.classes, d._extents)(i, f, out, rois, poses)
    vis = V.PredictionVisualizer(str(tmp_path / "port"), d.classes, d._extents)
    vis(i, f, out, rois, poses)
    ref = cv2.imread(str(tmp_path / "jax" / f"{i:06d}-vis.png"), cv2.IMREAD_UNCHANGED)
    got = cv2.imread(str(tmp_path / "port" / f"{i:06d}-vis.png"), cv2.IMREAD_UNCHANGED)
    assert got.shape == ref.shape == (480, 640, 3)
    np.testing.assert_array_equal(got, vis.render(f, out, rois, poses))
    excluded = _line_zone(got.shape[:2], segments) | _text_boxes(got.shape[:2], rois, d.classes)
    diff = (got != ref).any(-1)
    assert not (diff & ~excluded).any(), np.argwhere(diff & ~excluded)[:5]
    assert (got != f.color).any(-1).sum() > 1000  # the overlay drew


def _toy_layers(seed=3):
    cfg = C.cfg_from_file(os.path.join(ROOT, "experiments", "cfgs", "toy_pose.yml"))
    a, b = JaxToy("train"), Toy("train")
    m = C.minibatch_cfg(cfg, 4)
    jm = JM.MinibatchConfig(**{k: getattr(m, k) for k in m.__dataclass_fields__})
    return (cfg, JL.GtSynthesizeLayer(a, jm, ims_per_batch=2, seed=seed),
            L.GtSynthesizeLayer(b, m, ims_per_batch=2, seed=seed), b)


@pytest.mark.parametrize("as_float", [False, True])
def test_minibatch_visualizer_against_jax(as_float, tmp_path):
    """MinibatchVisualizer on the port's first three toy_pose.yml host
    batches against the JAX package's on its own (bit-equal) batches, uint8
    data or float data with the pixel means subtracted: the PNGs pixel-equal
    outside the GT boxes' edge zone (the blend, the crosses), and
    max_batches stops at 2."""
    cfg, ja, pb, ds = _toy_layers()
    means = np.asarray(cfg.pixel_means(), np.float32).reshape(1, 1, 1, 3)
    jv = JV.MinibatchVisualizer(str(tmp_path / "jax"), 4, ds._extents, pixel_means=cfg.pixel_means(), max_batches=2)
    pv = V.MinibatchVisualizer(str(tmp_path / "port"), 4, ds._extents, pixel_means=cfg.pixel_means(), max_batches=2)
    boxes = 0
    for it in range(1, 4):
        x, y = ja.forward(), pb.forward()
        for k in x:
            assert np.array_equal(x[k], y[k]), k
        if as_float:
            x["data"] = y["data"] = y["data"].astype(np.float32) - means
        jv(it, x)
        pv(it, y)
        for i in range(2):
            name = f"iter{it:06d}_im{i}.png"
            if it == 3:
                assert not os.path.exists(tmp_path / "port" / "vis_minibatch" / name)
                continue
            ref = cv2.imread(str(tmp_path / "jax" / "vis_minibatch" / name), cv2.IMREAD_UNCHANGED)
            got = cv2.imread(str(tmp_path / "port" / "vis_minibatch" / name), cv2.IMREAD_UNCHANGED)
            assert got.shape == ref.shape == (96, 128, 3)
            segments = []
            K = y["meta_data"][i, :9].reshape(3, 3)
            for row in y["poses"]:
                c = int(row[1])
                if int(row[0]) == i and c > 0 and row[12] > 0:
                    uv = project_box_corners(ds._extents[c], row[6:10], row[10:13], K).astype(int)
                    segments += [(uv[a], uv[b]) for a, b in V.BOX_EDGES]
                    boxes += 1
            diff = (got != ref).any(-1)
            outside = diff & ~_line_zone(got.shape[:2], segments)
            assert not outside.any(), np.argwhere(outside)[:5]
    assert boxes > 0


def test_test_net_vis_and_train_net_vis_on_cpu(tmp_path, monkeypatch):
    """test_net --cfg toy_pose.yml --vis (narrow widths, CPU) writes one
    <output>/vis/<frame>-vis.png a frame, each decoding to the frame's size
    and equal to the visualizer on the run's own detections; its timing
    has `vis` ms; TEST.VISUALIZE alone does the same. train_net --cfg
    toy_pose.yml --vis --iters 3 writes the first 3 host batches' images
    (2 each); a device-bank run refuses --vis."""
    from posecnn_torch import test_net, train_net
    from tests.test_torch_toy_train import _narrow

    _narrow(monkeypatch)
    cfg = os.path.join(ROOT, "experiments", "cfgs", "toy_pose.yml")
    out = tmp_path / "train"
    assert train_net.main(["--cfg", cfg, "--imdb", "toy_train", "--iters", "3", "--device", "cpu", "--vis",
                           "--output", str(out)]) == 0
    files = sorted(os.listdir(out / "vis_minibatch"))
    assert files == [f"iter{it:06d}_im{i}.png" for it in (1, 2, 3) for i in (0, 1)]
    im = cv2.imread(str(out / "vis_minibatch" / files[0]), cv2.IMREAD_UNCHANGED)
    assert im.shape == (96, 128, 3)
    for args in (["--vis"], []):
        ev = tmp_path / f"eval{len(args)}"
        if not args:
            monkeypatch.setattr(C, "cfg_from_file", _with_test_visualize(C.cfg_from_file))
        assert test_net.main(["--cfg", cfg, "--imdb", "toy_val", "--max_frames", "3", "--device", "cpu",
                              "--output", str(ev)] + args) == 0
        assert sorted(os.listdir(ev / "vis")) == [f"{i:06d}-vis.png" for i in range(3)]
        timing = json.loads((ev / "eval_timing.json").read_text())
        assert len(timing["ms"]["vis"]) == 3
        f = Toy("val").load_frame(2)
        png = cv2.imread(str(ev / "vis" / "000002-vis.png"), cv2.IMREAD_UNCHANGED)
        assert png.shape == f.color.shape and (png != f.color).any()
    bank = os.path.join(ROOT, "experiments", "cfgs", "lov_syn_capstone.yml")
    with pytest.raises(ValueError, match="TPU.DEVICE_BANK"):
        train_net.main(["--cfg", bank, "--imdb", "lov_syn_val_v4", "--iters", "1", "--device", "cpu", "--vis",
                        "--output", str(tmp_path / "bank")])


def _with_test_visualize(read):
    def cfg_from_file(path, target=None):
        cfg = read(path, target)
        cfg.TEST.VISUALIZE = True
        return cfg
    return cfg_from_file
