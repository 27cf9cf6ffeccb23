"""The host noise branch of the port's minibatch (TRAIN.ADD_NOISE on a
host-fed config) against the JAX package: per image a gate, then the sigma
of the Gaussian noise the train step adds on the device, or a motion blur
applied on the host (`data.minibatch.motion_blur`, JAX's `cv2.filter2D`
box kernel). The batches are held bit for bit, blurred images included:
the box average is exact against cv2 (a mean of an odd number of integers
never lies within 1/(2 size) of a rounding tie, so float32 sums in another
order cannot move a level), on every kernel size and both axes.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from posecnn_tpu.data import layer as JL
from posecnn_tpu.data import minibatch as JM
from posecnn_tpu.data.toy import toy as JaxToy
from posecnn_tpu.utils.blob import add_noise
from posecnn_torch.core import config as C
from posecnn_torch.data import layer as L
from posecnn_torch.data import minibatch as M
from posecnn_torch.data.toy import toy as Toy

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _images():
    rng = np.random.RandomState(5)
    flat = np.zeros((37, 53, 3), np.uint8)
    flat[:, 20:] = 200
    flat[10:12] = 255
    return {
        "random_480x640": rng.randint(0, 256, (480, 640, 3)).astype(np.uint8),
        "toy_frame": Toy("train").load_frame(3).color,
        "edges_37x53": flat,
    }


@pytest.mark.parametrize("name", sorted(_images()))
def test_motion_blur_equals_cv2(name):
    """`motion_blur` against JAX's `add_noise(force_blur=True)` (cv2) from
    the same seeds, until all 6 sizes on both axes were drawn; the rng
    left in step."""
    im = _images()[name]
    seen = set()
    for seed in range(200):
        ra, rb = np.random.RandomState(seed), np.random.RandomState(seed)
        ref = add_noise(im, rng=ra, force_blur=True)
        probe = np.random.RandomState(seed)
        size = M.BLUR_SIZES[int(probe.randint(6))]
        seen.add((size, bool(probe.rand(1) < 0.5)))
        got = M.motion_blur(im, rb)
        assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape and np.array_equal(got, ref), seed
        assert ra.rand() == rb.rand()
        if len(seen) == 12:
            break
    assert len(seen) == 12


def _jax_mcfg(c, num_classes):
    return JM.MinibatchConfig(
        num_classes=num_classes, pixel_means=c.pixel_means(), scale=float(c.TRAIN.SCALES_BASE[0]),
        chromatic=c.TRAIN.CHROMATIC, add_noise=c.TRAIN.ADD_NOISE, vertex_reg=True, vertex_w_inside=10.0,
        max_gt=c.TPU.MAX_GT, device_targets=c.TPU.DEVICE_TARGETS, input_format=c.INPUT,
    )


@pytest.mark.parametrize("chromatic", [True, False])
def test_host_batches_with_noise_bit_equal(chromatic):
    """GtSynthesizeLayer under toy_pose.yml with ADD_NOISE (and with or
    without CHROMATIC): 24 batches key by key, noise_sigma included, with
    blurred and noisy images among them."""
    cfg = C.cfg_from_file(os.path.join(ROOT, "experiments", "cfgs", "toy_pose.yml"))
    cfg = C.cfg_replace(cfg, TRAIN={"ADD_NOISE": True, "CHROMATIC": chromatic})
    assert not C.unsupported(cfg)
    a, b = JaxToy("train"), Toy("train")
    a.append_flipped_images()
    b.append_flipped_images()
    ja = JL.GtSynthesizeLayer(a, _jax_mcfg(cfg, 4), ims_per_batch=2, seed=3)
    pb = L.GtSynthesizeLayer(b, C.minibatch_cfg(cfg, 4), ims_per_batch=2, seed=3)
    sigmas = []
    for n in range(24):
        x, y = ja.forward(), pb.forward()
        assert sorted(x) == sorted(y) and "noise_sigma" in y and ("chroma_dhls" in y) == chromatic
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape and np.array_equal(x[k], y[k]), (n, k)
        sigmas += y["noise_sigma"].tolist()
    blurred = sum(s == 0.0 for s in sigmas)
    assert 0 < blurred < len(sigmas) and all(0 <= s <= np.sqrt(0.3 * 256) for s in sigmas)
    assert ja.rng.randint(1 << 30) == pb.rng.randint(1 << 30)
