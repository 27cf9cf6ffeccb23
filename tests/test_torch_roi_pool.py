"""RoI max pooling of the port against `roi_pool_batched`, the loop oracle
`tests/ref_ops.py:roi_pool_ref` and the masked max the port's forward
replaced (`tests/torch_parity.py:roi_pool_masked_max`). A max is exact in
any order, so pooled values must be equal, in float32 and in bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.ops.roi_pool import roi_pool_batched as jax_roi_pool_batched
from posecnn_torch.ops.roi_pool import roi_pool_batched
from tests.ref_ops import roi_pool_ref
from tests.torch_parity import roi_pool_masked_max, t

torch.set_num_threads(1)

B, H, W, C, D = 2, 12, 16, 5, 7


def _rois(scale: float) -> np.ndarray:
    """(B, D, 7) rois in image coordinates: ordinary, clipped at each map
    edge, fully outside (empty bins), degenerate, and smaller than a bin."""
    s = 1.0 / scale
    boxes = [
        (1.0, 2.0, 9.0, 10.0),
        (-5.0, -3.0, 4.0, 6.0),  # clipped at the top-left edge
        (10.0, 6.0, 30.0, 20.0),  # clipped at the bottom-right edge
        (40.0, 30.0, 50.0, 40.0),  # outside the map: every bin empty
        (7.0, 5.0, 3.0, 2.0),  # x2 < x1: one-cell roi
        (3.0, 3.0, 3.4, 3.6),  # smaller than a bin
        (2.5, 3.5, 8.5, 9.5),  # halves: round half to even (2, 4, 8, 10)
    ]
    rois = np.zeros((B, D, 7), np.float32)
    for b in range(B):
        for d, (x1, y1, x2, y2) in enumerate(boxes):
            rois[b, d] = (b, d % 3, x1 * s, y1 * s, x2 * s, y2 * s, 1.0)
    return rois


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("scale", [1.0 / 16.0, 1.0 / 8.0], ids=["conv5", "conv4"])
def test_roi_pool_matches_jax_and_oracle(scale, dtype):
    feat = np.random.RandomState(0).randn(B, H, W, C).astype(np.float32)
    rois = _rois(scale)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    ref = np.asarray(jax_roi_pool_batched(jnp.asarray(feat).astype(jdt), jnp.asarray(rois), 7, scale).astype(jnp.float32))
    got = roi_pool_batched(t(feat).to(tdt), t(rois), 7, scale)
    assert got.dtype == tdt and got.shape == (B, D, 7, 7, C)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    # the masked max the doubling table replaced, kept to time the two on the card
    assert torch.equal(roi_pool_masked_max(t(feat).to(tdt), t(rois), 7, scale), got)
    if dtype == "f32":
        oracle = roi_pool_ref(feat, rois.reshape(B * D, 7), 7, scale).reshape(B, D, 7, 7, C)
        np.testing.assert_array_equal(got.numpy(), oracle)
    # the roi outside the map pools to zeros; the others pool real maxima
    assert not got[:, 3].any()
    assert (got[:, 0].abs().sum(dim=(1, 2, 3)) > 0).all()


def test_roi_pool_ignores_batch_column():
    """Row (b, d) pools image b whatever its own batch column says."""
    feat = np.random.RandomState(1).randn(B, H, W, C).astype(np.float32)
    rois = _rois(1.0 / 8.0)
    swapped = rois.copy()
    swapped[..., 0] = 1 - swapped[..., 0]
    a = roi_pool_batched(t(feat), t(rois), 7, 1.0 / 8.0)
    b = roi_pool_batched(t(feat), t(swapped), 7, 1.0 / 8.0)
    assert torch.equal(a, b)


def test_last_bin_edge_follows_reference_op():
    """roi_w = 3 at scale 1/16: the reference op's last bin is
    [floor(6 * 3/7), ceil(7 * (3/7))) = [2, 3). Eager JAX `_bin_edges` and the
    loop oracle agree; jitted, XLA rewrites the division and ends the bin at
    4 (ROADMAP Queue 3). The port follows the reference op."""
    from posecnn_tpu.ops.roi_pool import _bin_edges
    from posecnn_torch.ops.roi_pool import bin_edges

    rois = np.array([[0, 1, 5.1, 4.6, 24.9, 35.4, 16.0]], np.float32)
    got = [e.numpy() for e in bin_edges(t(rois), 7, 1.0 / 16.0, 6, 8)]
    ref = [np.asarray(e) for e in _bin_edges(jnp.asarray(rois), 7, 1.0 / 16.0, 6, 8)]
    for g_, r_ in zip(got, ref):
        np.testing.assert_array_equal(g_, r_)
    assert got[1][0, -1] == 3 and got[3][0, -1] == 3


@pytest.mark.parametrize("dtype", ["f32"])
@pytest.mark.parametrize("scale", [1.0 / 16.0, 1.0 / 8.0], ids=["conv5", "conv4"])
def test_roi_pool_gradient_matches_jax(scale, dtype):
    """The training gradient (JAX's custom backward of the doubling table,
    then jnp.max's even split over H) bit-equal to JAX's vjp, on features
    with ties: ReLU zeros and a constant band, where both split the
    cotangent alike. The forward's values stay equal too. Float32 only:
    the trunk's maps that the pose branch pools are float32 in both
    packages; on bf16 maps each stage is bit-equal alone, but the sum of
    the H stage's cotangents over the output rows rounds otherwise (17 of
    1920 elements here)."""
    rng = np.random.RandomState(1)
    feat = np.maximum(rng.randn(B, H, W, C), 0).astype(np.float32)
    feat[0, :, :5] = 0.5
    rois = _rois(scale)
    ct = rng.randn(B, D, 7, 7, C).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    ref, vjp = jax.vjp(lambda x: jax_roi_pool_batched(x, jnp.asarray(rois), 7, scale),
                       jnp.asarray(feat).astype(jdt))
    (ref_grad,) = vjp(jnp.asarray(ct).astype(jdt))
    x = t(feat).to(tdt).requires_grad_(True)
    got = roi_pool_batched(x, t(rois), 7, scale)
    got.backward(t(ct).to(tdt))
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(ref.astype(jnp.float32)))
    np.testing.assert_array_equal(x.grad.float().numpy(), np.asarray(ref_grad.astype(jnp.float32)))
    assert x.grad.dtype == tdt and float(x.grad.abs().max()) > 0

