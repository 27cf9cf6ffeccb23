"""The port on an NVIDIA GPU: the CUDA kernels against their plain versions,
and the card's results against the CPU and the JAX goldens.

Every test here needs a card and skips without one. The file imports no
JAX, so it also runs where JAX is not installed:
`python -m pytest tests/test_torch_cuda.py -q --noconftest`.

Tolerances: vote counts exact; depth sums rtol 1e-5, atol 1e-4 (another
summation order); conv3x3 outputs within 1 bf16 ulp (`bf16_ulp_excess`: the
same f32 sums in another order, each rounded to bf16 once); the Hough,
small-slice and training goldens through the checks of tests/torch_parity.py
that the CPU tests and chip_smoke.py also use (float32 with TF32 off).
"""

import numpy as np
import pytest
import torch

from posecnn_torch.ops import conv3x3 as C
from posecnn_torch.ops import voting as V
from tests.torch_parity import (
    bf16_ulp_excess, check_hough_golden, check_slice_golden, check_train_golden, hough_on_golden_frame,
    small_slice_on_golden, small_train_on_golden, t, vote_samples,
)

torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from posecnn_torch.engine.test import set_float32_precision

    set_float32_precision()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "S,P,NC,per_slot",
    [(3, 128, 300, False), (3, 128, 300, True), (8, 512, 19200, False), (2, 700, 257, True)],
    ids=["small-shared", "small-per_slot", "flagship-coarse", "two-tiles-per_slot"],
)
def test_kernel_matches_plain(dev, S, P, NC, per_slot):
    rng = np.random.RandomState(S + P)
    samples = vote_samples(rng, S, P, 640, 480)
    n = S if per_slot else 1
    centers = np.stack([rng.randint(0, 640, (n, NC)), rng.randint(0, 480, (n, NC))], axis=1).astype(np.float32)
    s, c = t(samples).to(dev), t(centers).to(dev)
    before = V.VOTE_LAUNCHES
    v, d = V.accumulate_votes(s, c)
    torch.cuda.synchronize()
    assert V.VOTE_LAUNCHES == before + 1
    v_ref, d_ref = V.accumulate_votes_plain(s, c)
    assert v_ref.sum() > 0
    assert torch.equal(v, v_ref)
    torch.testing.assert_close(d, d_ref, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_wrapper_rejects_mixed_devices(dev):
    samples = t(vote_samples(np.random.RandomState(0), 2, 64, 32, 24))
    centers = torch.zeros((1, 2, 10))
    with pytest.raises(ValueError):
        V.accumulate_votes(samples.to(dev), centers)


@pytest.mark.cuda
def test_bin_edges_on_cuda_match_cpu(dev):
    """Every roi width up to 64 at both scales: the card's bin edges equal the
    CPU's (no reciprocal rewrite of the bin division)."""
    from posecnn_torch.ops.roi_pool import bin_edges

    x2 = np.arange(64, dtype=np.float32) * 16.0
    rois = np.zeros((64, 7), np.float32)
    rois[:, 4], rois[:, 5] = x2, x2
    for scale in (1.0 / 16.0, 1.0 / 8.0):
        cpu = bin_edges(t(rois), 7, scale, 1000, 1000)
        gpu = bin_edges(t(rois).to(dev), 7, scale, 1000, 1000)
        for a, b in zip(cpu, gpu):
            assert torch.equal(a, b.cpu())


@pytest.mark.cuda
def test_hough_on_cuda_matches_jax_golden(dev):
    """Flagship Hough settings on frame v4/000000's ground truth."""
    before = V.VOTE_LAUNCHES
    out = hough_on_golden_frame(dev)
    assert V.VOTE_LAUNCHES == before + 2
    assert check_hough_golden(out)["detections"] == 5


@pytest.mark.cuda
def test_small_slice_on_cuda_matches_jax_golden(dev):
    check_slice_golden(*small_slice_on_golden(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["trunk", "bias_relu", "dx"])
@pytest.mark.parametrize("B,H,W,cin", [(2, 480, 640, 64), (1, 37, 50, 64)], ids=["conv1_2", "ragged"])
def test_conv3x3_kernel_matches_plain(dev, mode, B, H, W, cin):
    """Both forward modes and dx; the ragged shape has H and W off the tile
    (8 x 64 a block)."""
    rng = np.random.RandomState(B + H)
    x = t(rng.randn(B, H, W, cin).astype(np.float32)).to(dev)
    w = t((rng.randn(3, 3, cin, 64) * 0.06).astype(np.float32)).to(dev).to(torch.bfloat16)
    b = t((rng.randn(64) * 0.1).astype(np.float32)).to(dev)
    if mode == "dx":
        x = t(rng.randn(B, H, W, 64).astype(np.float32)).to(dev)
        w, b = C.flip_transpose(w), torch.zeros(cin, device=dev)
    else:
        x = torch.relu(x)
        b = b if mode == "bias_relu" else torch.zeros(64, device=dev)
    x = x.to(torch.bfloat16)
    relu = mode == "bias_relu"
    before = C.CONV3X3_LAUNCHES
    y = C.conv3x3_raw(x, w, b, relu)
    torch.cuda.synchronize()
    assert C.CONV3X3_LAUNCHES == before + 1
    assert bf16_ulp_excess(y, C.conv3x3_plain(x, w, b, relu)) <= 1.0


@pytest.mark.cuda
def test_conv3x3_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x = torch.zeros((1, 8, 8, 24), dtype=torch.bfloat16, device=dev)
    w = torch.zeros((3, 3, 24, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        C.conv3x3_raw(x, w, torch.zeros(64, device=dev), False)  # Cin not a multiple of 16
    with pytest.raises(ValueError):
        C.conv3x3_raw(x[..., :16], w[:, :, :16].cpu(), torch.zeros(64, device=dev), False)  # mixed devices


@pytest.mark.cuda
def test_small_train_step_on_cuda_matches_jax_golden(dev):
    check_train_golden(*small_train_on_golden(dev))
