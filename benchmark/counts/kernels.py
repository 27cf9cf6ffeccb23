"""The bounds of the port's two hand-written kernels of the training steps,
frozen from the arithmetic `chip_smoke.py` uses (`vote_pairs`, `vote_bound`,
`conv_bound`).

hough_vote (`csrc/hough_vote.cu`): one vote test of VOTE_TEST_OPS float32
operations for each (slot, centre, sample) pair whose centre lies inside
the valid sample's box, at the float32 peak; every other pair fails the
test whatever its direction, and needs none. Against it, the samples and
centres read once and the votes and distance sums written once.

conv3x3 (`csrc/conv3x3.cu`): 2 * 9 * Cin * Cout operations a pixel at the
bf16 tensor-core peak; x and y (bf16), the weights (bf16) and the bias
(float32) moved once. The forward and the dgrad have the same bound.
"""

from __future__ import annotations

from benchmark.counts.peaks import PEAK_BF16_FLOP_PER_S, PEAK_F32_FLOP_PER_S, bound_s

# f32 operations of one centre x sample vote test: dx, dy, the dot product
# (2 mul, 1 add), |c-p|^2 (2 mul, 1 add), dot^2 and tsq*|c-p|^2
VOTE_TEST_OPS = 10


def vote_pairs(samples, centers, chunk: int = 1024):
    """(pairs that need a test, valid pairs) of one hough_vote launch:
    samples (S, 8, P) rows px, py, u, v, depth, box_thr, tsq, valid;
    centers (1 or S, 2, NC). A pair needs a test when the sample is valid
    and the centre lies inside its box, |cx - px| < thr and |cy - py| < thr,
    with the kernel's rounded subtraction. Counted in chunks of centres on
    the tensors' device."""
    px, py, thr = samples[:, 0, :, None], samples[:, 1, :, None], samples[:, 5, :, None]
    val = samples[:, 7, :, None] > 0
    inside = 0
    for c0 in range(0, centers.shape[2], chunk):
        cx, cy = centers[:, 0, None, c0:c0 + chunk], centers[:, 1, None, c0:c0 + chunk]
        inside += int((val & ((cx - px).abs() < thr) & ((cy - py).abs() < thr)).sum())
    return inside, int(val.sum()) * centers.shape[2]


def vote_bytes(samples, centers) -> int:
    """Bytes one launch must move: samples and centres read, votes and
    distance sums (S, NC) written, all float32."""
    S, nc = samples.shape[0], centers.shape[2]
    return (samples.numel() + centers.numel() + 2 * S * nc) * 4


def vote_bound(nbytes: float, pairs: float):
    """(seconds, bound by) of one hough_vote launch."""
    return bound_s(nbytes, pairs * VOTE_TEST_OPS, PEAK_F32_FLOP_PER_S)


def conv_bound(B: int, H: int, W: int, cin: int, cout: int):
    """(seconds, bound by) of one conv3x3 launch, forward or dgrad."""
    nbytes = B * H * W * (cin + cout) * 2 + 9 * cin * cout * 2 + cout * 4
    return bound_s(nbytes, 2.0 * 9 * cin * cout * B * H * W, PEAK_BF16_FLOP_PER_S)
