"""The yardstick's counts against brute force and hand counts."""

import itertools

import pytest
import torch

from benchmark.counts import (PEAK_BF16_FLOP_PER_S, PEAK_BYTES_PER_S, PEAK_F32_FLOP_PER_S, VOTE_TEST_OPS, bound_s,
                              conv_bound, posecnn_step_flops, trunk_layers, video_step_flops, vote_bound,
                              vote_bytes, vote_pairs)
from benchmark.counts.flops import _train_flops


def _samples(S, P, seed):
    g = torch.Generator().manual_seed(seed)
    px = torch.randint(0, 40, (S, P), generator=g).float()
    py = torch.randint(0, 30, (S, P), generator=g).float()
    thr = torch.rand((S, P), generator=g) * 12
    valid = (torch.rand((S, P), generator=g) > 0.3).float()
    zero = torch.zeros((S, P))
    return torch.stack([px, py, zero, zero, zero, thr, zero, valid], dim=1)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("chunk", [1, 7, 1024])
def test_vote_pairs_against_enumeration(shared, chunk):
    S, P = 3, 17
    smp = _samples(S, P, 1)
    g = torch.Generator().manual_seed(2)
    nc = 23
    centers = torch.stack([torch.randint(0, 40, (1 if shared else S, nc), generator=g).float(),
                           torch.randint(0, 30, (1 if shared else S, nc), generator=g).float()], dim=1)
    inside = 0
    for s, c, p in itertools.product(range(S), range(nc), range(P)):
        cs = 0 if shared else s
        cx, cy = centers[cs, 0, c], centers[cs, 1, c]
        if smp[s, 7, p] > 0 and abs(cx - smp[s, 0, p]) < smp[s, 5, p] and abs(cy - smp[s, 1, p]) < smp[s, 5, p]:
            inside += 1
    valid = int((smp[:, 7] > 0).sum()) * nc
    assert vote_pairs(smp, centers, chunk=chunk) == (inside, valid)


def test_vote_bound_and_bytes():
    smp = _samples(8, 1024, 3)
    centers = torch.zeros((1, 2, 19200))
    assert vote_bytes(smp, centers) == (8 * 8 * 1024 + 2 * 19200 + 2 * 8 * 19200) * 4
    t, by = vote_bound(1e6, 1e9)
    assert by == "operations" and t == pytest.approx(1e9 * VOTE_TEST_OPS / PEAK_F32_FLOP_PER_S)
    t, by = vote_bound(1e9, 10)
    assert by == "bytes" and t == pytest.approx(1e9 / PEAK_BYTES_PER_S)


def test_conv_bound_hand_count():
    # conv1_2 at B=2, 480x640, 64 -> 64: 2*9*64*64 operations a pixel
    ops = 2 * 9 * 64 * 64 * 2 * 480 * 640
    nbytes = 2 * 480 * 640 * 128 * 2 + 9 * 64 * 64 * 2 + 64 * 4
    t, by = conv_bound(2, 480, 640, 64, 64)
    assert t == pytest.approx(max(ops / PEAK_BF16_FLOP_PER_S, nbytes / PEAK_BYTES_PER_S))
    assert by == "bytes"
    assert bound_s(0.0, PEAK_BF16_FLOP_PER_S, PEAK_BF16_FLOP_PER_S) == (1.0, "operations")


def test_trunk_shapes_round_pools_up():
    layers = trunk_layers(30, 50)
    sizes = {name: (h, w) for name, _, _, _, h, w in layers}
    assert sizes["conv1_1"] == (30, 50)
    assert sizes["conv2_1"] == (15, 25)
    assert sizes["conv3_1"] == (8, 13)
    assert sizes["conv4_1"] == (4, 7)
    assert sizes["conv5_3"] == (2, 4)


def test_train_flops_of_a_small_stack_by_hand():
    # a 3x3 3->4 conv at 8x8, then a 1x1 4->2 at 8x8, two images
    layers = [("a", 3, 3, 4, 8, 8), ("b", 1, 4, 2, 8, 8)]
    macs_a = 2 * 8 * 8 * 3 * 4 * 9
    macs_b = 2 * 8 * 8 * 4 * 2
    # forward + dW for the first layer (its input needs no gradient), + dX for the rest
    assert _train_flops(layers, 2) == 2 * (2 * macs_a + 3 * macs_b)


def test_vgg16_forward_flops_at_640x480():
    # VGG16's conv1_1 .. conv5_3 on one 480x640 image: the published ~188 GFLOP (2 x multiply-adds)
    fwd = sum(2.0 * h * w * ci * co * k * k for _, k, ci, co, h, w in trunk_layers(480, 640))
    assert fwd == pytest.approx(188.4e9, rel=0.01)


def test_step_flops_add_up():
    trunk = _train_flops(trunk_layers(480, 640), 1)
    full = posecnn_step_flops(1, 480, 640, 22, 64, rows=0)
    assert full > trunk
    fc = posecnn_step_flops(1, 480, 640, 22, 64, rows=10) - full
    assert fc == pytest.approx(2 * 3 * 10 * (7 * 7 * 512 * 4096 + 4096 * 4096 + 4096 * 88))
    assert video_step_flops(5, 480, 640, 10, 64) == pytest.approx(5 * video_step_flops(1, 480, 640, 10, 64))
