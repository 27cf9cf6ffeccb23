"""The detection cell's yardstick: the NMS kernel's bound (counts/nms.py) on
hand-made boxes and against brute force, the step's FLOPs (counts/det.py)
against a count by hand, and its readers on a run with no trace."""

import itertools

import numpy as np
import pytest
import torch

from benchmark.counts import PEAK_BYTES_PER_S, PEAK_F32_FLOP_PER_S
from benchmark.counts.det import det_step_flops
from benchmark.counts.nms import NMS_TEST_OPS, nms_bound, nms_bytes, nms_sweep_tests, suppression
from benchmark.harness import WindowRun, load_reader


def test_sweep_on_hand_made_boxes():
    # A, then B over A (IoU 0.9), then C apart, then D over C: A is tested
    # against B, C and D and removes B; C against D and removes D
    boxes = torch.tensor([[0, 0, 99, 99], [0, 0, 89, 99], [200, 200, 249, 249], [200, 205, 249, 249]], dtype=torch.float32)
    over = suppression(boxes, 0.7)
    assert over[0, 1] and over[2, 3] and not over[0, 2] and not over[1, 3]
    keep, tests = nms_sweep_tests(over)
    assert keep.tolist() == [True, False, True, False] and tests == 4
    # disjoint boxes: every pair is tested once
    far = torch.tensor([[20 * i, 0, 20 * i + 9, 9] for i in range(7)], dtype=torch.float32)
    assert nms_sweep_tests(suppression(far, 0.5)) == (pytest.approx(np.ones(7, bool)), 21)


@pytest.mark.parametrize("seed", [0, 1])
def test_sweep_against_brute_force(seed):
    g = torch.Generator().manual_seed(seed)
    xy = torch.randint(0, 60, (40, 2), generator=g).float()
    boxes = torch.cat([xy, xy + torch.randint(5, 30, (40, 2), generator=g).float()], 1)
    over = suppression(boxes, 0.5)
    keep, tests = nms_sweep_tests(over)
    removed, count = set(), 0
    for i in range(40):
        if i in removed:
            continue
        for j in range(i + 1, 40):
            if j not in removed:
                count += 1
                if over[i, j]:
                    removed.add(j)
    assert tests == count and keep.tolist() == [i not in removed for i in range(40)]


def test_nms_bound_hand_count():
    assert nms_bytes(6000) == 6000 * 16 + 6000
    t, by = nms_bound(6000, 1e6)
    assert by == "operations" and t == pytest.approx(1e6 * NMS_TEST_OPS / PEAK_F32_FLOP_PER_S)
    t, by = nms_bound(6000, 10)
    assert by == "bytes" and t == pytest.approx(6000 * 17 / PEAK_BYTES_PER_S)


def test_det_step_flops_hand_count():
    # a 64x96 image: conv1 at 64x96, conv2 at 32x48, conv3 at 16x24, conv4
    # at 8x12, conv5 (and the RPN) at 4x6; 2 x (forward + dW + dX) MACs, no
    # dX for conv1_1; fc6-fc7 and the three heads over 128 rows
    px = [64 * 96] * 2 + [32 * 48] * 2 + [16 * 24] * 3 + [8 * 12] * 3 + [4 * 6] * 3
    chans = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256), (256, 256), (256, 512),
             (512, 512), (512, 512), (512, 512), (512, 512), (512, 512)]
    macs = [p * ci * co * 9 for p, (ci, co) in zip(px, chans)]
    rpn = [24 * 512 * 512 * 9, 24 * 512 * 18, 24 * 512 * 36]
    fcs = [128 * 25088 * 4096, 128 * 4096 * 4096, 128 * 4096 * 22, 128 * 4096 * 88, 128 * 4096 * 88]
    want = 2 * (2 * macs[0] + 3 * sum(macs[1:]) + 3 * sum(rpn) + 3 * sum(fcs))
    assert det_step_flops(64, 96, 22, 9, 128, 4096) == pytest.approx(want)


@pytest.mark.parametrize("name", ["host_ms.rpn", "host_ms.proposals", "host_ms.rcnn_head", "device_ms.proposals",
                                  "nms_roofline"])
def test_readers_find_nothing_without_spans_or_trace(name):
    # an older program records no such span, and an untraced run has no trace
    run = WindowRun(1, 10, 1.0, 1.0, [], {"host/trunk": [1.0] * 10}, None, range(5, 10))
    assert load_reader("metrics", name)(run) is None


def test_nms_roofline_reads_the_traced_launches():
    from benchmark.timeline import Kernel, Trace

    g = torch.Generator().manual_seed(3)
    xy = torch.rand((300, 2), generator=g) * 400
    boxes = torch.cat([xy, xy + 40 + torch.rand((300, 2), generator=g) * 60], 1)
    tests = nms_sweep_tests(suppression(boxes, 0.7))[1]

    class Cell:
        nms_launches = [(boxes, None, 0.7)] * 2

    kernels = list(itertools.chain.from_iterable(
        [Kernel("nms_mask_kernel(float4 const*, int)", 0.0, 3.0), Kernel("nms_sweep_kernel(...)", 3.0, 2.0)]
        for _ in range(2)))
    run = WindowRun(1, 10, 1.0, 1.0, [], {}, Trace(kernels, [], (0.0, 10.0), 1, 2), range(5, 7), Cell())
    want = 100.0 * 2 * nms_bound(300, tests)[0] / (10.0 * 1e-6)
    assert load_reader("metrics", "nms_roofline")(run) == pytest.approx(want)
