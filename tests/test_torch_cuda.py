"""The port on an NVIDIA GPU: the CUDA kernels against their plain versions,
and the card's results against the CPU and the JAX goldens.

Every test here needs a card and skips without one. The file imports no
JAX, so it also runs where JAX is not installed:
`python -m pytest tests/test_torch_cuda.py -q --noconftest`.

Tolerances: vote counts exact; depth sums rtol 1e-5, atol 1e-4 (another
summation order); conv3x3 outputs within 1 bf16 ulp (`bf16_ulp_excess`: the
same f32 sums in another order, each rounded to bf16 once; where the trunk
adds its bias in bf16 after that rounding, the sum within 1 ulp and the
epilogue exact); the Hough,
small-slice and training goldens through the checks of tests/torch_parity.py
that the CPU tests and chip_smoke.py also use (float32 with TF32 off); the
depth ICP against the eval golden and against the CPU port at the flagship
shapes (translation 2e-4 m, quaternion 5e-3: `check_icp`); snapshots
written from the card's tensors restored bit-equal on the card and the CPU;
the NMS kernel's keep masks equal to the plain version's, and the small
detection network, its proposals and RANSAC against the JAX det golden
(`check_det_golden`).
"""

import numpy as np
import pytest
import torch

from posecnn_torch.ops import conv3x3 as C
from posecnn_torch.ops import voting as V
from tests.torch_parity import (
    bf16_ulp_excess, check_hough_golden, check_icp, check_slice_golden, check_train_golden, flagship_icp_scene, goldens,
    hough_on_golden_frame, icp_on_eval_golden, path_vote_inputs, small_slice_on_golden, small_train_on_golden, t,
    vote_edge_cases, vote_samples,
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
@pytest.mark.parametrize("case", vote_edge_cases(), ids=lambda c: c[0])
def test_kernel_pruning_edges_match_plain(dev, case):
    """The box pruning's edges (tests/torch_parity.py:vote_edge_cases): the
    wrapper's launch and every sample split (1 chunk, which stages P=700
    and 1500 in two and three rounds of shared memory, up to 8 in a
    cluster), with the grid width and without it, against the plain
    version; at one split the outputs with and without the width are
    bit-equal (pruning drops only samples that add nothing, and each
    sublist sums in sample order)."""
    _, samples, centers, grid_w = case
    s, c = t(samples).to(dev), t(centers).to(dev)
    v_ref, d_ref = V.accumulate_votes_plain(s, c)
    before = V.VOTE_LAUNCHES
    outs = {(grid_w, 0): V.accumulate_votes(s, c, grid_w=grid_w)}
    assert V.VOTE_LAUNCHES == before + 1
    for split in (1, 2, 4, 8):
        for gw in {grid_w, 0}:
            outs[(gw, split)] = V._launch(s, c, gw, split)
    torch.cuda.synchronize()
    for v, d in outs.values():
        assert torch.equal(v, v_ref)
        torch.testing.assert_close(d, d_ref, rtol=1e-5, atol=1e-4)
    for split in (1, 2, 4, 8):
        assert torch.equal(outs[(grid_w, split)][1], outs[(0, split)][1])


@pytest.mark.cuda
@pytest.mark.parametrize("P", [512, 1024], ids=["inference", "training"])
def test_kernel_on_path_inputs(dev, P):
    """Both passes on the main path's own inputs (frame v4/000000's ground
    truth, tests/torch_parity.py:path_vote_inputs): votes equal to the plain
    version's, and two launches bit-equal."""
    d = path_vote_inputs("data/lov_syn_val_v4/000000.npz", P, dev)
    for centers, grid_w in ((d["coarse"], d["grid_w"]), (d["window"], 0)):
        v, ds = V.accumulate_votes(d["samples"], centers, grid_w=grid_w)
        v2, ds2 = V.accumulate_votes(d["samples"], centers, grid_w=grid_w)
        v_ref, d_ref = V.accumulate_votes_plain(d["samples"], centers)
        torch.cuda.synchronize()
        assert v_ref.sum() > 0
        assert torch.equal(v, v_ref)
        torch.testing.assert_close(ds, d_ref, rtol=1e-5, atol=1e-4)
        assert torch.equal(v, v2) and torch.equal(ds, ds2)


@pytest.mark.cuda
def test_training_hough_is_four_launches(dev):
    """A training step's Hough (B=2, 9 rows a detection) launches the kernel
    twice an image, and matches the CPU port."""
    from posecnn_torch.ops.hough_voting import hough_voting

    G = goldens()
    s = G.HOUGH_SETTINGS
    ins = [G.hough_inputs(f"data/lov_syn_val_v4/00000{i}.npz") for i in (0, 1)]
    label, vert, meta = (np.stack([x[i] for x in ins]) for i in (0, 1, 3))
    kw = dict(num_classes=s["num_classes"], is_train=True, skip_pixels=1, label_threshold=s["label_threshold"],
              class_slots=8, max_samples=1024, center_stride=4, refine_window=16, pixel_grid_stride=3,
              sampler="approx")
    args = (label, vert, ins[0][2], meta, np.zeros((1, 13), np.float32))
    before = V.VOTE_LAUNCHES
    out = hough_voting(*[t(a).to(dev) for a in args], **kw)
    torch.cuda.synchronize()
    assert V.VOTE_LAUNCHES == before + 4
    ref = hough_voting(*[t(a) for a in args], **kw)
    assert torch.equal(out.valid.cpu(), ref.valid) and int(out.num_rois) == int(ref.num_rois) > 0
    assert torch.equal(out.rois[:, :2].cpu(), ref.rois[:, :2]) and torch.equal(out.rois[:, 6].cpu(), ref.rois[:, 6])
    torch.testing.assert_close(out.rois.cpu(), ref.rois, rtol=0, atol=1e-3)
    torch.testing.assert_close(out.poses_init.cpu(), ref.poses_init, rtol=0, atol=1e-4)


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
@pytest.mark.parametrize("mode", ["trunk", "bias_relu", "bias", "dx"])
@pytest.mark.parametrize(
    "B,H,W,cin,cout",
    [(2, 480, 640, 64, 64), (1, 480, 640, 64, 64), (5, 480, 640, 64, 64), (1, 37, 50, 64, 64), (1, 37, 130, 64, 64),
     (2, 1, 641, 64, 64), (1, 37, 130, 128, 128), (1, 9, 200, 64, 128), (2, 9, 200, 128, 64)],
    ids=["conv1_2", "conv1_2_b1", "conv1_2_b5", "ragged", "w130", "h1_w641", "c128", "c64_128", "c128_64"],
)
def test_conv3x3_kernel_matches_plain(dev, mode, B, H, W, cin, cout):
    """Every epilogue and dx, at conv1_2 (B=2, B=1, and B=5: the video
    step's window of 5 frames in one launch) and off the kernel's
    128-pixel tile (W of 50, 130 and 641; H of 1 and 37), at 128 channels
    (a 64-pixel tile) and at mixed widths. trunk: bias added in bf16 after
    the sum's rounding, then ReLU; bias_relu and bias: f32 bias, one
    rounding; dx: the flipped, transposed conv of a cotangent. Within 1 bf16
    ulp of the plain version (trunk: its sum, and the epilogue exact)."""
    rng = np.random.RandomState(B + H + W + cin)
    w = t((rng.randn(3, 3, cin, cout) * np.sqrt(2.0 / (9 * cin))).astype(np.float32)).to(dev).to(torch.bfloat16)
    b = t((rng.randn(cout) * 0.1).astype(np.float32)).to(dev)
    before = C.CONV3X3_LAUNCHES
    if mode == "dx":
        g = t(rng.randn(B, H, W, cout).astype(np.float32)).to(dev).to(torch.bfloat16)
        y = C.conv3x3_dgrad(g, w)
        ref = C.conv3x3_plain(g, C.flip_transpose(w), torch.zeros(cin, device=dev), False)
    else:
        x = torch.relu(t(rng.randn(B, H, W, cin).astype(np.float32)).to(dev)).to(torch.bfloat16)
        relu, bf16_bias = mode != "bias", mode == "trunk"
        y = C.conv3x3_raw(x, w, b, relu, bf16_bias)
        ref = C.conv3x3_plain(x, w, b, relu, bf16_bias)
        if bf16_bias:
            # the sum is rounded twice (to bf16, then with the bias): where
            # the bias cancels most of it, 1 ulp of the sum is many of the
            # result. So the sum is held to 1 ulp, and the epilogue to the
            # kernel's own rounded sum exactly.
            y_sum = C.conv3x3_raw(x, w, torch.zeros_like(b), False)
            assert torch.equal(y, torch.relu(y_sum + b.to(torch.bfloat16)))
            y, ref = y_sum, C.conv3x3_plain(x, w, torch.zeros_like(b), False)
    torch.cuda.synchronize()
    assert C.CONV3X3_LAUNCHES == before + (2 if mode == "trunk" else 1)
    assert y.shape == ref.shape and bool(torch.isfinite(y.float()).all())
    assert bf16_ulp_excess(y, ref) <= 1.0


@pytest.mark.cuda
def test_trunk_conv1_2_is_one_launch_each_way(dev):
    """The trunk's conv1_2 function runs its forward (bias and ReLU in the
    epilogue) and its dx as one kernel launch each: the forward is the
    kernel's sum (within 1 ulp of the plain one) with the bias added in
    bf16 and ReLU, and dx the plain dgrad of the cotangent under the
    forward's ReLU mask, within 1 ulp."""
    from posecnn_torch.models import layers as L

    rng = np.random.RandomState(9)
    x = t(np.maximum(rng.randn(1, 40, 70, 64), 0).astype(np.float32)).to(dev).requires_grad_(True)
    w = t((rng.randn(64, 64, 3, 3) * 0.06).astype(np.float32)).to(dev)
    b = t((rng.randn(64) * 0.1).astype(np.float32)).to(dev)
    g = t(rng.randn(1, 40, 70, 64).astype(np.float32)).to(dev).to(torch.bfloat16)
    before = C.CONV3X3_LAUNCHES
    y = L.conv3x3_bf16_bias_relu(w, b, x)
    fwd = C.CONV3X3_LAUNCHES - before
    y.backward(g)
    assert (fwd, C.CONV3X3_LAUNCHES - before - fwd) == (1, 1)
    xb, wb, zeros = x.detach().to(torch.bfloat16), C.oihw_to_hwio(w).to(torch.bfloat16), torch.zeros(64, device=dev)
    y_sum = C.conv3x3_raw(xb, wb, zeros, False)
    assert torch.equal(y, torch.relu(y_sum + b.to(torch.bfloat16)))
    assert bf16_ulp_excess(y_sum, C.conv3x3_plain(xb, wb, zeros, False)) <= 1.0
    gm = torch.where(y > 0, g, torch.zeros((), dtype=g.dtype, device=dev))
    dx_ref = C.conv3x3_plain(gm, C.flip_transpose(wb), zeros, False)
    assert x.grad.dtype == torch.float32 and bf16_ulp_excess(x.grad, dx_ref) <= 1.0


@pytest.mark.cuda
def test_conv1_2_below_128_rows_on_the_kernel(dev):
    """conv1_2 below 128 rows (the toy path's 96x128): the kernel's
    zero-bias sum then the f32 bias and ReLU, and dx, one launch each; the
    sum and dx within 1 bf16 ulp of the plain versions, the epilogue
    exact, db the f32 sum of the masked cotangent."""
    from posecnn_torch.models import layers as L

    rng = np.random.RandomState(10)
    x = t(np.maximum(rng.randn(2, 96, 128, 64), 0).astype(np.float32)).to(dev).requires_grad_(True)
    w = t((rng.randn(64, 64, 3, 3) * 0.06).astype(np.float32)).to(dev).requires_grad_(True)
    b = t((rng.randn(64) * 0.1).astype(np.float32)).to(dev).requires_grad_(True)
    g = t(rng.randn(2, 96, 128, 64).astype(np.float32)).to(dev)
    before = C.CONV3X3_LAUNCHES
    y = L.conv3x3_bf16_conv2d(w, b, x)
    fwd = C.CONV3X3_LAUNCHES - before
    y.backward(g)
    assert (fwd, C.CONV3X3_LAUNCHES - before - fwd) == (1, 1) and y.dtype == torch.float32
    xb, wb, zeros = x.detach().to(torch.bfloat16), C.oihw_to_hwio(w.detach()).to(torch.bfloat16), torch.zeros(64, device=dev)
    y_sum = C.conv3x3_raw(xb, wb, zeros, False)
    assert torch.equal(y, torch.relu(y_sum.float() + b.detach()))
    assert bf16_ulp_excess(y_sum, C.conv3x3_plain(xb, wb, zeros, False)) <= 1.0
    gm = torch.where(y > 0, g, torch.zeros((), device=dev))
    dx_ref = C.conv3x3_plain(gm.to(torch.bfloat16), C.flip_transpose(wb), zeros, False)
    assert x.grad.dtype == torch.float32 and bf16_ulp_excess(x.grad, dx_ref) <= 1.0
    assert torch.equal(b.grad, gm.sum(dim=(0, 1, 2)))


@pytest.mark.cuda
def test_conv3x3_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x = torch.zeros((1, 8, 8, 48), dtype=torch.bfloat16, device=dev)
    w = torch.zeros((3, 3, 48, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        C.conv3x3_raw(x, w, torch.zeros(64, device=dev), False)  # Cin 48
    with pytest.raises(ValueError):
        C.conv3x3_dgrad(torch.zeros((1, 8, 8, 64), dtype=torch.bfloat16, device=dev), w)  # dx to 48 channels
    x64 = torch.zeros((1, 8, 8, 64), dtype=torch.bfloat16, device=dev)
    w96 = torch.zeros((3, 3, 64, 96), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        C.conv3x3_raw(x64, w96, torch.zeros(96, device=dev), False)  # Cout 96
    with pytest.raises(ValueError):
        C.conv3x3_raw(x64, w96[..., :64].cpu(), torch.zeros(64, device=dev), False)  # mixed devices
    with pytest.raises(ValueError):
        C.conv3x3_dgrad(x64, w96[..., :64].cpu())  # mixed devices


@pytest.mark.cuda
def test_small_train_step_on_cuda_matches_jax_golden(dev):
    check_train_golden(*small_train_on_golden(dev))


@pytest.mark.cuda
def test_icp_on_cuda_matches_eval_golden(dev):
    icp_on_eval_golden(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("plane_weight", [0.0, 1.0])
def test_icp_on_cuda_matches_cpu_at_flagship_size(dev, plane_weight):
    """refine_poses on a 640x480 scene of six cubes (13 detections padded to
    32 rows, 1014 model points) on the card against the CPU port."""
    from posecnn_torch.engine.test import refine_poses

    s = flagship_icp_scene()
    args = (s["rois"], s["poses"], s["depth"], s["label"])
    new, icp = refine_poses(*args, t(s["points_all"]).to(dev), s["meta"], plane_weight=plane_weight)
    ref_new, ref_icp = refine_poses(*args, t(s["points_all"]), s["meta"], plane_weight=plane_weight)
    check_icp(new, icp, ref_new, ref_icp)
    assert (np.abs(icp[:12] - s["poses"][:12]).max(axis=1) > 1e-2).all()
    np.testing.assert_array_equal(icp[12], s["poses"][12])


@pytest.mark.cuda
@pytest.mark.parametrize("full", [True, False], ids=["full", "light"])
def test_snapshot_round_trip_from_cuda(dev, tmp_path, full):
    """A train state on the card snapshots and restores bit-equal into a
    fresh state on the card and on the CPU (the trace only when full)."""
    from posecnn_torch.config import PoseCNNConfig
    from posecnn_torch.core.checkpoint import restore_checkpoint, save_checkpoint
    from posecnn_torch.core.convert import init_params_numpy, make_model
    from posecnn_torch.engine.train import TrainHParams, create_train_state

    cfg = PoseCNNConfig(num_classes=4, num_units=8, trunk_scale=0.125, fc_dim=64, is_train=True, use_crop_pool=True)
    hp = TrainHParams(clip_grad_norm=10.0)
    state = create_train_state(make_model(cfg, init_params_numpy(0, cfg), dev), hp, step=9)
    for tr in state.optimizer.trace:
        tr.normal_()
    path = save_checkpoint(str(tmp_path), state, step=9, include_opt_state=full)
    for device in (dev, "cpu"):
        fresh = create_train_state(make_model(cfg, init_params_numpy(1, cfg), device), hp)
        restore_checkpoint(path, fresh)
        assert fresh.step == 9
        for a, b in zip(state.model.parameters(), fresh.model.parameters()):
            assert torch.equal(a.cpu(), b.cpu())
        for a, b in zip(state.optimizer.trace, fresh.optimizer.trace):
            assert torch.equal(a.cpu(), b.cpu()) if full else not b.any()


@pytest.mark.cuda
@pytest.mark.parametrize("n,thresh", [(1, 0.7), (63, 0.7), (64, 0.5), (65, 0.3), (127, 0.7), (128, 0.5), (129, 0.3),
                                      (4097, 0.7), (6000, 0.3), (12000, 0.7), (20000, 0.5)])
def test_nms_kernel_matches_plain(dev, n, thresh):
    """Keep masks equal on integer boxes (IoUs exactly at the threshold
    among them, equal scores, NaN and infinite coordinates), at sizes around
    the kernel's 64-box blocks, on the staged route (up to 9408 boxes) and
    the window route (12000, 20000); one launch a call."""
    from posecnn_torch.ops import nms as N

    rng = np.random.RandomState(n)
    xy = rng.randint(0, 560, (n, 2))
    boxes = np.concatenate([xy, xy + rng.randint(4, 120, (n, 2))], 1).astype(np.float32)
    if n >= 3:
        boxes[:3] = [[0, 0, 9, 9], [0, 0, 9, 6], [0, 0, 9, 2]]  # IoU 0.7 and 0.3 with the first
    if n >= 18:  # NaN and infinite coordinates, as a diverged network's proposals have them
        boxes[3, 0] = boxes[5, 1] = boxes[13, 2:] = np.nan
        boxes[8, 2] = boxes[17, :2] = np.inf
        boxes[11, 1] = -np.inf
    b = t(boxes).to(dev)
    before = N.NMS_LAUNCHES
    keep = N.nms_keep_sorted(b, thresh)
    torch.cuda.synchronize()
    assert N.NMS_LAUNCHES == before + 1
    assert torch.equal(keep.cpu(), N.nms_keep_sorted_plain(t(boxes), thresh))
    assert N.sweep_route(n) == ("window" if n > 9408 else "staged")
    scores = t(np.round(rng.rand(n) * 8).astype(np.float32)).to(dev)
    assert torch.equal(N.nms_keep(b, scores, thresh).cpu(), N.nms_keep(t(boxes), scores.cpu(), thresh))


@pytest.mark.cuda
def test_det_and_ransac_on_cuda_match_jax_golden(dev):
    """The small float32 detection network, its proposals (NMS on the
    kernel) and RANSAC on the card against the JAX det golden."""
    from tests.torch_parity import check_det_golden, det_on_golden

    check_det_golden(*det_on_golden(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["identity", "all_match", "rigid"])
@pytest.mark.parametrize("B,H,W,C", [(1, 480, 640, 64), (2, 480, 640, 16), (1, 37, 53, 6)],
                         ids=["cell", "b2-c16", "odd"])
def test_flow_warp_kernels_match_plain(dev, case, B, H, W, C):
    """The flow warp's kernels (`csrc/flow_warp.cu`) against the plain
    version on the card (`tests/torch_parity.py:check_flow_warp`): the
    forward, the mask and the divisor bit-equal, the backward within 1e-5
    of the plain gradient's norm; at the DA-RNN cell's shape, at B=2 with
    16 channels, and at an odd shape whose 6 channels take the scalar
    path; on the cell's unrelated depths, the all-match case and a rigid
    motion with depth edges. One launch each way."""
    from posecnn_torch.ops import compute_flow as CF
    from tests.torch_parity import check_flow_warp, flow_warp_both, flow_warp_case, flow_warp_indices

    v = flow_warp_indices(flow_warp_case(case, B, H, W, C, seed=H + C), dev)
    g = torch.Generator(device=dev).manual_seed(7)
    gd, gw = (torch.randn((B, H, W, C), generator=g, device=dev) for _ in range(2))
    before = CF.FLOW_WARP_LAUNCHES
    got, ref = flow_warp_both(v, gd, gw)
    torch.cuda.synchronize()
    assert CF.FLOW_WARP_LAUNCHES == before + 2
    check_flow_warp(got, ref)
    if case == "all_match":
        assert bool((ref[3] > 1).all())


@pytest.mark.cuda
def test_flow_warp_is_two_launches_a_frame(dev):
    """video_forward and backward() on the card: the flow warp's forward
    kernel once a frame, its backward once a frame that has a gradient to
    take back: every frame but the first, whose warp reads the fresh state
    (zeros and ones, which need no gradient), so autograd has no node
    there. T + (T - 1) launches a window."""
    from posecnn_torch.models import video as V
    from posecnn_torch.ops import compute_flow as CF
    from tests.torch_parity import goldens

    G = goldens()
    cfg = V.VideoConfig(compute_dtype=torch.float32, **G.VIDEO_CFG)
    model = V.make_video_model(cfg, G.video_params(), dev)
    x = {k: torch.from_numpy(v).to(dev) for k, v in G.video_inputs().items()}
    CF.FLOW_WARP_LAUNCHES = 0
    outs, state = V.video_forward(model, cfg, x["data"], x["depth"], x["meta_data"])
    assert CF.FLOW_WARP_LAUNCHES == cfg.num_steps
    (outs["score"].sum() + state[0].sum()).backward()
    torch.cuda.synchronize()
    assert CF.FLOW_WARP_LAUNCHES == 2 * cfg.num_steps - 1


@pytest.mark.cuda
def test_video_window_is_two_conv3x3_launches(dev):
    """video_forward and backward() at the DA-RNN cell's sizes (T=5, B=1,
    480x640, 10 classes, 64 units, bf16): the trunk runs once over the
    window's 5 frames, so conv1_2 is one conv3x3 launch forward and one dx
    (2 a frame, 2·T a window, before the trunk ran over the window)."""
    from posecnn_torch.models import video as V
    from tests.torch_parity import goldens

    cfg = V.VideoConfig(num_classes=10)
    model = V.make_video_model(cfg, V.init_video_params_numpy(0, cfg), dev)
    T, B, H, W = cfg.num_steps, 1, 480, 640
    rng = np.random.RandomState(0)
    K = np.array([[1066.778, 0.0, 312.9869], [0.0, 1067.487, 241.3109], [0.0, 0.0, 1.0]])
    data = t((rng.randn(T, B, H, W, 3) * 50).astype(np.float32)).to(dev)
    depth = t(rng.uniform(0.5, 1.5, (T, B, H, W)).astype(np.float32)).to(dev)
    meta = t(goldens().video_meta(T, B, K)).to(dev)
    before = C.CONV3X3_LAUNCHES
    outs, state = V.video_forward(model, cfg, data, depth, meta)
    fwd = C.CONV3X3_LAUNCHES - before
    (outs["score"].float().mean() + state[0].mean()).backward()
    torch.cuda.synchronize()
    assert (fwd, C.CONV3X3_LAUNCHES - before - fwd) == (1, 1)
    assert outs["score"].shape == (T, B, H, W, cfg.num_classes)
    grad = model.trunk.conv1_2.weight.grad
    assert grad is not None and bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0


@pytest.mark.cuda
def test_flow_warp_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    """A window past 7x7 or a float64 state on the card raises: nothing
    falls back to the plain version."""
    from posecnn_torch.ops import compute_flow as CF
    from tests.torch_parity import flow_warp_case

    x = {k: torch.from_numpy(v).to(dev) for k, v in flow_warp_case("rigid", 1, 16, 16, 4).items()}
    before = CF.FLOW_WARP_LAUNCHES
    with pytest.raises(ValueError, match="kernel_size"):
        CF.compute_flow(x["data"], x["weights"], x["points"], x["depth"], x["meta"], 4, 0.02, 50.0)
    with pytest.raises(TypeError, match="float32"):
        CF.compute_flow(x["data"].double(), x["weights"].double(), x["points"], x["depth"], x["meta"], 3, 0.02, 50.0)
    assert CF.FLOW_WARP_LAUNCHES == before
