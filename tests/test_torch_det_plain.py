"""The detection step against the benchmark's plain reference
(`benchmark/reference/det_vgg16_ycb.py`, plain PyTorch that imports
nothing of the port) at a size a CPU run holds: the frozen frames at half
their size (240x320, where the smallest anchors fit inside the image and
the RPN's losses have anchors to count), the trunk at an eighth of its
widths, fc 64 wide, 600 proposals into NMS, 64 kept, 32 RoIs; seeded
random weights.

The step runs as the benchmark's cell runs it (`benchmark/drivers/
det_frames.py`: the program's `make_det_train_step` through `Solver.train`,
with the benchmark's draws), at float32 where the losses, the gradients
and the kept proposals are held to tolerances, and at the cell's bf16
where the cell's own limits have to tell a sound step from the planted
faults."""

import copy
import functools

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.drivers import det_frames
from benchmark.reference import det_vgg16_ycb as R
from benchmark.tests.small import write_small_frames

SEED = 2718281828
SMALL = {"trunk_scale": 0.125, "fc_dim": 64, "rpn_pre_nms_top_n": 600, "rpn_post_nms_top_n": 64,
         "roi_batch_size": 32}
# float32 on both sides, the same inputs and draws: the loss terms part by
# the order of float32 sums alone (the reference sums its terms and its
# smooth L1 rows in other orders), a few ulps of a loss near 3
LOSS_RTOL = 1e-5
# each leaf's first gradient norm: the backward through 13 convolutions,
# the crop pool's scatter and fc6 sums in other orders; relative to the
# larger of the leaf's norm and the median leaf's (harness.compare's scale)
GRAD_RTOL = 1e-4


def small_spec(frames_dir: str, f32: bool) -> harness.Spec:
    spec = harness.load_spec("det.train_b1")
    cfg = copy.deepcopy(spec.config)
    cfg.update(frames_dir=frames_dir, trunk_scale=0.125, fc_dim=64, RPN_PRE_NMS_TOP_N=600, RPN_POST_NMS_TOP_N=64,
               ROI_BATCH_SIZE=32)
    cfg["object_models"]["points"] = 64
    cfg["model_overrides"] = dict(SMALL)
    if f32:
        cfg["COMPUTE_DTYPE"] = "float32"
        cfg["model_overrides"]["compute_dtype"] = "float32"
    spec.config = cfg
    return spec


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    torch.set_num_threads(2)
    return write_small_frames(str(tmp_path_factory.mktemp("frames")), n=8, step=2)


@pytest.fixture(scope="module")
def f32_sides(frames):
    """The program's check steps and the reference's, both float32; and
    the reference's own selections (no `follow`)."""
    spec = small_spec(frames, True)
    cell = det_frames.Cell(spec, SEED, "cpu", lambda m: None)
    probe = harness.StepProbe(cell.step_fn)
    prog = cell.check_steps(cell.solver(probe), probe, 3, lambda m: None)
    ref = harness.reference_side(spec, cell, SEED, "cpu", 3, follow=prog.follow)
    own = R.run(spec.config, cell.weights(SEED), cell.reference_steps(3), "cpu")
    return prog, ref, own, (spec, cell)


def test_losses_hold_the_reference(f32_sides):
    prog, ref, *_ = f32_sides
    for tp, tr in zip(prog.terms, ref.terms):
        for k in ("loss_rpn_cls", "loss_rpn_box", "loss_cls", "loss_box", "loss_pose", "loss_regu", "loss"):
            assert abs(tp[k] - tr[k]) <= LOSS_RTOL * abs(tr[k]) + 1e-9, (k, tp[k], tr[k])
    # the steps train every part: the RPN's losses at each step, the head's
    # box and pose losses where fg RoIs were sampled
    assert all(t["loss_rpn_cls"] > 0 and t["loss_rpn_box"] > 0 for t in ref.terms)
    assert any(t["loss_box"] > 0 and t["loss_pose"] > 0 for t in ref.terms)


def test_first_gradients_hold_the_reference(f32_sides):
    prog, ref, *_ = f32_sides
    assert set(prog.grad1) == set(ref.grad1) and len(ref.grad1) == 2 * (13 + 3 + 5)
    med = float(np.median(list(ref.grad1.values())))
    for k, b in ref.grad1.items():
        assert abs(prog.grad1[k] - b) <= GRAD_RTOL * max(b, med), (k, prog.grad1[k], b)
    # the proposals carry the box deltas' gradient into the head's crops
    assert ref.grad1["rpn_bbox_pred.weight"] > 0


def test_kept_proposals_and_sampled_rois_are_the_references_own(f32_sides):
    # the reference's own top-k, NMS and RoI sampling, from its own float32
    # scores and boxes, pick what the program picked; its check over the
    # program's scores and boxes finds every kept box and sampled RoI of the
    # program's, exactly
    prog, ref, own, _ = f32_sides
    assert torch.equal(ref.heads["proposals"], torch.ones(64)) and torch.equal(ref.heads["roi_rows"], torch.ones(32))
    for p, o in zip(prog.follow, own["extra"]):
        o = o["follow"]
        assert torch.equal(p["keep"], o["keep"].cpu())
        assert int((p["kept"].abs().sum(1) > 0).sum()) == 64
        assert torch.equal(p["rows"], o["rows"].cpu()) and torch.equal(p["labels"], o["labels"].cpu())
        assert int((p["rows"] >= 0).sum()) == 32
    assert sum(int((p["labels"] > 0).sum()) for p in prog.follow) > 0


def test_one_wrong_kept_box_or_roi_label_fails_the_check(f32_sides):
    # the check reads each kept box and sampled RoI as a row of its own: one
    # wrong row of either, with everything else right, fails the cell's
    # heads_gap limit on its own
    prog, _, _, (spec, cell) = f32_sides
    cfg, step = spec.config, cell.reference_steps(1)[0]
    gt = torch.from_numpy(R.load_frame(cfg["frames_dir"], step["frames"][0], cfg["MAX_GT"])["gt_boxes"])
    k = min(cfg["RPN_PRE_NMS_TOP_N"], prog.follow[0]["scores"].shape[0])

    def gap(fol):
        flags = R.checked_selections(fol, k, cfg["RPN_NMS_THRESH"], gt, step["draws"], cfg["roi_targets"],
                                     cfg["ROI_BATCH_SIZE"])
        return harness.heads_gap({key: torch.ones_like(v) for key, v in flags.items()}, flags), flags

    limit = spec.workload["limits"]["heads_gap"]
    assert gap(prog.follow[0])[0] == 0.0
    # the last kept proposal replaced by the first box NMS removed
    fol = dict(prog.follow[0])
    top = R.top_k(fol["scores"], k)
    fol["kept"] = fol["kept"].clone()
    fol["kept"][-1] = fol["boxes"][top][~fol["keep"]][0]
    g, flags = gap(fol)
    assert int((flags["proposals"] == 0).sum()) == 1 and g > limit
    # one sampled RoI's label changed
    fol = dict(prog.follow[0])
    fol["labels"] = fol["labels"].clone()
    fol["labels"][0] = 1 if int(fol["labels"][0]) == 0 else 0
    g, flags = gap(fol)
    assert int((flags["roi_rows"] == 0).sum()) == 1 and g > limit


def test_heads_hold_the_reference(f32_sides):
    prog, ref, *_ = f32_sides
    # the RPN maps and the head's outputs: float32 convolutions of the same
    # weights and inputs on both sides
    assert harness.heads_gap(prog.heads, ref.heads) <= 1e-5


def test_a_sound_bf16_step_is_correct(frames):
    result = harness.run_cell(small_spec(frames, False), SEED, 0.3, False, "cpu", None)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0


# which of the cell's numbers each fault has to fail at this size
CAUGHT = {"nms_skipped": "heads_gap", "rois_shifted": "heads_gap", "frozen": "move_gap_median",
          "control": "heads_gap"}


@pytest.mark.parametrize("plant", sorted(CAUGHT))
def test_a_broken_step_is_not_correct(frames, plant):
    result = harness.run_cell(small_spec(frames, False), SEED, 0.3, False, "cpu", plant)
    assert result["correct"] is False
    c = result["checks"][CAUGHT[plant]]
    assert not c["value"] <= c["limit"], result["checks"]


@pytest.mark.parametrize("fault", [{"fg_thresh": 0.4}, {"bg_thresh_hi": 0.4}, {"bg_thresh_lo": 0.0}])
def test_a_wrong_roi_sampling_is_not_correct(frames, monkeypatch, fault):
    # proposal_target_layer with a threshold moved: the reference follows
    # the program's sampled RoIs and labels, so the losses move alike on
    # both sides; its own sampling of the program's kept proposals does not
    from posecnn_torch.models import detection as D

    monkeypatch.setattr(D, "proposal_target_layer", functools.partial(D.proposal_target_layer, **fault))
    result = harness.run_cell(small_spec(frames, False), SEED, 0.3, False, "cpu", None)
    assert result["correct"] is False
    c = result["checks"]["heads_gap"]
    assert not c["value"] <= c["limit"], result["checks"]
