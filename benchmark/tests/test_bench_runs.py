"""Whole runs of the cells at a size a CPU run holds: the program sound,
traced, with the control (the plain reference in fp8 in the program's
place) and with each fault the cell can have planted under its timed path,
which the comparison must find not correct. The harness's look for a card
is skipped; the rest of a run (set-up, check steps, a short window, the
reference, the comparison with the cell's own limits) is the one the card
runs, on the frozen frames at an eighth of their size and, for PoseCNN,
the trunk at an eighth of its widths."""

import pytest

from benchmark import harness
from benchmark.drivers import darnn_video, posecnn_bank
from benchmark.tests.small import small_spec, write_small_frames

CASES = [("posecnn.train_bank", p) for p in ("control",) + posecnn_bank.PLANTS] + [
    ("darnn.train_t5", p) for p in ("control",) + darnn_video.PLANTS]


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    return write_small_frames(str(tmp_path_factory.mktemp("frames")), n=8, step=8)


@pytest.mark.parametrize("cell,plant", CASES, ids=[f"{c}-{p}" for c, p in CASES])
def test_a_broken_step_is_not_correct(frames, cell, plant):
    result = harness.run_cell(small_spec(cell, frames), 3141592653, 0.5, False, "cpu", plant)
    assert result["correct"] is False, result["checks"]
    assert list(result)[-1] == "checks"
    failed = [k for k, c in result["checks"].items() if not c["value"] <= c["limit"]]
    assert failed


@pytest.mark.parametrize("cell", ["posecnn.train_bank", "darnn.train_t5"])
def test_a_sound_run_reports_its_numbers(frames, cell):
    result = harness.run_cell(small_spec(cell, frames), 2718281828, 0.5, False, "cpu", None)
    assert set(result["checks"]) == set(harness.load_spec(cell).workload["limits"])
    assert result["attempted"] > 0 and result["failed"] == 0
    assert "train_frames_per_s" in result["metrics"] and "setup_s" in result["metrics"]


def test_a_traced_run_reads_its_layers(frames):
    # on the CPU the trace holds no device activity: the device's readers
    # return nothing; the Solver's timings and the breakdown remain. The
    # window holds the steps before the profiled slice on a loaded host too.
    result = harness.run_cell(small_spec("posecnn.train_bank", frames), 1618033988, 3.0, True, "cpu", None)
    assert {"data_wait_ms.train", "step_host_ms.train"} <= set(result["metrics"])
    assert "mfu.train" not in result["metrics"] and "hough_vote_roofline" not in result["metrics"]
    assert result["device"]["window_s"] > 0 and result["breakdown"]["idle_gaps"]
