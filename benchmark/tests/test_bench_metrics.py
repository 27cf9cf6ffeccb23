"""The metric arithmetic on synthetic timelines, and the readers on a
synthetic trace."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness, timeline as T
from benchmark.timeline import Range

ROOT = harness.ROOT


def test_window_rate_counts_a_stall():
    # 10 steps of 2 frames in a 1 s window, one 0.5 s stall inside it: the
    # rate is over the whole window, not over the steps' own time
    assert T.window_rate(20, 0.0, 1.5) == pytest.approx(20 / 1.5)
    ends = [0.1 * i for i in range(1, 6)] + [1.0 + 0.1 * i for i in range(5)]
    gaps = T.intervals_between([0.0] + ends)
    assert max(gaps) == pytest.approx(0.5)
    with pytest.raises(ValueError):
        T.window_rate(1, 2.0, 2.0)


def test_p95_is_over_all_steps():
    # 100 steps: every tenth one of 100 ms, the rest of 10 ms. The medians
    # of chunks of 10 never see a slow step; the p95 of all steps does.
    xs = [100.0 if i % 10 == 3 else 10.0 for i in range(100)]
    chunk_medians = sorted(sorted(xs[i:i + 10])[5] for i in range(0, 100, 10))
    assert T.percentile(chunk_medians, 95) < 100.0
    assert T.percentile(xs, 95) == pytest.approx(100.0)
    assert T.percentile([1.0, 2.0, 3.0, 4.0], 50) == pytest.approx(2.5)


def test_idle_share_counts_overlaps_once():
    kernels = [(0.0, 4.0), (2.0, 6.0), (5.0, 7.0), (9.0, 10.0)]
    assert T.busy_time(kernels, 0.0, 10.0) == pytest.approx(8.0)
    assert T.idle_share(kernels, 0.0, 10.0) == pytest.approx(0.2)
    # clipped to the window
    assert T.busy_time(kernels, 3.0, 9.5) == pytest.approx(4.5)
    assert T.gaps(kernels, 0.0, 12.0) == [(7.0, 9.0), (10.0, 12.0)]


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 0}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic_events():
    """A window on the main thread (1) with a trunk span, and a backward on
    autograd's thread (2) with two nodes, one nested in an op."""
    return [
        _x("user_annotation", "bench:window", 0, 1000),
        _x("user_annotation", "bench:trunk", 10, 100),
        _x("cpu_op", "aten::conv2d", 20, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 30, 5, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 150, 5, corr=2),
        _x("cpu_op", "autograd::engine::evaluate_function: ConvolutionBackward0", 300, 100, tid=2),
        _x("cpu_op", "aten::convolution_backward", 310, 80, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 320, 5, tid=2, corr=3),
        _x("cpu_op", "autograd::engine::evaluate_function: _WindowMeanBackward", 500, 100, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 510, 5, tid=2, corr=4),
        _x("cpu_op", "aten::item", 700, 200),
        _x("kernel", "conv_fwd", 40, 60, tid=7, corr=1),
        _x("kernel", "add", 160, 20, tid=7, corr=2),
        _x("kernel", "conv_bwd", 330, 100, tid=7, corr=3),
        _x("kernel", "index_add", 520, 30, tid=7, corr=4),
        _x("kernel", "outside", 2000, 30, tid=7, corr=9),
    ]


def test_kernels_owned_by_span_or_autograd_node():
    tr = T.trace_from_events(synthetic_events())
    owners = {k.name: k.owner for k in tr.kernels}
    assert "outside" not in owners
    assert owners == {"conv_fwd": "bench:trunk", "add": "bench:window", "conv_bwd": "autograd:ConvolutionBackward0",
                      "index_add": "autograd:_WindowMeanBackward"}
    assert tr.owned_us(["bench:trunk"]) == 60
    assert tr.autograd_us() == 130
    assert tr.autograd_us(exclude=["_WindowMeanBackward"]) == 100
    assert tr.window_us == 1000
    assert tr.busy_us() == pytest.approx(210)


def test_idle_gaps_name_what_the_host_did():
    tr = T.trace_from_events(synthetic_events())
    gaps = dict((name, s) for name, s in T.idle_gaps(tr))
    # the longest gap, 550..1000, sits mostly over aten::item in the window span
    assert max(gaps, key=gaps.get) == "bench:window > aten::item"
    assert sum(gaps.values()) == pytest.approx((1000 - 210) * 1e-6)
    assert T.top_ops(tr)[0] == ["conv_bwd", pytest.approx(100e-6)]


def test_innermost_nests_ranges():
    rs = [Range(1, 0, 100, "a"), Range(1, 10, 20, "b"), Range(1, 30, 90, "c"), Range(1, 40, 50, "d"),
          Range(2, 0, 100, "x")]
    pts = [(1, 15), (1, 25), (1, 45), (1, 60), (1, 95), (2, 50), (3, 1)]
    got = [r.name if r else None for r in T.innermost(rs, pts)]
    assert got == ["b", "a", "d", "c", "a", "x", None]


def _run(trace, intervals=(50.0,) * 10, cell=None):
    return harness.WindowRun(frames_per_step=2, steps=10, window_s=0.5, setup_s=12.0,
                             step_intervals_ms=list(intervals), timings={"data_wait": [1.0] * 12, "step": [30.0] * 12},
                             trace=trace, traced=range(2, 4), cell=cell)


def test_readers_on_a_synthetic_trace():
    tr = T.trace_from_events(synthetic_events())
    tr.steps = 2
    run = _run(tr)
    read = lambda kind, name: harness.load_reader(kind, name)(run)  # noqa: E731
    assert read("endtoend", "train_frames_per_s") == pytest.approx(40.0)
    assert read("endtoend", "train_step_ms.p95") == pytest.approx(50.0)
    assert read("endtoend", "setup_s") == 12.0
    assert read("metrics", "data_wait_ms.train") == pytest.approx(1.0)
    assert read("metrics", "step_host_ms.train") == pytest.approx(30.0)
    assert read("metrics", "device_ms.trunk") == pytest.approx(0.06 / 2)
    assert read("metrics", "device_ms.backward") == pytest.approx(0.1 / 2)
    assert read("metrics", "device_ms.flow_warp") == pytest.approx(0.03 / 2)
    # 0.21 ms busy over the 2 traced steps, against 50 ms steps before them
    assert read("metrics", "device_idle_share.train") == pytest.approx(100.0 * (1 - 0.105 / 50.0))
    # nothing to read: the reader returns nothing, never 0
    assert read("metrics", "device_ms.hough") is None
    assert read("metrics", "conv3x3_roofline") is None
    assert harness.load_reader("metrics", "device_ms.trunk")(_run(None)) is None


def test_device_shares_leave_out_the_profiled_steps():
    # the steps before the profiled slice take 0.5 ms; the slice's steps 2
    # and 3, step 4 that stops the profiler, and the steps after it 9 ms.
    # Busy is 0.105 ms a traced step; the step does 1e9 FLOPs.
    class Cell:
        def flops_per_step(self):
            return 1e9

    tr = T.trace_from_events(synthetic_events())
    tr.steps = 2
    run = _run(tr, [0.5, 0.5] + [9.0] * 8, Cell())
    assert T.untraced(run.step_intervals_ms, run.traced) == [0.5, 0.5]
    read = lambda name: harness.load_reader("metrics", name)(run)  # noqa: E731
    assert read("device_idle_share.train") == pytest.approx(79.0)
    assert read("mfu.train") == pytest.approx(100.0 * 1e9 / 0.5e-3 / 989e12)
    # no step timed on the stream (a run on the CPU): nothing to read
    assert harness.load_reader("metrics", "mfu.train")(_run(tr, [], Cell())) is None
    assert harness.load_reader("metrics", "device_idle_share.train")(_run(tr, [], Cell())) is None


def test_chrome_trace_file_round_trip(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": synthetic_events()}))
    tr = T.read_chrome_trace(str(path))
    assert len(tr.kernels) == 4
    with pytest.raises(ValueError):
        T.trace_from_events([e for e in synthetic_events() if e["name"] != "bench:window"])


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "posecnn.train_bank", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "posecnn.train_bank", "--seed",
                          "2718281828", "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert {"train_frames_per_s", "train_step_ms.p95", "setup_s"} <= set(line["metrics"])
