"""The readers of the program's own spans and counters (`program_spans.py`,
`metrics/host_ms.*`, `cuda_mallocs.train`, `host_syncs.train`,
`idle_unspanned_share.train`) on synthetic runs and traces, and a traced
run of each cell on the CPU, whose result line carries the host ones."""

import pytest

from benchmark import harness, program_spans as S, timeline as T
from benchmark.tests.small import small_spec, write_small_frames
from benchmark.tests.test_bench_metrics import _x

LAYERS = ("sample", "trunk", "heads", "hough", "pose_head", "losses", "backward", "optimizer", "flow_warp")


def _read(name, run):
    return harness.load_reader("metrics", name)(run)


def _run(timings, trace=None, traced=range(3, 5)):
    return harness.WindowRun(frames_per_step=2, steps=6, window_s=0.5, setup_s=1.0, step_intervals_ms=[50.0] * 6,
                             timings=timings, trace=trace, traced=traced)


def test_host_ms_is_the_untraced_mean():
    # steps 0-2 untraced, 3-4 profiled (slowed), 5 after: only 0-2 count
    timings = {"step": [40.0, 42.0, 44.0, 90.0, 95.0, 80.0]}
    for i, name in enumerate(LAYERS):
        timings["host/" + name] = [1.0 + i, 2.0 + i, 3.0 + i, 50.0, 50.0, 50.0]
    timings["cuda_malloc"] = [3.0, 0.0, 0.0, 7.0, 0.0, 0.0]
    run = _run(timings)
    for i, name in enumerate(LAYERS):
        assert _read("host_ms." + name, run) == pytest.approx(2.0 + i), name
    assert _read("cuda_mallocs.train", run) == pytest.approx(1.0)


def test_a_layer_that_did_not_run_reads_zero_and_an_older_program_nothing():
    timings = {"host/" + name: [0.0] * 6 for name in LAYERS}
    timings["host/trunk"] = [2.0] * 6
    run = _run(timings)
    assert _read("host_ms.flow_warp", run) == 0.0 and _read("host_ms.trunk", run) == 2.0
    # a program without spans leaves the lists out; an untraced run has no untraced steps to read
    older = _run({"step": [40.0] * 6, "data_wait": [0.1] * 6})
    assert all(_read("host_ms." + name, older) is None for name in LAYERS)
    assert _read("cuda_mallocs.train", older) is None
    assert _read("host_ms.trunk", _run(timings, traced=range(0))) is None


def program_events():
    """A window (0..1000) of two steps on the main thread (1): `posecnn:`
    spans with the program's syncs inside, a gap of the device in no span
    (400..450), one across a span's edge (560..640, the span ends at 600),
    the Tracer's closing cudaDeviceSynchronize at the end and the
    profiler's own after the window."""
    return [
        _x("user_annotation", "bench:window", 0, 1000),
        _x("user_annotation", "posecnn:trunk", 10, 90),            # 10..100
        _x("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=1),
        _x("user_annotation", "posecnn:solver", 100, 300),          # 100..400
        _x("cpu_op", "aten::item", 110, 100),
        _x("cuda_runtime", "cudaStreamSynchronize", 120, 80),
        _x("cuda_runtime", "cudaEventSynchronize", 250, 10),
        _x("user_annotation", "posecnn:step", 450, 150),            # 450..600
        _x("cuda_runtime", "cudaLaunchKernel", 455, 5, corr=2),
        _x("user_annotation", "posecnn:step", 640, 350),            # 640..990
        _x("cuda_runtime", "cudaStreamSynchronize", 700, 10),
        _x("cuda_runtime", "cudaDeviceSynchronize", 980, 10),
        _x("cuda_runtime", "cudaDeviceSynchronize", 1010, 10),       # the profiler's, as it stops
        _x("kernel", "conv", 30, 70, tid=7, corr=1),                # busy 30..100
        _x("kernel", "add", 460, 100, tid=7, corr=2),               # busy 460..560
        _x("cuda_runtime", "cudaStreamSynchronize", 500, 10, tid=2),  # another thread's: not the host's wait
    ]


def test_syncs_and_unspanned_idle_on_a_synthetic_trace():
    tr = T.trace_from_events(program_events())
    tr.steps = 2
    run = _run({}, tr)
    # 3 syncs of the program's (two stream syncs and an event's), the Tracer's and the profiler's left out
    assert [r.name for r in S.host_syncs(tr)] == ["cudaStreamSynchronize", "cudaEventSynchronize",
                                                  "cudaStreamSynchronize"]
    assert _read("host_syncs.train", run) == pytest.approx(1.5)
    # idle: 0..30, 100..460, 560..1000 = 830 us; in no span: 0..10, 400..450,
    # 600..640, 990..1000 = 110 us
    idle, unspanned = S.unspanned_idle_us(tr)
    assert idle == pytest.approx(830.0) and unspanned == pytest.approx(110.0)
    assert _read("idle_unspanned_share.train", run) == pytest.approx(100.0 * 110.0 / 830.0)
    # the program's ranges own no kernel: the benchmark's attribution stays its own;
    # they name the breakdown's idle gaps where they are the innermost range
    assert {k.owner for k in tr.kernels} == {"bench:window"}
    gaps = dict(T.idle_gaps(tr))
    assert gaps["bench:window > posecnn:step"] == pytest.approx(440e-6)  # by its middle
    assert gaps["bench:window > posecnn:solver"] == pytest.approx(360e-6)


def test_without_program_ranges_or_device_nothing_is_read():
    events = [e for e in program_events() if not e["name"].startswith("posecnn:")]
    tr = T.trace_from_events(events)
    tr.steps = 2
    assert _read("host_syncs.train", _run({}, tr)) is None
    assert _read("idle_unspanned_share.train", _run({}, tr)) is None
    cpu = T.trace_from_events([e for e in program_events() if e["cat"] != "kernel"])
    cpu.steps = 2
    assert _read("host_syncs.train", _run({}, cpu)) is None
    assert _read("idle_unspanned_share.train", _run({}, cpu)) is None
    assert _read("host_syncs.train", _run({})) is None


def test_overlap_of_interval_lists():
    assert S.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert S.overlap([(0, 10)], []) == 0
    assert S.overlap([(0, 5), (6, 7)], [(0, 100)]) == 6


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    return write_small_frames(str(tmp_path_factory.mktemp("frames")), n=8, step=8)


@pytest.mark.parametrize("cell,host", [
    ("posecnn.train_bank", ("sample", "trunk", "heads", "hough", "pose_head", "losses", "backward", "optimizer")),
    ("darnn.train_t5", ("trunk", "losses", "backward", "optimizer", "flow_warp"))])
def test_a_traced_cell_reports_its_layers_host_ms(frames, cell, host):
    result = harness.run_cell(small_spec(cell, frames), 1414213562, 3.0, True, "cpu", None)
    print({k: v["value"] for k, v in result["metrics"].items()})  # every metric the run read
    got = set(result["metrics"])
    assert {"host_ms." + h for h in host} <= got
    assert all(result["metrics"]["host_ms." + h]["value"] > 0 for h in host)
    # on the CPU: no cudaMalloc count and no device, so nothing of the device's is read
    assert not got & {"cuda_mallocs.train", "host_syncs.train", "idle_unspanned_share.train"}
