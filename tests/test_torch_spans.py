"""The port's spans (`posecnn_torch/core/profiler.py`) and what the Solver
makes of them: nothing recorded and no profiler range opened without a
recorder or a profiler; nesting, parents and per-step sums; the
`host/<layer>` lists of a small flagship bank step and a small video step
run through `Solver.train(timings=...)`; and the `posecnn:` ranges in a
profiler's chrome trace, on the main thread, around the ops they launch
(the profiler's clock, shared with the kernels on a card)."""

import itertools
import json
import threading

import numpy as np
import pytest
import torch

from posecnn_torch.config import PoseCNNConfig
from posecnn_torch.core import profiler as P
from posecnn_torch.core.convert import init_params_numpy, make_model
from posecnn_torch.engine import train as T
from tests.torch_parity import goldens, t


def test_span_is_free_without_recorder_or_profiler(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a profiler range or a clock read with nothing recording")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(P.time, "perf_counter_ns", boom)
    assert P._RECORDER is None and not torch.autograd._profiler_enabled()
    s1, s2 = P.span("trunk"), P.span("hough")
    assert s1 is s2 is P._NULL  # one shared object: nothing allocated a span
    with s1:
        with s2:
            pass
    with pytest.raises(ValueError):
        with P.span("losses"):
            raise ValueError("a span lets an exception through")


def test_nesting_parents_and_step_sums(monkeypatch):
    clock = itertools.count(0, 1000)  # each stamp 1 us after the one before
    monkeypatch.setattr(P.time, "perf_counter_ns", lambda: next(clock))
    rec = P.Recorder()
    with P.recording(rec):
        assert P._RECORDER is rec
        with P.span("step"):            # 0 .. 7000
            with P.span("trunk"):       # 1000 .. 2000
                pass
            with P.span("losses"):      # 3000 .. 6000
                with P.span("losses"):  # 4000 .. 5000: inside one of its name, counted once
                    pass
        with P.span("trunk"):           # 8000 .. 9000: a second call sums
            pass
        spans = list(rec.spans)
        first = rec.take()
        with P.span("trunk"):
            pass
        second = rec.take()
    assert P._RECORDER is None
    assert first == pytest.approx({"step": 7e-3, "trunk": 2e-3, "losses": 3e-3})
    assert second == pytest.approx({"trunk": 1e-3})
    assert rec.spans == [] and rec.step == 2
    assert [(s.name, s.parent, s.step) for s in spans] == [
        ("trunk", "step", 0), ("losses", "losses", 0), ("losses", "step", 0), ("step", None, 0), ("trunk", None, 0)]
    assert all(s.end_ns > s.start_ns for s in spans)


def test_recording_restores_and_other_threads_are_not_recorded():
    outer, inner = P.Recorder(), P.Recorder()
    with P.recording(outer):
        with P.recording(inner):
            seen = []
            th = threading.Thread(target=lambda: seen.append(P.span("trunk")))
            th.start()
            th.join(timeout=30)
            assert not th.is_alive() and seen == [P._NULL]
            with P.span("hough"):
                pass
        assert P._RECORDER is outer
        with P.recording(None):
            assert P._RECORDER is outer
    assert P._RECORDER is None
    assert set(inner.totals) == {"hough"} and outer.totals == {}


def _bank_step():
    G = goldens()
    cfg = PoseCNNConfig(compute_dtype=torch.float32, **G.TRAIN_CFG)
    hp = T.TrainHParams(**G.TRAIN_HP)
    batch, points, symmetry, extents = G.train_inputs()
    bank = {"data": t(batch["data"]), "label": t(batch["gt_label_2d"]).to(torch.uint8),
            "meta_data": t(batch["meta_data"]), "gt_centers": t(batch["gt_centers"]),
            "pose_rows": t(np.zeros((2, 4, 13), np.float32))}
    step = T.make_bank_train_step(cfg, hp, t(points), t(symmetry), t(extents), 2, 8, chromatic=True)
    state = T.create_train_state(make_model(cfg, init_params_numpy(G.TRAIN_SEED, cfg), "cpu"), hp)
    return step, state, itertools.repeat(bank)


def _video_step():
    from posecnn_torch.models import video as V

    G = goldens()
    cfg = V.VideoConfig(compute_dtype=torch.float32, **G.VIDEO_CFG)
    hp = T.TrainHParams(**G.VIDEO_HP)
    state = T.create_train_state(V.make_video_model(cfg, G.video_params(), "cpu"), hp)
    batch = {k: torch.from_numpy(v) for k, v in G.video_inputs().items()}
    return T.make_video_train_step(cfg, hp), state, itertools.repeat(batch)


# the layers each step runs; the others read 0.0
RUNS = {"flagship": (_bank_step, {"sample", "trunk", "heads", "hough", "pose_head", "losses", "backward",
                                  "optimizer"}),
        "video": (_video_step, {"trunk", "flow_warp", "losses", "backward", "optimizer"})}


@pytest.mark.parametrize("kind", sorted(RUNS))
def test_solver_reports_each_layers_host_ms(kind):
    make, ran = RUNS[kind]
    step, state, items = make()
    timings = {}
    T.Solver(step, display=2).train(items, state, 3, log=None, timings=timings)
    n = len(timings["step"])
    assert n == 3 and "cuda_malloc" not in timings  # the allocator's count is a card's
    assert {k for k in timings if k.startswith("host/")} == {"host/" + name for name in P.LAYERS}
    for name in P.LAYERS:
        xs = timings["host/" + name]
        assert len(xs) == n, name
        assert all(x > 0 for x in xs) if name in ran else all(x == 0.0 for x in xs), (name, xs)
    for i in range(n):
        assert sum(timings["host/" + name][i] for name in P.LAYERS) <= timings["step"][i]
    assert P._RECORDER is None  # the Solver took its recorder away


def test_no_timings_records_nothing(monkeypatch):
    step, state, items = _bank_step()
    made = []
    monkeypatch.setattr(P, "_Span", lambda *a: made.append(a))
    T.Solver(step, display=1).train(items, state, 1, log=None)
    assert made == [] and state.step == 1


def test_trace_holds_the_spans_around_their_ops(tmp_path):
    step, state, items = _bank_step()
    T.Solver(step).train(items, state, 1, log=None, timings={})  # warm: the first call's one-off work
    with P.trace(str(tmp_path)):
        T.Solver(step).train(items, state, state.step + 1, log=None, start_iter=state.step, timings={})
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"] if e.get("ph") == "X"]
    ranges = [e for e in events if e["name"].startswith(P.PREFIX)]
    names = {e["name"][len(P.PREFIX):] for e in ranges}
    assert {"step", "fetch", "solver", "sample", "trunk", "heads", "hough", "pose_head", "losses", "backward",
            "optimizer"} <= names
    main = next(e["tid"] for e in ranges if e["name"] == P.PREFIX + "step")
    assert all(e["tid"] == main for e in ranges)
    trunk = [(e["ts"], e["ts"] + e["dur"]) for e in ranges if e["name"] == P.PREFIX + "trunk"]
    convs = [e for e in events if e["name"] == "aten::conv2d" and e["tid"] == main]
    # the forward's convolutions: the trunk's 13 inside its span, the heads' outside it
    inside = [e for e in convs if any(a <= e["ts"] and e["ts"] + e["dur"] <= b for a, b in trunk)]
    assert len(trunk) == 1 and len(inside) == 13 and len(convs) > 13
    step_range = next(e for e in ranges if e["name"] == P.PREFIX + "step")
    for e in ranges:
        if e["name"] not in (P.PREFIX + n for n in ("step", "fetch", "solver")):
            assert step_range["ts"] <= e["ts"] and e["ts"] + e["dur"] <= step_range["ts"] + step_range["dur"]
