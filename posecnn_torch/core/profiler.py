"""Profiling hooks: spans at the port's layer boundaries, and a trace.

  * `span(name)`: a context manager around one layer's host work. With no
    `Recorder` installed and the profiler off it does nothing: it reads one
    global and torch's profiler flag, reads no clock, allocates nothing and
    opens no `record_function`. With a recorder installed (`recording`,
    which `engine.train.Solver.train` does when it is given `timings`) it
    stamps `time.perf_counter_ns()` on entry and exit, adds the duration to
    the step's total for `name` and keeps the span with its parent (the
    span it opened inside). While the profiler runs it also opens
    `record_function("posecnn:" + name)`, so the span sits in the trace on
    the profiler's clock, beside the kernels its launches queue;
  * `LAYERS`: the span names at the training step's layer boundaries, whose
    host milliseconds the Solver reports a step (`timings["host/<name>"]`);
    the Solver's own spans are `step`, `fetch` and `solver`;
  * `trace(logdir)`: a profile of the block (the host's ops, the `posecnn:`
    spans and, on a card, the kernels), written to `<logdir>/trace.json` in
    Chrome's trace format (chrome://tracing, Perfetto): the operator's way
    to see the spans beside the kernels they launch.

The prefix is `posecnn:`: program ranges own no kernel in the benchmark's
attribution, which gives kernels to its own `bench:` ranges and to autograd's
nodes.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import _profiler_enabled

PREFIX = "posecnn:"

# the layer spans of the training steps, in the order a flagship step runs
# them; then the video step's, then the detection step's
LAYERS = ("sample", "trunk", "heads", "hough", "pose_head", "losses", "backward", "optimizer", "flow_warp",
          "rpn", "proposals", "rcnn_head")

_RECORDER: Optional["Recorder"] = None


class SpanRecord(NamedTuple):
    """One closed span: its name, its clock stamps (ns), the name of the
    span it opened inside (None at the top) and the step it belongs to."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    step: int


class Recorder:
    """The spans of one thread (the one that made it), a step at a time.
    `totals` holds the current step's nanoseconds by span name (a span
    inside one of the same name is counted once, by the outer), `spans` its
    closed spans; `take()` hands the step's milliseconds over and starts the
    next step."""

    def __init__(self):
        self.tid = threading.get_ident()
        self.step = 0
        self.totals: Dict[str, int] = {}
        self.spans: List[SpanRecord] = []
        self.open: List[str] = []

    def take(self) -> Dict[str, float]:
        """The current step's milliseconds by span name; the next step begins."""
        out = {k: v * 1e-6 for k, v in self.totals.items()}
        self.totals, self.spans = {}, []
        self.step += 1
        return out


@contextlib.contextmanager
def recording(recorder: Optional[Recorder]):
    """Install `recorder` for the block (None: leave things as they are);
    the one installed before comes back at its end."""
    global _RECORDER
    if recorder is None:
        yield None
        return
    before, _RECORDER = _RECORDER, recorder
    try:
        yield recorder
    finally:
        _RECORDER = before


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("name", "rec", "rf", "parent", "t0")

    def __init__(self, name: str, rec: Optional[Recorder]):
        self.name, self.rec, self.rf = name, rec, None

    def __enter__(self):
        if _profiler_enabled():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        rec = self.rec
        if rec is not None:
            self.parent = rec.open[-1] if rec.open else None
            rec.open.append(self.name)
            self.t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            t1 = time.perf_counter_ns()
            rec.open.pop()
            if self.name not in rec.open:
                rec.totals[self.name] = rec.totals.get(self.name, 0) + (t1 - self.t0)
            rec.spans.append(SpanRecord(self.name, self.t0, t1, self.parent, rec.step))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A span of the layer `name` around the block (see the module's
    docstring); spans of threads other than the recorder's are recorded
    only in the profiler's trace."""
    rec = _RECORDER
    if rec is not None and rec.tid != threading.get_ident():
        rec = None
    if rec is None and not _profiler_enabled():
        return _NULL
    return _Span(name, rec)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; write `<logdir>/trace.json`. The `posecnn:` spans
    of the code it runs appear there as ranges on their thread."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
