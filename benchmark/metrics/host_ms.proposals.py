"""Host ms a step in the detection network's `proposals` spans: the proposal layer (decode, top-k, NMS, the first kept) and the proposal targets
(`models/detection.py`). The Solver's `timings["host/proposals"]`
(`posecnn_torch/core/profiler.py`), mean over the traced run's steps
before the profiled slice; None where the program records no such span."""

from benchmark.program_spans import untraced_mean


def read(run):
    return untraced_mean(run, "host/proposals")
