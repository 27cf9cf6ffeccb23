"""Host ms a step in the program's `sample` spans: the batch's draw from the
bank (`sample_batch`) and the input's preprocessing. The Solver's
`timings["host/sample"]` (`posecnn_torch/core/profiler.py`), mean over the
traced run's steps before the profiled slice."""

from benchmark.program_spans import untraced_mean


def read(run):
    return untraced_mean(run, "host/sample")
