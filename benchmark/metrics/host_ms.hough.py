"""Host ms a step in the program's `hough` spans: the Hough block (the GT-mix
targets and `hough_voting`). The Solver's `timings["host/hough"]`
(`posecnn_torch/core/profiler.py`), mean over the traced run's steps before
the profiled slice."""

from benchmark.program_spans import untraced_mean


def read(run):
    return untraced_mean(run, "host/hough")
