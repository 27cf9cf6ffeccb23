"""Host ms a step in the program's `trunk` spans: the VGG16 trunk's forward
(PoseCNN's call, or each frame's in the video model). The Solver's
`timings["host/trunk"]` (`posecnn_torch/core/profiler.py`), mean over the
traced run's steps before the profiled slice."""

from benchmark.program_spans import untraced_mean


def read(run):
    return untraced_mean(run, "host/trunk")
