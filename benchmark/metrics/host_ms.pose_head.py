"""Host ms a step in the program's `pose_head` spans: the pose head (the crop
pool, fc6-fc8, tanh and the L2 normalisation). The Solver's
`timings["host/pose_head"]` (`posecnn_torch/core/profiler.py`), mean over
the traced run's steps before the profiled slice."""

from benchmark.program_spans import untraced_mean


def read(run):
    return untraced_mean(run, "host/pose_head")
