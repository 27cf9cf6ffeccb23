"""Host ms a step in the program's `heads` spans: the label and vertex heads
(score and vertex branches, softmax, argmax, `hard_label`). The Solver's
`timings["host/heads"]` (`posecnn_torch/core/profiler.py`), mean over the
traced run's steps before the profiled slice."""

from benchmark.program_spans import untraced_mean


def read(run):
    return untraced_mean(run, "host/heads")
