"""Host ms a step in the program's `optimizer` spans: the update
(`MomentumSGD.step`: the global norm, the clip, the momentum and the move).
The Solver's `timings["host/optimizer"]` (`posecnn_torch/core/profiler.py`),
mean over the traced run's steps before the profiled slice."""

from benchmark.program_spans import untraced_mean


def read(run):
    return untraced_mean(run, "host/optimizer")
