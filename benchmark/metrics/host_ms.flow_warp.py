"""Host ms a step in the program's `flow_warp` spans: the flow warp's forward
(`compute_flow`, each frame's call in the video model). The Solver's
`timings["host/flow_warp"]` (`posecnn_torch/core/profiler.py`), mean over
the traced run's steps before the profiled slice."""

from benchmark.program_spans import untraced_mean


def read(run):
    return untraced_mean(run, "host/flow_warp")
