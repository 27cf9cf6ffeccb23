"""Host ms a step in the program's `losses` spans: the loss terms after the
forward (PoseCNN's `compute_losses`; the video step's cross entropies and L2
term). The Solver's `timings["host/losses"]`
(`posecnn_torch/core/profiler.py`), mean over the traced run's steps before
the profiled slice."""

from benchmark.program_spans import untraced_mean


def read(run):
    return untraced_mean(run, "host/losses")
