"""Host ms a step in the program's `backward` spans: `loss.backward()` on the
main thread (its wait for autograd's launches included). The Solver's
`timings["host/backward"]` (`posecnn_torch/core/profiler.py`), mean over the
traced run's steps before the profiled slice."""

from benchmark.program_spans import untraced_mean


def read(run):
    return untraced_mean(run, "host/backward")
