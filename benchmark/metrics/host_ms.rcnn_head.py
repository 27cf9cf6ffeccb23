"""Host ms a step in the detection network's `rcnn_head` spans: the crop pool, fc6, fc7 and the class, box and quaternion heads
(`models/detection.py`). The Solver's `timings["host/rcnn_head"]`
(`posecnn_torch/core/profiler.py`), mean over the traced run's steps
before the profiled slice; None where the program records no such span."""

from benchmark.program_spans import untraced_mean


def read(run):
    return untraced_mean(run, "host/rcnn_head")
