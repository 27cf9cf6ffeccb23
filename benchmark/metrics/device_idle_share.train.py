"""1 - the device's busy time a step (the union of its kernel, copy and
fill intervals over the profiled slice, a step) over the mean time of the
traced run's steps before that slice (CUDA events on the stream; the
profiler not yet started, so its cost on the host is left out), %."""

from benchmark.timeline import untraced


def read(run):
    tr = run.trace
    steps_ms = untraced(run.step_intervals_ms, run.traced)
    if tr is None or not tr.kernels or tr.steps == 0 or not steps_ms:
        return None
    busy_ms = tr.busy_us() / 1e3 / tr.steps
    return 100.0 * (1.0 - busy_ms / (sum(steps_ms) / len(steps_ms)))
