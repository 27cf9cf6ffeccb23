"""The Solver's `data_wait` timings (the host blocked on the data iterator
for the next item), mean a step over the traced run's steps before the
profiled slice."""

from benchmark.timeline import untraced


def read(run):
    xs = untraced(run.timings.get("data_wait", []), run.traced)
    return sum(xs) / len(xs) if xs else None
