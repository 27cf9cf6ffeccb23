"""The Solver's `step` timings (host time inside the step: the eager
launches and what waits in them), mean a step over the traced run's steps
before the profiled slice (the profiler slows the launches)."""

from benchmark.timeline import untraced


def read(run):
    xs = untraced(run.timings.get("step", []), run.traced)
    return sum(xs) / len(xs) if xs else None
