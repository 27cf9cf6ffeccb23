"""cudaMalloc calls a step: the Solver's `timings["cuda_malloc"]` (the
growth of the caching allocator's `segment.all.allocated` between step
ends, read on the host without a sync), mean over the traced run's steps
before the profiled slice."""

from benchmark.program_spans import untraced_mean


def read(run):
    return untraced_mean(run, "cuda_malloc")
