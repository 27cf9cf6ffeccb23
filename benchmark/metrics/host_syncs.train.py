"""Host syncs a traced step: the main thread's cudaStreamSynchronize,
cudaDeviceSynchronize and cudaEventSynchronize ranges in the profiled
slice (a tensor read back, an event waited on), but the Tracer's own
closing synchronize, over the slice's steps. Read where the program
records its `posecnn:` spans."""

from benchmark.program_spans import host_syncs, program_ranges


def read(run):
    tr = run.trace
    if tr is None or not tr.kernels or tr.steps == 0 or not program_ranges(tr):
        return None
    return len(host_syncs(tr)) / tr.steps
