"""Of the device's idle time in the profiled slice (the gaps between its
kernel, copy and fill intervals), the share during which the main thread
was inside no `posecnn:` range of the program: idle time that no span of
the program's names, %. Read where the program records its spans."""

from benchmark.program_spans import program_ranges, unspanned_idle_us


def read(run):
    tr = run.trace
    if tr is None or not tr.kernels or not program_ranges(tr):
        return None
    idle, unspanned = unspanned_idle_us(tr)
    return 100.0 * unspanned / idle if idle > 0 else 0.0
