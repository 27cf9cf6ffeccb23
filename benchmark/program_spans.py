"""Readings of the program's own spans and counters: the Solver's per-step
`host/<layer>` and `cuda_malloc` lists (`posecnn_torch/core/profiler.py`,
`engine/train.py:Solver.train`), and the program's `posecnn:` ranges in a
traced window, on the profiler's clock beside the device's activity.

A program that records no spans (an older commit) leaves the lists out and
puts no `posecnn:` range in the trace: every reading here is then None.
Pure Python: the CPU tests drive it on synthetic runs and timelines.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from benchmark.timeline import Range, Trace, gaps, union, untraced

PROGRAM_PREFIX = "posecnn:"
# the host's waits for the device: the main thread blocked until work queued before has run
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def untraced_mean(run, key: str) -> Optional[float]:
    """The mean a step of the Solver's `timings[key]` over the traced run's
    steps before its profiled slice (the profiler slows the host)."""
    xs = untraced(run.timings.get(key, []), run.traced)
    return sum(xs) / len(xs) if xs else None


def program_ranges(trace: Trace) -> List[Range]:
    """The main thread's `posecnn:` ranges in the window."""
    return [r for r in trace.host_ops if r.name.startswith(PROGRAM_PREFIX)]


def host_syncs(trace: Trace) -> List[Range]:
    """The main thread's synchronisations that start in the window (those
    the profiler makes as it stops come after it), but the Tracer's own
    closing `torch.cuda.synchronize` (the window's last sync, a
    cudaDeviceSynchronize, which the program's step never calls)."""
    lo, hi = trace.window
    syncs = sorted((r for r in trace.host_ops if r.name in SYNC_CALLS and lo <= r.start < hi), key=lambda r: r.start)
    if syncs and syncs[-1].name == "cudaDeviceSynchronize":
        syncs.pop()
    return syncs


def overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """The time two sorted lists of disjoint intervals share."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def unspanned_idle_us(trace: Trace) -> Tuple[float, float]:
    """(the device's idle time in the window, the part of it during which
    the main thread was inside no `posecnn:` range), microseconds."""
    idle = gaps(trace.device_intervals(), *trace.window)
    spanned = overlap(idle, union((r.start, r.end) for r in program_ranges(trace)))
    total = sum(e - s for s, e in idle)
    return total, total - spanned
