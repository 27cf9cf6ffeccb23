"""The 95th percentile over every step of the window of the time between
consecutive step ends on the card's stream (CUDA events; the first from
the window's start), so a stall between steps counts in the step after."""

from benchmark.timeline import percentile


def read(run):
    if not run.step_intervals_ms:
        return None
    return percentile(run.step_intervals_ms, 95.0)
