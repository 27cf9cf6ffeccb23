"""Frames that went through forward, backward and update in the window,
over all the window's seconds (host clock, a synchronize at each end)."""

from benchmark.timeline import window_rate


def read(run):
    if run.steps == 0:
        return None
    return window_rate(run.steps * run.frames_per_step, 0.0, run.window_s)
