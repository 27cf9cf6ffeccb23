"""Profiling hooks.

Port of `posecnn_tpu/core/profiler.py` onto `torch.profiler`:

  * `trace(logdir)`: a profile of the block (the host's ops and, on a card,
    its kernels), written to `<logdir>/trace.json` in Chrome's trace format
    (chrome://tracing, Perfetto);
  * `device_timer(name, results)`: the wall time of a block up to the end of
    the device work it queued: a card is synchronized at the block's end
    (the purpose of JAX's `_barrier_probe`); the seconds are added to
    `results[name]`, or printed;
  * `annotate(name)`: a decorator naming the calls of a function in the
    trace (`torch.profiler.record_function`).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; write `<logdir>/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_timer(name: str, results: dict | None = None):
    """Times a block, its device work included: the card (if one was used)
    is synchronized before the clock starts and at the block's end."""
    _sync()
    start = time.perf_counter()
    yield
    _sync()
    dt = time.perf_counter() - start
    if results is not None:
        results[name] = results.get(name, 0.0) + dt
    else:
        print(f"[timer] {name}: {dt * 1000:.2f} ms")


def annotate(name: str):
    """Named trace annotation decorator for profiler visibility."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)

        return wrapped

    return deco
