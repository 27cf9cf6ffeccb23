"""Metric arithmetic over timelines: the window rate, percentiles over all
steps, the union of device intervals (busy and idle), the attribution of
each kernel to the host range that launched it, and the reading of a
`torch.profiler` chrome trace into those pieces.

Times are microseconds unless a name says otherwise. Pure Python: the CPU
tests drive it on synthetic timelines.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# labels of the host ranges that own kernels
SPAN_PREFIX = "bench:"
AUTOGRAD_PREFIX = "autograd::engine::evaluate_function: "
NODE_LABEL = "autograd:"

# the trace's device activity: kernels, copies and fills
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def window_rate(units: float, t0_s: float, t1_s: float) -> float:
    """Units of work over the whole window [t0, t1] (seconds), stalls and
    all."""
    if t1_s <= t0_s:
        raise ValueError(f"an empty window: {t0_s} .. {t1_s}")
    return units / (t1_s - t0_s)


def intervals_between(ends: Sequence[float]) -> List[float]:
    """The times between consecutive ends: a step's time from the end of
    the one before, so a stall between steps counts in the step after it."""
    return [b - a for a, b in zip(ends, ends[1:])]


def untraced(values: Sequence[float], traced: range) -> List[float]:
    """A traced run's per-step values before its profiled slice `traced`:
    the steps that ran before the profiler was first started."""
    return list(values[:traced.start])


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100) of all values, interpolated linearly
    between the closest ranks (numpy's default)."""
    if not values:
        raise ValueError("a percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union(intervals: Iterable[Tuple[float, float]], lo: Optional[float] = None,
          hi: Optional[float] = None) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals as sorted disjoint intervals,
    clipped to [lo, hi] where given."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_time(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Time in [lo, hi] when at least one interval runs: overlapping
    kernels count once."""
    return sum(e - s for s, e in union(intervals, lo, hi))


def idle_share(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """1 - busy / window."""
    return 1.0 - busy_time(intervals, lo, hi) / (hi - lo)


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle intervals of [lo, hi]."""
    out, t = [], lo
    for s, e in union(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


@dataclass(frozen=True)
class Range:
    """A host range on one thread: a span, an autograd node or an op."""

    tid: int
    start: float
    end: float
    name: str


def innermost(ranges: Sequence[Range], points: Sequence[Tuple[int, float]]) -> List[Optional[Range]]:
    """For each (tid, time) point, the innermost range of its thread that
    holds it (ranges of one thread nest), or None."""
    by_tid: Dict[int, List[Range]] = defaultdict(list)
    for r in ranges:
        by_tid[r.tid].append(r)
    for rs in by_tid.values():
        rs.sort(key=lambda r: (r.start, -r.end))
    order = sorted(range(len(points)), key=lambda i: (points[i][0], points[i][1]))
    out: List[Optional[Range]] = [None] * len(points)
    tid_now, rs, i, stack = None, [], 0, []
    for k in order:
        tid, t = points[k]
        if tid != tid_now:
            tid_now, rs, i, stack = tid, by_tid.get(tid, []), 0, []
        while i < len(rs) and rs[i].start <= t:
            while stack and stack[-1].end < rs[i].start:
                stack.pop()
            stack.append(rs[i])
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        out[k] = stack[-1] if stack else None
    return out


def node_label(name: str) -> Optional[str]:
    """The owner label of a host range: a benchmark span keeps its name, an
    autograd node becomes `autograd:<node>`; other ops own nothing."""
    if name.startswith(SPAN_PREFIX):
        return name
    if name.startswith(AUTOGRAD_PREFIX):
        return NODE_LABEL + name[len(AUTOGRAD_PREFIX):].strip()
    return None


@dataclass
class Kernel:
    name: str
    start: float
    dur: float
    owner: Optional[str] = None


@dataclass
class Trace:
    """What the readers need of one traced window."""

    kernels: List[Kernel]
    host_ops: List[Range]        # every host range of the main thread
    window: Tuple[float, float]  # the `bench:window` span
    main_tid: int
    steps: int = 0

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def device_intervals(self) -> List[Tuple[float, float]]:
        return [(k.start, k.start + k.dur) for k in self.kernels]

    def busy_us(self) -> float:
        return busy_time(self.device_intervals(), *self.window)

    def owned_us(self, labels: Iterable[str]) -> float:
        """Device time of the kernels owned by any of `labels`."""
        want = set(labels)
        return sum(k.dur for k in self.kernels if k.owner in want)

    def autograd_us(self, exclude: Iterable[str] = ()) -> float:
        """Device time of the kernels every autograd node launched, but the
        nodes named in `exclude`."""
        skip = {NODE_LABEL + n for n in exclude}
        return sum(k.dur for k in self.kernels
                   if k.owner is not None and k.owner.startswith(NODE_LABEL) and k.owner not in skip)


def attribute(kernels: List[Kernel], launches: Dict[int, Tuple[int, float]], correlation: List[Optional[int]],
              owners: Sequence[Range]) -> None:
    """Set each kernel's owner: the innermost owner range of the thread
    that launched it, at the launch's time. `launches` maps a correlation
    id to (tid, ts); `correlation[i]` is kernel i's id."""
    idx = [i for i, c in enumerate(correlation) if c is not None and c in launches]
    found = innermost(owners, [launches[correlation[i]] for i in idx])
    for i, r in zip(idx, found):
        kernels[i].owner = r.name if r is not None else None


def read_chrome_trace(path: str, window_span: str = SPAN_PREFIX + "window") -> Trace:
    """A `torch.profiler` chrome trace -> Trace: the device activity inside
    the window span, each kernel owned by the span or autograd node that
    launched it."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return trace_from_events(events, window_span)


def trace_from_events(events: List[Dict], window_span: str = SPAN_PREFIX + "window") -> Trace:
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == window_span
             and e.get("cat") in ("user_annotation", "cpu_op")]
    if not spans:
        raise ValueError(f"no {window_span!r} span in the trace")
    w = spans[0]
    lo, hi, main_tid = float(w["ts"]), float(w["ts"]) + float(w["dur"]), w["tid"]
    kernels, corr, launches, owners, host = [], [], {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            if ts + dur <= lo or ts >= hi:
                continue
            kernels.append(Kernel(e["name"], ts, dur))
            corr.append((e.get("args") or {}).get("correlation"))
        elif cat in LAUNCH_CATS:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launches[c] = (e["tid"], ts)
            if e["tid"] == main_tid:
                host.append(Range(e["tid"], ts, ts + dur, e["name"]))
        elif cat in ("cpu_op", "user_annotation"):
            label = node_label(e["name"])
            if label is not None:
                owners.append(Range(e["tid"], ts, ts + dur, label))
            if e["tid"] == main_tid:
                host.append(Range(e["tid"], ts, ts + dur, e["name"]))
    attribute(kernels, launches, corr, owners)
    return Trace(kernels, host, (lo, hi), main_tid)


def top_ops(trace: Trace, n: int = 10) -> List[List]:
    """The device operations that took most time: [name, seconds]."""
    tot: Dict[str, float] = defaultdict(float)
    for k in trace.kernels:
        tot[k.name] += k.dur
    return [[name, us * 1e-6] for name, us in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(trace: Trace, n: int = 10) -> List[List]:
    """The device's idle time in the window by what the main thread was
    doing: [innermost span > innermost op at the gap's middle, seconds],
    the largest n."""
    gs = gaps(trace.device_intervals(), *trace.window)
    mids = [(trace.main_tid, (s + e) / 2.0) for s, e in gs]
    ops = innermost(trace.host_ops, mids)
    spans = innermost([r for r in trace.host_ops if r.name.startswith(SPAN_PREFIX)], mids)
    tot: Dict[str, float] = defaultdict(float)
    for (s, e), op, sp in zip(gs, ops, spans):
        what = (sp.name if sp is not None else "outside spans")
        if op is not None and op is not sp and op.name != what:
            what += " > " + op.name
        tot[what] += e - s
    return [[name, us * 1e-6] for name, us in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
