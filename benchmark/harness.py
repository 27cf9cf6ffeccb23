"""The benchmark's harness: one run of one cell.

A run loads the cell's files by name (`workloads/<cell>.json`, the
configuration and the traffic it names, the driver of the program's path),
builds the program's training step and data from `--seed` (set-up), drives
the step's first `check_steps` steps through the program's own loop with
the benchmark's draws, then measures: the program's `Solver.train` runs
steps back to back until `--seconds` have passed. After the window the
program's state is freed and the plain reference follows the first steps
from the same weights, inputs and draws; `correct` is the comparison of
the two. With `--trace 1` a slice of the window's second part runs under
`torch.profiler` with spans around the program's layers; the per-layer
metrics are read from that trace and from the untraced steps before it.

Nothing here imports the program at module level: `drivers/` do, inside
their functions. The end-to-end metrics (`endtoend/<name>.py`) and the
per-layer ones (`metrics/<name>.py`) are files of their own, found by name.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "posecnn_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def sub_seed(seed: int, name: str) -> int:
    """A seed of its own for each use of the run's seed (weights, data
    order, draws), from numpy's SeedSequence of (seed, name)."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32] + [ord(c) for c in name]
    return int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0] >> np.uint64(2))


@dataclass
class Spec:
    """One cell: its entry in BENCHMARK.json and its files."""

    name: str
    entry: Dict
    workload: Dict
    config: Dict
    traffic: Dict
    manifest: Dict

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def metrics(self, kind: str) -> List[Dict]:
        """The manifest's `end_to_end` or `per_layer` metrics this cell reports."""
        return [m for m in self.manifest[kind] if self.name in m.get("workloads", [self.name])]


def load_spec(name: str, root: str = ROOT) -> Spec:
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(entries)})")
    entry = entries[name]
    bench = os.path.join(root, "benchmark")
    workload = load_json(os.path.join(bench, "workloads", f"{name}.json"))
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(bench, "traffic", f"{entry['traffic']}.json"))
    config = dict(config, frames_dir=os.path.join(root, traffic["frames_dir"]))
    return Spec(name, entry, workload, config, traffic, manifest)


def load_reader(kind: str, name: str) -> Callable:
    """`read` of `<kind>/<name>.py` (a metric's name may hold dots)."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver_module(spec: Spec):
    return importlib.import_module(f"benchmark.drivers.{spec.workload['driver']}")


def reference_module(spec: Spec):
    return importlib.import_module(f"benchmark.reference.{spec.entry['config']}")


def set_cache_dirs(root: str = ROOT) -> None:
    """Every build and kernel cache inside the checkout at a fixed path."""
    cache = os.path.join(root, ".bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("USE_FLAX", "0")


# ------------------------------------------------------------------ probe


class StepProbe:
    """The step the Solver calls: the program's step, with the benchmark's
    hooks around it. `draws_for(step)` (the check steps) replaces the
    Solver's draws with the benchmark's; `after` sees each step's outputs;
    `ends` gets a CUDA event at the end of each step; `tick` (a traced run)
    is called before each step with its index in the window."""

    def __init__(self, step_fn):
        self.step_fn = step_fn
        self.draws_for: Optional[Callable] = None
        self.after: Optional[Callable] = None
        self.ends: Optional[List] = None
        self.tick: Optional[Callable] = None
        self.count = 0

    def __call__(self, state, batch, draws=None):
        if self.tick is not None:
            self.tick(self.count)
        if self.draws_for is not None:
            draws = self.draws_for(state.step)
        out = self.step_fn(state, batch, draws)
        if self.after is not None:
            self.after(state, out, draws)
        if self.ends is not None:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.ends.append(ev)
        self.count += 1
        return out


class Deadline:
    """The data iterator of the window: the program's items until the
    deadline; then it stops, and the Solver's loop with it."""

    def __init__(self, items, deadline: float):
        self.items = items
        self.deadline = deadline

    def __iter__(self):
        return self

    def __next__(self):
        if time.perf_counter() >= self.deadline:
            raise StopIteration
        return next(self.items)


def count_nonfinite_logs(lines: List[str]) -> int:
    return sum(1 for s in lines if "nan" in s.split("(")[0].lower() or "inf" in s.split("(")[0].lower())


# --------------------------------------------------------------- readings


@dataclass
class Readings:
    """What the comparison reads of one side's first steps."""

    loss: List[float]
    terms: List[Dict[str, float]]
    grad1: Dict[str, float]   # each leaf's first gradient norm, from the optimizer's state
    move: Dict[str, float]    # each leaf's change after the steps
    hough: List[Dict] = field(default_factory=list)
    follow: List = field(default_factory=list)
    heads: Dict = field(default_factory=dict)  # the first step's head outputs
    frame_grads: List[float] = field(default_factory=list)  # the first step's dL/dscore norm a frame


def reference_readings(out: Dict) -> Readings:
    return Readings([t["loss"] for t in out["terms"]], out["terms"], out["grad1"], out["move"],
                    [e.get("hough") for e in out["extra"] if e.get("hough") is not None],
                    [e.get("follow") for e in out["extra"] if e.get("follow") is not None],
                    out["extra"][0].get("heads", {}), out["extra"][0].get("frame_grads", []))


def _worst(values) -> float:
    """The largest of the values; infinity where any is not finite (a NaN
    would drop out of max)."""
    values = list(values)
    return max(values) if all(math.isfinite(v) for v in values) else math.inf


def _rel_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> List[float]:
    """Each leaf's |norm - ref norm| over the larger of its ref norm and the
    median leaf's."""
    if set(prog) != set(ref):
        return [math.inf]
    med = float(np.median([ref[k] for k in ref]))
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in ref if keep is None or k in keep]


def compare(prog: Readings, ref: Readings, quiet_share: float = 1e-3) -> Dict[str, float]:
    """The numbers `correct` reads:
    heads_gap  the first step's head outputs (label scores, vertex maps or
               the GRU state), the larger over them of |out - ref| / |ref|
               (L2 over the whole map);
    loss_gap   the largest |loss - ref| / |ref| over the steps;
    loss1_gap  the same of the first step's loss alone (where the later
               steps' trajectories part by more than the first's);
    grad_gap   the worst leaf's |norm - ref norm| of the first gradient as
               the optimizer took it, over the larger of the leaf's ref norm
               and the median leaf's;
    move_gap   the same of each leaf's change after the steps, leaving out
               the leaves whose ref first gradient is under `quiet_share` of
               the median leaf's (moved by round-off alone);
    move_gap_median  the median leaf's of those gaps (where the later steps
               make the worst leaf swing from seed to seed);
    frame_grad_gap  (where the step runs over frames) the worst frame's
               |norm - ref norm| of the first step's gradient of the loss
               with respect to that frame's class scores, over the ref
               norm: each frame's share of the loss;
    hough_gap  (where the step votes) the largest gap of a Hough row:
               box corners and vote count (px, votes), depth (mm)."""
    out = {}
    if len(prog.loss) != len(ref.loss):
        return {"loss_gap": math.inf, "grad_gap": math.inf, "move_gap": math.inf}
    if ref.heads:
        out["heads_gap"] = heads_gap(prog.heads, ref.heads)
    loss = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog.loss, ref.loss)]
    out["loss_gap"], out["loss1_gap"] = _worst(loss), _worst(loss[:1])
    out["grad_gap"] = _worst(_rel_gaps(prog.grad1, ref.grad1))
    moves = _rel_gaps(prog.move, ref.move, kept_leaves(ref.grad1, quiet_share))
    out["move_gap"] = _worst(moves)
    out["move_gap_median"] = float(np.median(moves)) if all(math.isfinite(v) for v in moves) else math.inf
    if ref.frame_grads:
        out["frame_grad_gap"] = (_worst(abs(a - b) / max(b, 1e-30) for a, b in zip(prog.frame_grads, ref.frame_grads))
                                 if len(prog.frame_grads) == len(ref.frame_grads) else math.inf)
    if ref.hough:
        out["hough_gap"] = hough_gap(prog.hough, ref.hough)
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def kept_leaves(grad1: Dict[str, float], quiet_share: float = 1e-3) -> set:
    """The leaves `move_gap` compares: those whose reference first gradient
    is at least `quiet_share` of the median leaf's."""
    med = float(np.median(list(grad1.values())))
    return {k for k, v in grad1.items() if v >= quiet_share * med}


def heads_gap(prog: Dict, ref: Dict) -> float:
    import torch

    if set(prog) != set(ref):
        return math.inf
    gaps = []
    for k, b in ref.items():
        a = prog[k].to(b.device)
        if a.shape != b.shape:
            return math.inf
        num = torch.linalg.vector_norm((a.double() - b.double()).reshape(-1))
        gaps.append(float(num / torch.linalg.vector_norm(b.double().reshape(-1)).clamp(min=1e-30)))
    return _worst(gaps)


def hough_gap(prog: List[Dict], ref: List[Dict]) -> float:
    import torch

    if len(prog) != len(ref):
        return math.inf
    worst = 0.0
    for a, b in zip(prog, ref):
        if a["rois"].shape != b["rois"].shape or not torch.equal(a["valid"].cpu(), b["valid"].cpu()):
            return math.inf
        ra, rb = a["rois"].double().cpu(), b["rois"].double().cpu()
        if not torch.equal(ra[:, :2], rb[:, :2]):
            return math.inf
        box = (ra[:, 2:7] - rb[:, 2:7]).abs().max().item() if ra.numel() else 0.0
        depth = 1e3 * (a["poses_init"].double().cpu()[:, 4:7] - b["poses_init"].double().cpu()[:, 4:7]).abs()
        worst = _worst([worst, box, depth.max().item() if depth.numel() else 0.0])
    return worst


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(k in numbers and numbers[k] <= limits[k] for k in limits)


# ------------------------------------------------------------------ trace


class Tracer:
    """Runs `count` steps of the window under torch.profiler inside one
    `bench:window` span, with a synchronize at each end, from the first
    step that starts at or after `start_at` (set when the window opens),
    and reads the trace when it is done. The profiler is not touched before
    that step: once started it slows the host's launches for the rest of
    the process, so the steps before the slice are the run's untraced ones.
    Its start-up (seconds, on its first start in a process) is added to the
    window's `deadline`, so that it shortens no part of the window."""

    def __init__(self, count: int, cuda: bool = True):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.count, self.cuda = count, cuda
        self.first: Optional[int] = None
        self.start_at = math.inf
        self.deadline: Optional[Deadline] = None
        self.activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self.prof = profile(activities=self.activities)
        self.span = None
        self.active = False
        self.done = False
        self.steps = 0
        self._torch = torch

    def _sync(self) -> None:
        if self.cuda:
            self._torch.cuda.synchronize()

    def tick(self, i: int) -> None:
        if self.first is None and time.perf_counter() >= self.start_at:
            self.first = i
            self._start()
        elif self.active and i == self.first + self.count:
            self._stop()
        if self.active:
            self.steps = i - self.first + 1

    def _start(self) -> None:
        from torch.profiler import record_function

        self._sync()
        t = time.perf_counter()
        self.prof.start()
        if self.deadline is not None:
            self.deadline.deadline += time.perf_counter() - t
        self.span = record_function("bench:window")
        self.span.__enter__()
        self.active = True

    def _stop(self) -> None:
        self._sync()
        self.span.__exit__(None, None, None)
        self.prof.stop()
        self.active, self.done = False, True

    def finish(self):
        """Stop (where the window ended first) and read the trace."""
        from benchmark.timeline import read_chrome_trace

        if self.active:
            self._stop()
        if not self.done:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            trace = read_chrome_trace(path)
        finally:
            os.remove(path)
        trace.steps = self.steps
        return trace


def install_spans(spans: Dict[str, List[str]]) -> contextlib.ExitStack:
    """Wrap each "module:attr.path" of the workload's span map in a
    record_function span of its name, until the stack is closed."""
    from torch.profiler import record_function

    stack = contextlib.ExitStack()
    for name, targets in spans.items():
        for target in targets:
            mod_name, path = target.split(":")
            owner = importlib.import_module(mod_name)
            parts = path.split(".")
            for p in parts[:-1]:
                owner = getattr(owner, p)
            orig = getattr(owner, parts[-1])

            def wrapped(*a, _fn=orig, _name=name, **k):
                with record_function(_name):
                    return _fn(*a, **k)

            stack.enter_context(patched(owner, parts[-1], wrapped))
    return stack


@contextlib.contextmanager
def patched(owner, attr: str, value):
    orig = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
    setattr(owner, attr, value)
    try:
        yield orig
    finally:
        setattr(owner, attr, orig)


# -------------------------------------------------------------------- run


@dataclass
class WindowRun:
    """What the metric readers read of one run."""

    frames_per_step: int
    steps: int
    window_s: float
    setup_s: float
    step_intervals_ms: List[float]
    timings: Dict[str, List[float]]
    trace: Optional[object] = None
    traced: range = range(0)
    cell: Optional[object] = None


def device_info(torch, chips: int) -> Dict:
    peak = max(torch.cuda.max_memory_allocated(d) for d in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips, "memory_peak_bytes": int(peak)}


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool, device: str = "cuda",
             plant: Optional[str] = None, t_start: Optional[float] = None, log=None) -> Dict:
    """One run of a cell; returns the result line's object. `plant` (the
    CPU tests of the comparison; `run.py` never sets it): "control" puts the
    reference in the lower precision in the program's place, a fault's
    name breaks the program underneath for the check steps."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cuda = device.startswith("cuda")
    stamp = lambda what: log(f"[{time.perf_counter() - t_start:.3f}s] {what}")  # noqa: E731
    stamp(f"{spec.name}: seed {seed}, {seconds} s window, trace {int(trace)}")
    cell = driver_module(spec).Cell(spec, seed, device, log)
    stamp("set-up: the program's step, state and data built")
    n_check = int(spec.workload["check_steps"])
    probe = StepProbe(cell.step_fn)
    solver = cell.solver(probe)
    log_lines: List[str] = []

    prog = program_readings(spec, cell, seed, device, plant, solver, probe, log_lines.append)

    stamp(f"set-up: {n_check} check steps done")
    tracer = None
    spans = contextlib.ExitStack()
    if trace:
        tracer = Tracer(int(spec.workload["trace_steps"]), cuda)
        spans = install_spans(spec.workload["spans"])
        spans.enter_context(cell.trace_hooks(tracer))
        probe.tick = tracer.tick
    timings: Dict[str, List[float]] = {}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
        probe.ends = [start_ev]
    probe.count = 0
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    deadline = Deadline(cell.items(), t0 + seconds)
    if tracer is not None:
        tracer.start_at = t0 + seconds * float(spec.workload["trace_from"])
        tracer.deadline = deadline
    steps0 = cell.state.step
    with spans:
        try:
            solver.train(deadline, cell.state, steps0 + 10 ** 9,
                         log=log_lines.append, start_iter=steps0, handle_signals=False, timings=timings)
        except StopIteration:
            pass
        if cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        tr = tracer.finish() if tracer is not None else None
    steps = cell.state.step - steps0
    intervals = []
    if cuda:
        ends = probe.ends
        intervals = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
        dev_info = device_info(torch, spec.chips)
    else:
        dev_info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    run = WindowRun(cell.frames_per_step, steps, t1 - t0, setup_s, intervals, timings, tr,
                    range(tracer.first, tracer.first + tr.steps) if tr is not None else range(0), cell)

    metrics = {}
    kind = "per_layer" if trace else "end_to_end"
    for m in spec.metrics(kind):
        value = load_reader("metrics" if trace else "endtoend", m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if tr is not None:
        dev_info["busy_s"] = tr.busy_us() * 1e-6
        dev_info["window_s"] = tr.window_us * 1e-6
    breakdown = None
    if tr is not None:
        from benchmark.timeline import idle_gaps, top_ops

        breakdown = {"device_ops": top_ops(tr), "idle_gaps": idle_gaps(tr)}
    extra = cell.window_notes(run)
    stamp(f"window: {steps} steps in {t1 - t0:.3f} s; peak device memory {dev_info['memory_peak_bytes']} B; "
          f"launches since the start {extra.get('launches')}")

    # the reference, once the window has closed and the program's state is freed
    cell.free()
    del solver, probe
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_side(spec, cell, seed, device, n_check, follow=prog.follow or None)
    stamp("the reference's steps done")
    numbers = compare(prog, ref)
    limits = spec.workload["limits"]
    correct = judge(numbers, limits)
    checks = {k: {"value": numbers.get(k, math.inf), "limit": limits[k]} for k in limits}
    result = {"correct": bool(correct), "attempted": int(steps), "failed": count_nonfinite_logs(log_lines),
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["notes"] = dict(extra, steps=steps, window_s=t1 - t0, loss_prog=prog.loss, loss_ref=ref.loss)
    result["checks"] = checks
    return result


def reference_side(spec: Spec, cell, seed: int, device: str, n: int, follow=None, precision=None) -> Readings:
    """The plain reference's first n steps from the seed's weights."""
    ref_mod = reference_module(spec)
    weights = cell.weights(seed)
    out = ref_mod.run(spec.config, weights, cell.reference_steps(n), device, follow=follow, precision=precision)
    return reference_readings(out)


def program_readings(spec: Spec, cell, seed: int, device: str, plant, solver, probe, log) -> Readings:
    """The check steps: the window's own call and feed with the benchmark's
    draws, the program broken underneath by a planted fault where one is
    named; or, for the control, the reference in the lower precision in
    the program's place on the same inputs and draws."""
    n = int(spec.workload["check_steps"])
    if plant == "control":
        return reference_side(spec, cell, seed, device, n, precision=spec.workload["control_precision"])
    with cell.plant(plant):
        return cell.check_steps(solver, probe, n, log)


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def _finite(x):
    """JSON has no infinity: a number past every limit stands for one."""
    if isinstance(x, float) and not math.isfinite(x):
        return 1e300
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def print_result(result: Dict) -> None:
    """The result line last on standard output; the numbers compared, each
    beside its limit, last on standard error."""
    result = _finite(result)
    print(json.dumps(result), flush=True)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
