"""What every loop of the benchmark shares: the cell's files, host spans,
the traced stretch and its reading, and the checks of the outputs.

The benchmark finds everything by the names in ``BENCHMARK.json``: a cell
``<config>.<traffic>`` reads ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``limits/<cell>.json``, and each metric is
read by ``metrics/<metric>.py``. Nothing here names a cell.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import time

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
#: the label of the traced stretch (a host range in the trace)
STRETCH = "bench_stretch"
#: characters of an operation's name kept in a breakdown
NAME_CHARS = 160


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    #: the metrics this cell reports: (name, unit) of the end-to-end ones
    #: and of the per-layer ones
    end_to_end: list
    per_layer: list


def _reports(metric: dict, cell: str, e2e_names: set[str]) -> bool:
    """A per-layer metric is read in the cells it lists, or without a
    list in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def find_cell(name: str, bench: dict | None = None) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json`` and its files."""
    bench = bench or load_json(ROOT, "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(work)})")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, e2e_names)]
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json(ROOT, cfg["file"]),
                traffic=load_json(BENCH_DIR, "traffic",
                                  w["traffic"] + ".json"),
                limits=load_json(BENCH_DIR, "limits", name + ".json"),
                end_to_end=[(m["name"], m["unit"]) for m in e2e],
                per_layer=[(m["name"], m["unit"]) for m in per_layer])


def metric_reader(name: str):
    """``read(run)`` of ``metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Spans:
    """Host-clock spans by name, kept in memory. With ``trace`` on, each
    span is also a ``record_function`` range, so the profiler shows it on
    the host and, around the device work it launched, on the device."""

    def __init__(self):
        self.times: dict[str, list[float]] = {}
        self.trace = False
        #: host clock at the end of each unit of work
        self.marks: list[float] = []

    def mark(self, units: int = 1) -> None:
        self.marks.extend([time.perf_counter()] * units)

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = contextlib.nullcontext()
        if self.trace:
            from torch.profiler import record_function
            rf = record_function(name)
        with rf:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.times.setdefault(name, []).append(
                    time.perf_counter() - t0)

    def wrap(self, name: str, fn):
        """``fn`` with every call inside the span ``name``."""
        def inner(*a, **k):
            with self(name):
                return fn(*a, **k)
        return inner


@dataclasses.dataclass
class Trace:
    """The device operations and spans of a traced stretch of ``iters``
    periods of a loop, times in microseconds on the profiler's clock."""

    iters: int
    #: (name, start, duration) of every device operation in the stretch
    ops: list
    #: (name, start, end) of the device-side range of each host span
    device_spans: list
    #: (name, start, end) of the host spans (main thread and loader)
    host_spans: list
    #: (start, end) of the stretch on the host
    window: tuple
    #: scans the stretch completed (``iters`` periods of the loop)
    units: int = 0

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        """Seconds in which a device operation ran (overlaps once)."""
        busy, end = 0.0, -math.inf
        for _, s, d in sorted(self.ops, key=lambda o: o[1]):
            lo, hi = max(s, end), s + d
            if hi > lo:
                busy += hi - lo
            end = max(end, hi)
        return busy / 1e6

    def device_us_in(self, span: str) -> float:
        """Summed device time of the operations that run inside the
        device-side ranges of ``span``."""
        ranges = [(s, e) for n, s, e in self.device_spans if n == span]
        return sum(d for _, s, d in self.ops
                   if any(lo <= s <= hi for lo, hi in ranges))

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle time
        between operations by the host span open when each gap began."""
        by_op: dict[str, float] = {}
        for n, _, d in self.ops:
            by_op[n] = by_op.get(n, 0.0) + d / 1e6
        gaps: dict[str, float] = {}
        ops = sorted(self.ops, key=lambda o: o[1])
        end = self.window[0]
        for _, s, d in ops + [("", self.window[1], 0.0)]:
            if s > end:
                open_ = [n for n, lo, hi in self.host_spans
                         if lo <= end < hi] or ["none"]
                key = "/".join(sorted(set(open_)))
                gaps[key] = gaps.get(key, 0.0) + (s - end) / 1e6
            end = max(end, s + d)
        def top(d):     # the ten largest; a long kernel name cut short
            return [[k[:NAME_CHARS], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:10]]

        return {"device_ops": top(by_op), "idle_gaps": top(gaps)}


def _events_in_stretch(prof, span_names: set[str]):
    """Split a profile into a :class:`Trace` (without ``iters``): the
    device operations that start inside the stretch, the device-side and
    host-side ranges of the named spans, the stretch's host range."""
    from torch.autograd import DeviceType

    events = prof.events()
    marks = [e.time_range for e in events
             if e.name == STRETCH and e.device_type == DeviceType.CPU]
    if not marks:
        return None
    lo, hi = marks[0].start, marks[0].end
    ops, dev_spans, host_spans = [], [], []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if e.name in span_names or e.name == STRETCH:
                dev_spans.append((e.name, tr.start, tr.end))
            elif lo <= tr.start <= hi:
                ops.append((e.name, tr.start, tr.end - tr.start))
        elif e.name in span_names and lo <= tr.start <= hi:
            host_spans.append((e.name, tr.start, tr.end))
    return Trace(0, ops, dev_spans, host_spans, (lo, hi))


def traced_stretch(fn, iters: int, span_names: set[str], warmup: int = 2,
                   attempts: int = 8) -> Trace | None:
    """Trace ``fn(n)`` (n periods of a loop) until two traces agree.

    The profiler can lose the records of a trace's first device
    operations, so 32 small fills and ``warmup`` periods run inside the
    trace ahead of the stretch; a trace counts when every operation's
    count is a multiple of ``iters``, and two counting traces must hold
    the same number of operations (the logic of the port's
    ``probes/timing.whole_trace``, frozen here). -> the later trace, or
    None when no two agreed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    seen = set()
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(32):
                torch.zeros(1, device="cuda")
            fn(warmup)
            torch.cuda.synchronize()
            with record_function(STRETCH):
                fn(iters)
                torch.cuda.synchronize()
        tr = _events_in_stretch(prof, span_names)
        print("trace attempt:", None if tr is None else len(tr.ops),
              "device operations")
        if tr is None or not tr.ops:
            continue
        names: dict[str, int] = {}
        for n, _, _ in tr.ops:
            names[n] = names.get(n, 0) + 1
        if any(c % iters for c in names.values()):
            continue
        if len(tr.ops) in seen:
            tr.iters = iters
            return tr
        seen.add(len(tr.ops))
    return None


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    setup_s: float
    #: units (scans) completed in the measured window and its length
    units: int
    window_s: float
    #: host seconds of each call of each span in the window, by name
    times: dict
    #: counts of the work, from shapes (``harness/counts.py``)
    counts: dict
    trace: Trace | None = None


def jax_modules() -> list[str]:
    """Loaded modules whose top-level name is that of JAX or of the JAX
    package (compared as whole names: the port's own name begins with the
    JAX package's)."""
    import sys

    banned = {"jax", "jaxlib", "flax", "lidar_transfer_tpu"}
    return sorted({m.split(".")[0] for m in list(sys.modules)} & banned)
