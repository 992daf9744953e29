"""Runtime utilities: the span recorder, stage timing, and the CPU warm-up
of the port.

The recorder keeps the port's spans: a name, the thread, the enclosing
span and start and end on ``time.perf_counter_ns()``, with small numbers
such as the ``bytes`` a copy moves. Spans open where the work happens, at
each layer boundary, and are named ``layer.part``: ``prefetch.load``,
``loader.read``, ``loader.pad``, ``loader.upload``, ``loader.project``,
``loader.labels``, ``model.step`` (``model.forward``, ``model.backward``,
``model.optimizer``), ``model.infer``, ``postproc.knn``
(``postproc.upload``), ``stage.<name>`` of a ``StageTimer`` and
``oracle.<name>`` of the catmesh oracle's stages. It records while a
``torch.profiler`` session records, from every thread, and inside
``tracing()``; otherwise ``span()`` costs one flag check and returns a
shared no-op. It never opens a profiler range of its own (a range that
launches kernels gets a device-side twin in the trace), except the empty
``profiler_anchor()``, by which ``add_to_chrome_trace`` places the spans
on a trace's time axis. Spans are kept in memory, in a bounded buffer a
thread name that drops its oldest span when full and counts the drops.

``StageTimer`` is the port's own copy of the JAX package's: named
wall-clock totals with the reference's printing (SURVEY.md §5 "Tracing /
profiling": lidar_deform.py:395,421-422, laserscan.py:874-917), and the
dict a harness reads (the reference's grid search scraped stdout by line
offset, grid_search_nframes_voxelsize.py:83-89). Its spans also go to the
recorder.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import sys
import threading
import time
from typing import NamedTuple

#: the name of the profiler range and span that ``profiler_anchor`` opens
ANCHOR = "lt.clock"


class SpanRecord(NamedTuple):
    """One finished span; times in ``time.perf_counter_ns()``."""

    name: str
    thread: str
    id: int
    #: the id of the span that was open on the same thread, or None
    parent: int | None
    start_ns: int
    end_ns: int
    attrs: dict


class _Buffer:
    """The spans of one thread name, the oldest dropped when full."""

    __slots__ = ("spans", "dropped", "_lock")

    def __init__(self, capacity: int):
        self.spans: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self._lock = threading.Lock()

    def add(self, record: SpanRecord) -> None:
        if len(self.spans) == self.spans.maxlen:
            with self._lock:
                self.dropped += 1
        self.spans.append(record)


class _Span:
    """An open span; ``set(**attrs)`` adds numbers known only inside."""

    __slots__ = ("_rec", "_state", "name", "attrs", "_id", "_parent",
                 "_t0")

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self._rec, self.name, self.attrs = rec, name, attrs

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        state = self._state = self._rec._thread_state()
        stack = state[0]
        self._parent = stack[-1] if stack else None
        self._id = next(self._rec._ids)
        stack.append(self._id)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        stack, buf, thread = self._state
        stack.pop()
        buf.add(SpanRecord(self.name, thread, self._id, self._parent,
                           self._t0, t1, self.attrs))
        return False


class _NoSpan:
    """The shared span of a recorder that is off."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class Recorder:
    """Spans in memory: one bounded buffer a thread name (the workers a
    loop starts one after another share it), each span's parent from a
    stack kept per thread."""

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = capacity
        #: open ``tracing()`` blocks
        self.tracing = 0
        self._buffers: dict[str, _Buffer] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)

    def _thread_state(self):
        """(the thread's stack of open span ids, its buffer, its name)"""
        try:
            return self._local.state
        except AttributeError:
            name = threading.current_thread().name
            with self._lock:
                buf = self._buffers.setdefault(name, _Buffer(self.capacity))
            self._local.state = ([], buf, name)
            return self._local.state

    def span(self, name: str, **attrs) -> _Span:
        """A span recorded whatever the flags say."""
        return _Span(self, name, attrs)

    def spans(self) -> list[SpanRecord]:
        """Every span kept, by start."""
        with self._lock:
            bufs = list(self._buffers.values())
        return sorted((s for b in bufs for s in list(b.spans)),
                      key=lambda s: s.start_ns)

    @property
    def dropped(self) -> int:
        """Spans dropped from full buffers since the last ``clear()``."""
        with self._lock:
            return sum(b.dropped for b in self._buffers.values())

    def clear(self) -> None:
        with self._lock:
            for b in self._buffers.values():
                b.spans.clear()
                b.dropped = 0


#: the process's recorder, which ``span()`` records into
RECORDER = Recorder()


def span(name: str, **attrs):
    """A span of the port, or the shared no-op. It records inside
    ``tracing()`` and while a ``torch.profiler`` session records (whose
    flag is a module global of ``torch.autograd.profiler``, the same for
    every thread). ``attrs``: small numbers, such as ``bytes``."""
    if not RECORDER.tracing:
        prof = sys.modules.get("torch.autograd.profiler")
        if prof is None or not prof._is_profiler_enabled:
            return _NO_SPAN
    return _Span(RECORDER, name, attrs)


@contextlib.contextmanager
def tracing():
    """Record the port's spans inside the block, profiler or not.
    -> the recorder."""
    with RECORDER._lock:
        RECORDER.tracing += 1
    try:
        yield RECORDER
    finally:
        with RECORDER._lock:
            RECORDER.tracing -= 1


def upload(array, device, name: str = "loader.upload"):
    """``torch.from_numpy(array).to(device)`` inside the span ``name``,
    with the array's ``bytes``. From pageable memory the copy waits for
    the work queued on the device before it, so the number of such spans
    is the number of blocking copies."""
    import torch

    with span(name, bytes=array.nbytes):
        return torch.from_numpy(array).to(device)


def profiler_anchor() -> None:
    """An empty profiler range ``ANCHOR`` (no device work inside) with the
    span of the same name: a point that the profiler's trace and the
    recorder both hold."""
    from torch.profiler import record_function

    with record_function(ANCHOR), span(ANCHOR):
        pass


def add_to_chrome_trace(path: str) -> int:
    """Add the recorder's spans that began between its last two anchors
    to the Chrome trace at ``path``, which holds the two anchors' ranges:
    complete events on the trace's time axis (the two anchors give the
    offset and the drift), one row a thread name. -> spans added."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    marks = sorted((e for e in events if e.get("name") == ANCHOR
                    and e.get("ph") == "X"), key=lambda e: e["ts"])
    spans = RECORDER.spans()
    anchors = [s for s in spans if s.name == ANCHOR][-2:]
    if len(marks) < 2 or len(anchors) < 2:
        raise ValueError(f"{path} and the recorder need two {ANCHOR} "
                         f"anchors each; found {len(marks)} and "
                         f"{len(anchors)}")
    # the ends are paired: a profiler range's start lags by its set-up
    # (up to a millisecond at a session's first range), its end hardly
    e0, e1 = (m["ts"] + m["dur"] for m in (marks[0], marks[-1]))
    a0, a1 = anchors
    scale = (e1 - e0) / ((a1.end_ns - a0.end_ns) / 1e3)
    pid = marks[0]["pid"]
    first_tid = 1 + max((e["tid"] for e in events
                         if isinstance(e.get("tid"), int)), default=0)
    rows: dict[str, int] = {}
    added = []
    for s in spans:
        if s.name == ANCHOR or not a0.start_ns <= s.start_ns <= a1.end_ns:
            continue
        if s.thread not in rows:
            rows[s.thread] = tid = first_tid + len(rows)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid,
                           "args": {"name": f"port spans: {s.thread}"}})
        added.append({
            "ph": "X", "cat": "port_span", "name": s.name, "pid": pid,
            "tid": rows[s.thread],
            "ts": e0 + (s.start_ns - a0.end_ns) / 1e3 * scale,
            "dur": (s.end_ns - s.start_ns) / 1e3 * scale,
            "args": dict(s.attrs, id=s.id, parent=s.parent)})
    events.extend(added)
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(added)


class StageTimer:
    """Named wall-clock stage spans with reference-compatible printing;
    each span is also the recorder's ``stage.<name>``."""

    def __init__(self, verbose: bool = True):
        self.verbose = verbose
        self.spans: dict[str, float] = {}
        self.counts: dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str, items: float = 1.0):
        t0 = time.perf_counter()
        try:
            with span(f"stage.{name}", items=items):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.spans[name] = self.spans.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0.0) + items

    def rate(self, name: str) -> float:
        dt = self.spans.get(name, 0.0)
        return self.counts.get(name, 0.0) / dt if dt > 0 else 0.0

    def report(self) -> dict[str, dict[str, float]]:
        return {k: {"seconds": v, "items": self.counts[k],
                    "per_sec": self.rate(k)} for k, v in self.spans.items()}

    def print_reference_style(self) -> None:
        """Emit the fields the reference printed (FPS / rays/sec / Took)."""
        if not self.verbose:
            return
        for name, dt in self.spans.items():
            print(f"[{name}] {dt:.2f}s ({self.rate(name):.2f}/s)")


def cpu_warmup() -> None:
    """Take PyTorch's first large threaded float32 ``asin`` and ``sqrt``
    of the process on the CPU. The first such call of a process is at
    times off by up to 3e-4 relative in one thread's share of the elements
    (torch 2.13.0+cpu, 8 threads: 4 of 60 fresh processes); no later call
    is, and after this no first one was (``python -m
    lidar_transfer_tpu_torch.probes.first_sqrt``). Port only: the JAX
    package's runtime has no counterpart."""
    import torch

    x = torch.zeros(1 << 21)
    torch.asin(x)
    torch.sqrt(x)
