"""The port's own spans (``lidar_transfer_tpu_torch/utils/runtime``) read
against the traced stretch.

The port records its spans while the profiler records, from every thread,
but keeps them on its own clock (``time.perf_counter_ns``) and out of the
profiler's trace. They are placed on the trace's clock by pairs: each
benchmark span of the stretch that encloses exactly one port span
(``step`` one ``model.step``, ``infer`` one ``model.infer``) gives the
difference of the two starts, and the offset is the pairs' median. The
pairs are taken from the final attempt's stretch (``Trace.window``), so
the warm-up periods and earlier attempts are left out, and so is every
port span that starts outside the stretch.

Each reader returns None where there is nothing to read: no trace, a
program that records no spans, or pairs that do not match one to one or
whose differences spread by more than ``SPREAD_US``.
"""

from __future__ import annotations

import dataclasses
import statistics

#: the most the pairs' start differences may lie from their median (the
#: median of the absolute deviations), in microseconds: the true pairs
#: differ by the few microseconds between the two clocks' stamps, a pairing
#: shifted by a period by milliseconds
SPREAD_US = 200.0
#: (benchmark span, the port span it encloses once), tried in order
PAIRS = (("step", "model.step"), ("infer", "model.infer"))
#: the loader's own work, in which a device gap may begin
LOADER_WORK = ("loader.read", "loader.pad", "loader.project",
               "loader.labels")


@dataclasses.dataclass
class Placed:
    """A port span on the trace's clock, in microseconds."""

    name: str
    thread: str
    start: float
    end: float


def recorded():
    """The process's recorded spans, or None for a program without the
    recorder."""
    try:
        from lidar_transfer_tpu_torch.utils.runtime import RECORDER
    except ImportError:
        return None
    return RECORDER.spans()


def align(trace, spans, outer: str, inner: str):
    """The offset (µs) that takes the port's clock (``start_ns`` / 1e3) to
    the trace's, from the stretch's ``outer`` host spans and the run of
    ``inner`` port spans that matches them best. -> (offset, the median
    absolute deviation of the pairs' differences), or None."""
    hosts = sorted((s, e) for n, s, e in trace.host_spans if n == outer)
    ins = [(s.start_ns / 1e3, s.end_ns / 1e3) for s in spans
           if s.name == inner]
    if not hosts or len(ins) < len(hosts):
        return None
    best = None
    for k in range(len(ins) - len(hosts) + 1):
        d = [h[0] - p[0] for h, p in zip(hosts, ins[k:k + len(hosts)])]
        med = statistics.median(d)
        mad = statistics.median(abs(x - med) for x in d)
        if best is None or mad < best[0]:
            best = (mad, med, k)
    mad, off, k = best
    if mad > SPREAD_US:
        return None
    mine = ins[k:k + len(hosts)]
    for (hs, he), (ps, pe) in zip(hosts, mine):
        if not (hs - SPREAD_US <= ps + off and pe + off <= he + SPREAD_US):
            return None
    others = ins[:k] + ins[k + len(hosts):]
    if any(hs <= ps + off <= he for ps, _ in others for hs, he in hosts):
        return None
    return off, mad


def place(run, spans=None):
    """The port spans that start in the traced stretch, on the trace's
    clock, by the first pair of ``PAIRS`` whose benchmark span the stretch
    holds. ``spans``: the recorder's (``SpanRecord``s), by default the
    process's. -> [Placed], or None."""
    tr = run.trace
    if tr is None or not tr.units:
        return None
    spans = recorded() if spans is None else spans
    if not spans:
        return None
    held = {n for n, _, _ in tr.host_spans}
    pair = next((p for p in PAIRS if p[0] in held), None)
    found = pair and align(tr, spans, *pair)
    if not found:
        return None
    off, lo, hi = found[0], *tr.window
    return [Placed(s.name, s.thread, s.start_ns / 1e3 + off,
                   s.end_ns / 1e3 + off) for s in spans
            if lo <= s.start_ns / 1e3 + off <= hi]


def _per_unit(run, total: float) -> float:
    """``total`` over the stretch -> a step (``counts["batch"]`` scans) in
    a training cell, a scan otherwise."""
    return total / run.trace.units * run.counts.get("batch", 1)


def _named(placed, names):
    """The spans called one of ``names``; "*.x" stands for every name that
    ends in ".x"."""
    return [p for p in placed if any(
        p.name.endswith(n[1:]) if n.startswith("*") else p.name == n
        for n in names)]


def span_ms(run, names, spans=None):
    """Host ms a unit (a step or a scan) in the port spans ``names``."""
    placed = place(run, spans)
    chosen = placed and _named(placed, names)
    if not chosen:
        return None
    return _per_unit(run, sum(p.end - p.start for p in chosen) / 1e3)


def span_count(run, names, spans=None):
    """The port spans ``names`` a unit."""
    placed = place(run, spans)
    chosen = placed and _named(placed, names)
    return _per_unit(run, len(chosen)) if chosen else None


def idle_ms_in(run, names=LOADER_WORK, spans=None):
    """Device-idle ms a unit in the gaps that began while one of the port
    spans ``names`` was open (the gaps as ``Trace.breakdown`` finds
    them)."""
    placed = place(run, spans)
    opened = placed and [(p.start, p.end) for p in _named(placed, names)]
    if not opened:
        return None
    tr = run.trace
    idle, end = 0.0, tr.window[0]
    for _, s, d in sorted(tr.ops, key=lambda o: o[1]) + [
            ("", tr.window[1], 0.0)]:
        if s > end and any(lo <= end < hi for lo, hi in opened):
            idle += s - end
        end = max(end, s + d)
    return _per_unit(run, idle / 1e3)
