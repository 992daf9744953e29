"""Small helpers of the metric readers (``metrics/<name>.py``). Each
returns None where the run holds nothing to read."""

from __future__ import annotations

from harness import counts


def mean_span_ms(run, name: str):
    """Mean host ms of the span ``name`` in the measured window."""
    t = run.times.get(name)
    return 1e3 * sum(t) / len(t) if t else None


def device_ms_per_unit(run, span: str | None = None):
    """Device ms a scan of the traced stretch: of every operation, or of
    those inside the device-side ranges of ``span``."""
    tr = run.trace
    if tr is None or not tr.units:
        return None
    us = (sum(d for _, _, d in tr.ops) if span is None
          else tr.device_us_in(span))
    return us / 1e3 / tr.units if us else None


def idle_share(run):
    """% of the traced stretch in which no device operation ran."""
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def rate(run):
    """Scans a second over the whole measured window."""
    return run.units / run.window_s if run.window_s > 0 else None


def flops_share(run, flops: float, per_units: float):
    """% of the bf16 peak: ``flops`` done every ``per_units`` scans of
    the measured window, over the wall time they took."""
    if not run.units:
        return None
    seconds = run.window_s / run.units * per_units
    return 100.0 * flops / counts.H100_BF16_FLOPS / seconds
