"""Device time of a traced stretch by operation name: the readers of a
layer whose work the profiler's trace names but no benchmark span holds
(the port's own spans are not in the trace). Names are matched as the
breakdown prints them, by substring."""

from __future__ import annotations

from harness import counts


def steps(run):
    """Train steps in the traced stretch, or None without a trace."""
    tr = run.trace
    return tr.iters if tr is not None and tr.iters else None


def device_us(run, parts: tuple[str, ...]):
    """Summed device µs of the stretch's operations whose name holds one
    of ``parts``; None without a trace or without such an operation."""
    tr = run.trace
    if tr is None:
        return None
    us = sum(d for n, _, d in tr.ops if any(p in n for p in parts))
    return us or None


def ms_per_step(run, parts: tuple[str, ...]):
    us, n = device_us(run, parts), steps(run)
    return None if us is None or n is None else us / 1e3 / n


def roofline_share(run, parts: tuple[str, ...], nbytes: float):
    """% of the bound ``nbytes`` at the card's memory rate is of the
    device time of the operations named by ``parts`` in the stretch."""
    us = device_us(run, parts)
    if us is None or not nbytes:
        return None
    return 100.0 * nbytes / counts.H100_BYTES_PER_S / (us / 1e6)
