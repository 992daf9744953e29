"""Runtime utilities: stage timing, and the CPU warm-up of the port.

The port's own copy of ``StageTimer`` from
``lidar_transfer_tpu/utils/runtime.py``.

Replaces the reference's ad-hoc ``time.time()`` spans and printed FPS fields
(SURVEY.md §5 "Tracing / profiling": lidar_deform.py:395,421-422,
laserscan.py:874-917) with a structured timer that still *prints* the same
human-readable fields, plus machine-readable access for harnesses (the
reference's grid search scraped stdout by line offset,
grid_search_nframes_voxelsize.py:83-89 — our harness reads the dict).
"""

from __future__ import annotations

import contextlib
import time


class StageTimer:
    """Named wall-clock stage spans with reference-compatible printing."""

    def __init__(self, verbose: bool = True):
        self.verbose = verbose
        self.spans: dict[str, float] = {}
        self.counts: dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str, items: float = 1.0):
        t0 = time.perf_counter()
        try:
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
