"""Timing on the card and the card's name, for the probes and
``chip_smoke.py``."""

from __future__ import annotations

import subprocess


def gpu_line() -> str:
    """The first card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` between CUDA events, after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def device_events(fn, iters: int, warmup: int = 2):
    """The device operations (kernels, memsets, copies) that ``iters``
    calls of ``fn`` issue, as ``torch.profiler`` events. A trace can lose
    the records of its first few device operations (five of them, in a
    process that has traced before, on the H100 this was written on), so
    32 small fills and ``warmup`` calls run inside the trace ahead of a
    synchronise and a marked range, and only operations that start in the
    range are returned."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    mark = "lt_device_events_measured"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(32):
            torch.zeros(1, device="cuda")
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        with record_function(mark):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    events = prof.events()
    ranges = [e.time_range for e in events
              if e.name == mark and e.device_type == DeviceType.CPU]
    if not ranges:
        return []
    return [e for e in events if e.device_type == DeviceType.CUDA
            and e.name != mark
            and ranges[0].start <= e.time_range.start <= ranges[0].end]


def whole_trace(fn, iters: int, warmup: int = 2, attempts: int = 5):
    """:func:`device_events` of ``iters`` calls of ``fn``, taken until two
    traces hold the same number of operations, each operation's count a
    multiple of ``iters`` (a trace that lost records fails one or the
    other); -> the later of the two, or [] after ``attempts`` traces."""
    seen = set()
    for _ in range(attempts):
        on_dev = device_events(fn, iters, warmup)
        names = {}
        for e in on_dev:
            names[e.name] = names.get(e.name, 0) + 1
        if not on_dev or any(n % iters for n in names.values()):
            continue
        if len(on_dev) in seen:
            return on_dev
        seen.add(len(on_dev))
    return []


def device_ms(fn, iters: int, warmup: int = 2):
    """What the card itself spends on one call of ``fn``: the summed
    durations of the device operations of ``iters`` calls
    (:func:`whole_trace`) over ``iters``. The time between the operations
    and the host's time to issue them are not in it, which is what tells
    it from :func:`cuda_ms` for a call of a few microseconds.
    -> (ms a call, device operations a call, {operation name: count a
    call}); (None, 0, {}) when no trace was whole."""
    on_dev = whole_trace(fn, iters, warmup)
    if not on_dev:
        return None, 0, {}
    names = {}
    for e in on_dev:
        names[e.name] = names.get(e.name, 0) + 1
    total_us = sum(e.time_range.elapsed_us() for e in on_dev)
    return (total_us / 1e3 / iters, len(on_dev) // iters,
            {k: n // iters for k, n in names.items()})


def bf16_ulp(x):
    """One bf16 ulp at |x| (8 bits of mantissa), float32."""
    import torch

    e = torch.floor(torch.log2(torch.clamp(x.abs(), min=2.0 ** -126)))
    return torch.exp2(e - 7)


def max_diff(got, ref, what: str) -> float:
    """Hold kernel outputs ``got`` against plain ``ref`` (tuples of
    tensors): integer outputs equal, bf16/float outputs within one bf16
    ulp of the plain value. Raises AssertionError otherwise; -> the
    largest absolute difference."""
    import torch

    worst = 0.0
    for i, (a, b) in enumerate(zip(got, ref, strict=True)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{what}: output {i} is {a.dtype} "
                                 f"{tuple(a.shape)}, plain {b.dtype} "
                                 f"{tuple(b.shape)}")
        d = (a.float() - b.float()).abs()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
        if a.dtype.is_floating_point:
            ok = bool((d <= bf16_ulp(b.float())).all())
        else:
            ok = torch.equal(a, b)
        if not ok:
            raise AssertionError(f"{what}: output {i} differs from its "
                                 f"plain version (max |diff| {worst:g})")
    return worst
