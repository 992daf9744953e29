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
