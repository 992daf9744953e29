"""The train step's levers, one variant after another, on the card.

The port's counterpart of ``scripts/probe_train_remat.py``:

  python -m lidar_transfer_tpu_torch.probes.train_levers
      [--arch darknet21,darknet53] [--variants base,remat,mu_bf16,
      remat_mu_bf16] [--iters 10] [--batch 2] [--tiny] [--out PATH]
      [--device cuda|cpu]

For each architecture and variant it builds RangeNet (34 classes, bf16
compute, float32 parameters) at batch 2 and 64x2048x5 (``--tiny``: the
tiny network at 16x64, for the CPU), takes steps on a batch of ones with
label 0 and weight 1, as the original, and writes one row each:

  * ``remat``: ``RangeNetConfig.remat``, the encoder's residual blocks
    recomputed in the backward pass (``torch.utils.checkpoint``);
  * ``mu_bf16``: ``models.BF16MomentAdam``, Adam with its first moment
    stored in bfloat16 (``optax.adam(mu_dtype=jnp.bfloat16)``);
  * ``remat_mu_bf16``: both.

The original's ``donate`` lever (and ``remat_donate``, ``all3``) has no
counterpart: PyTorch's optimizer updates the parameters and moments in
place already, which is what donating the buffers buys XLA. A variant that
names it exits 2. XLA's cost analysis has no counterpart either: the
operations are the convolutions' (``bounds.conv_flops`` of the batch, three
times for a train step, ``bounds.train_step``) and ``mfu`` is the share of
the H100's bf16 tensor-core rate they reach; in place of the bytes
accessed, ``peak_gib`` is the step's peak device memory
(``torch.cuda.max_memory_allocated``).

A step is timed after two warm-up steps: ``step_ms`` is the median of
``--iters`` steps, each between CUDA events and synchronised (the host
clock on the CPU); ``device_ms`` is the summed durations of one step's
device operations (``timing.device_ms``) and ``idle_share`` is
``1 - device_ms / step_ms``; ``final_loss`` is the last step's loss.
Device numbers are None on the CPU, where they are not measured. Rows are
written to ``--out`` (default ``train_levers.json`` in the temporary
directory) after each variant. It runs on the card unless ``--device cpu``
is given; without a CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

VARIANTS = ("base", "remat", "mu_bf16", "remat_mu_bf16")
#: the original's variants that donate buffers to the step
DONATING = ("donate", "remat_donate", "all3")
#: the keys of a row
ROW_KEYS = ("arch", "variant", "batch", "remat", "mu_bf16", "step_ms",
            "step_ms_min", "step_ms_max", "device_ms", "idle_share",
            "flops_per_step", "bound_ms", "mfu", "peak_gib", "final_loss")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("train_levers (torch)")
    ap.add_argument("--arch", default="darknet21,darknet53")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny network at 16x64 (numbers meaningless)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "train_levers.json"))
    ap.add_argument("--device", default="cuda",
                    help="Torch device (default cuda; cpu only when asked "
                         "for).")
    return ap


def _step_times(torch, step, iters: int, cuda: bool) -> list[float]:
    """ms of each of ``iters`` synchronised steps."""
    times = []
    for _ in range(iters):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            step()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t = time.perf_counter()
            step()
            times.append((time.perf_counter() - t) * 1e3)
    return times


def run_variant(arch: str, variant: str, *, batch: int = 2,
                iters: int = 10, tiny: bool = False, device="cuda",
                device_time: bool = True) -> dict:
    """One row: ``arch`` (darknet21, darknet53; ignored with ``tiny``)
    under ``variant`` (one of ``VARIANTS``). ``device_time=False`` leaves
    out the profiler's device time (and the idle share), which takes
    several traced steps."""
    import torch

    from lidar_transfer_tpu_torch.models import (RangeNet, RangeNetConfig,
                                                 make_train_state,
                                                 train_step)
    from lidar_transfer_tpu_torch.probes import bounds
    from lidar_transfer_tpu_torch.probes.timing import device_ms

    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (one of {VARIANTS})")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    remat = "remat" in variant
    mu_bf16 = "mu_bf16" in variant
    h, w = (16, 64) if tiny else (64, 2048)
    cfg = dataclasses.replace(
        getattr(RangeNetConfig, "tiny" if tiny else arch)(num_classes=34),
        remat=remat)
    model = RangeNet(cfg).to(dev)
    opt = make_train_state(model, torch.Generator().manual_seed(0),
                           mu_bf16=mu_bf16)
    tb = dict(features=torch.ones((batch, h, w, cfg.input_channels),
                                  device=dev),
              labels=torch.zeros((batch, h, w), dtype=torch.int32,
                                 device=dev),
              weights=torch.ones((batch, h, w), device=dev))
    sb = bounds.train_step(bounds.conv_flops(model, tb["features"]))
    last = []

    def step():
        last[:] = [train_step(model, opt, tb)]

    for _ in range(2):
        step()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    times = _step_times(torch, step, iters, cuda)
    loss = float(last[0])
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30 if cuda
            else None)
    d_ms = device_ms(step, 2, warmup=1)[0] if cuda and device_time \
        else None
    step_ms = float(np.median(times))
    return {"arch": "tiny" if tiny else arch, "variant": variant,
            "batch": batch, "remat": remat, "mu_bf16": mu_bf16,
            "step_ms": step_ms, "step_ms_min": min(times),
            "step_ms_max": max(times), "device_ms": d_ms,
            "idle_share": None if d_ms is None else 1 - d_ms / step_ms,
            "flops_per_step": sb.flops, "bound_ms": sb.ms,
            "mfu": sb.ms / step_ms if cuda else None,
            "peak_gib": peak, "final_loss": loss}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from lidar_transfer_tpu_torch.probes.timing import device_line

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: train_levers (torch) runs on the card (pass "
              "--device cpu to run on the CPU)", file=sys.stderr)
        return 2
    variants = args.variants.split(",")
    donating = [v for v in variants if v in DONATING]
    if donating:
        print(f"variants {donating}: donation has no counterpart in "
              "PyTorch, whose optimizer updates parameters and moments in "
              f"place already (variants: {', '.join(VARIANTS)})",
              file=sys.stderr)
        return 2
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        print(f"unknown variants {unknown} (variants: "
              f"{', '.join(VARIANTS)})", file=sys.stderr)
        return 2
    h, w = (16, 64) if args.tiny else (64, 2048)
    where = device_line(device)
    rows = []
    for arch in (("tiny",) if args.tiny else args.arch.split(",")):
        for variant in variants:
            row = run_variant(arch, variant, batch=args.batch,
                              iters=args.iters, tiny=args.tiny,
                              device=device)
            rows.append(row)
            dev_txt = ("not measured" if row["device_ms"] is None else
                       f"device {row['device_ms']:.3f} ms, idle "
                       f"{row['idle_share']:.3f}, mfu {row['mfu']:.4f}, "
                       f"peak {row['peak_gib']:.2f} GiB")
            print(f"{row['arch']:10s} {variant:14s}: "
                  f"{row['step_ms']:8.3f} ms/step (min "
                  f"{row['step_ms_min']:.3f}, max {row['step_ms_max']:.3f})"
                  f", {dev_txt}, loss {row['final_loss']:.6f} [{where}]",
                  flush=True)
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"rows": rows, "iters": args.iters, "h": h,
                           "w": w, "device": where}, f, indent=2)
    print(json.dumps(rows, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
