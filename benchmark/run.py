"""Run one cell of the benchmark of ``lidar_transfer_tpu_torch``.

    python3 benchmark/run.py --workload <config>.<traffic> --seed N \
        --seconds S --trace 0|1

One process: set-up (the cell's scans made on the card from the seed,
the port's model, the warm-up), a measured window of ``S``
seconds, with ``--trace 1`` a traced stretch, then the check of the
window's outputs against the plain reference. The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` (with ``--trace 1`` also ``busy_s`` and
``window_s`` of the stretch), with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared with its limit, which also end standard
error. It needs as many CUDA devices as the cell asks for.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [BENCH_DIR, ROOT]

from harness.common import (Run, Spans, find_cell, jax_modules,  # noqa
                            metric_reader, traced_stretch)


def work_class(loop: str):
    """The class of a traffic mix's ``loop``, ``"<module>:<class>"`` of
    ``harness/<module>.py``: a new loop is a new file."""
    import importlib

    module, cls = loop.split(":")
    return getattr(importlib.import_module(f"harness.{module}"), cls)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float = T0, work_dir: str | None = None) -> dict:
    """Set-up, window, traced stretch and check of ``cell``. -> the
    result's object (``checks`` last)."""
    import torch

    spans = Spans()
    data_dir = work_dir or os.path.join(tempfile.gettempdir(),
                                        "lidar-transfer-bench", cell.name)
    shutil.rmtree(data_dir, ignore_errors=True)
    cuda = device.type == "cuda"
    try:
        work = work_class(cell.traffic["loop"])(
            cell.config, cell.traffic, seed, device, data_dir, spans)
        if cuda:
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t0
        spans.times.clear()
        spans.marks.clear()
        units, window_s = work.window(seconds)
        times = {k: list(v) for k, v in spans.times.items()}
        _print_window(spans.marks, units, window_s, times)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        tr = None
        if trace:
            spans.trace = True
            tr = traced_stretch(work.periods, cell.traffic["trace_periods"],
                                work.span_names)
            spans.trace = False
            if tr is not None:
                tr.units = tr.iters * work.period
                names = sorted({n for n, _, _ in tr.device_spans})
                print(f"trace: {tr.iters} periods, {len(tr.ops)} device "
                      f"operations, device-side spans {names}")
            else:
                print("trace: no two traces agreed")
        work.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        readings = work.check()
        print(f"check: {time.perf_counter() - t_check:.1f} s")
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)

    # a reading without a limit is printed and not compared (PERF.md); a
    # limit without a reading, or no limit at all, is not correct
    checks = {k: (readings.get(k), lim) for k, lim in cell.limits.items()}
    print("readings not compared:", {k: v for k, v in readings.items()
                                     if k not in cell.limits})
    run = Run(cell, setup_s, units, window_s, times, work.counts, tr)
    metrics = {}
    for name, unit in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(name)(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(checks) and all(
               v is not None and v <= lim for v, lim in checks.values()),
           "attempted": units, "failed": 0, "metrics": metrics,
           "device": dev}
    if tr is not None:
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        out["breakdown"] = tr.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def _print_window(marks, units, window_s, times) -> None:
    """The window's scans a second in 2-second slices, and each host
    span's mean, median and 90th percentile."""
    if marks:
        print("window: scans a second in 2-second slices",
              [sum(1 for m in marks if lo <= m - marks[0] < lo + 2) / 2
               for lo in range(0, int(window_s) - 1, 2)])
    print("window:", units, "scans", f"in {window_s:.3f} s;",
          "host ms (mean, median, p90):", {
              k: [round(1e3 * f(v), 4) for f in
                  (statistics.mean, statistics.median,
                   lambda v: statistics.quantiles(v, n=10)[-1])]
              for k, v in times.items() if len(v) > 1})


def _gpu_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = find_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0))
    from lidar_transfer_tpu_torch import _build

    print("launches", json.dumps(_build.launch_counts()))
    print("torch", torch.__version__, "cuda", torch.version.cuda, "|",
          _gpu_line())
    found = jax_modules()
    if found:
        print(f"JAX or the JAX package was imported: {found}",
              file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out, allow_nan=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
