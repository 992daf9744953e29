"""PyTorch's first threaded ``torch.sqrt`` of a process on the CPU.

    python -m lidar_transfer_tpu_torch.probes.first_sqrt [--procs 40]
                                                          [--parallel 6]

Starts ``--procs`` fresh interpreters, ``--parallel`` at a time, twice:
once cold and once after :func:`lidar_transfer_tpu_torch.utils.runtime.
cpu_warmup`. Each builds the cloud of ``tests/test_torch_projection.py``'s
``test_range_project_matches`` (20,000 points from numpy seed 11, padded
to 24,576) and calls ``ops.projection.spherical_angles`` on it twice; the
two calls must agree bit for bit. Prints one JSON line a process (the
elements where depth or pitch differ, the largest relative difference of
depth, the thread count), then one with the count of processes that
differed in each mode. Needs no card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor


def one(warm: bool) -> dict:
    """In this process: the test's cloud through ``spherical_angles``
    twice (after :func:`cpu_warmup` when ``warm``); -> what differed."""
    import numpy as np
    import torch

    from lidar_transfer_tpu_torch.datasets import kitti
    from lidar_transfer_tpu_torch.ops.projection import spherical_angles
    from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup

    rng = np.random.default_rng(11)
    n = 20000
    pts = rng.normal(size=(n, 3)).astype(np.float32) * np.array(
        [20.0, 20.0, 2.0], np.float32)
    rem = rng.random(n).astype(np.float32)
    lbl = rng.choice(np.array((0, 10, 40, 50, 71), np.int32), size=n)
    p, *_ = kitti.pad_points(pts, rem, lbl, kitti.scan_capacity(n))
    points = torch.from_numpy(p)
    if warm:
        cpu_warmup()
    d1, _, p1 = spherical_angles(points)
    d2, _, p2 = spherical_angles(points)
    bad = (d1 != d2) | (p1 != p2)
    rel = ((d1 - d2).abs() / d2.clamp(min=1e-12)).max()
    return dict(warm=warm, threads=torch.get_num_threads(),
                points=int(points.shape[0]), differ=int(bad.sum()),
                max_rel_depth=float(rel))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=40,
                    help="fresh processes in each mode")
    ap.add_argument("--parallel", type=int, default=6,
                    help="processes running at a time")
    ap.add_argument("--one", choices=("cold", "warm"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.one == "warm")))
        return 0

    def spawn(mode):
        out = subprocess.run(
            [sys.executable, "-m", "lidar_transfer_tpu_torch.probes."
             "first_sqrt", "--one", mode], capture_output=True, text=True,
            check=True, timeout=600)
        return json.loads(out.stdout.strip().splitlines()[-1])

    summary = {}
    for mode in ("cold", "warm"):
        with ThreadPoolExecutor(args.parallel) as pool:
            res = list(pool.map(spawn, [mode] * args.procs))
        for r in res:
            print(json.dumps(r))
        summary[mode] = dict(processes=len(res),
                             differed=sum(r["differ"] > 0 for r in res))
    import torch

    print(json.dumps(dict(torch=torch.__version__, **summary)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
