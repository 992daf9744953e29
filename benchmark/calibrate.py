"""The readings that a cell's check limits are set from.

    python3 benchmark/calibrate.py --workload <cell> --seconds S SEED...

For each seed, in one process: the cell's set-up and a window of ``S``
seconds at the cell's own load, then the check of the program against
the plain reference (the lower reading) and of the control, the reference
one precision below the configuration's (float8 for the network's
bfloat16), and for training of the planted half-batch fault (the upper
readings). One JSON line a seed. The benchmark's own runs never run the
control.
"""

import gc
import json
import os
import sys
import tempfile
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

from harness.common import Spans, find_cell  # noqa: E402


def main(argv=None) -> int:
    import argparse

    import torch

    from run import work_class

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("seeds", type=int, nargs="+")
    args = p.parse_args(argv)
    cell = find_cell(args.workload)
    device = torch.device("cuda", 0)
    data_dir = os.path.join(tempfile.gettempdir(), "lidar-transfer-bench",
                            "calibrate")
    for seed in args.seeds:
        t0 = time.perf_counter()
        work = work_class(cell.traffic["loop"])(
            cell.config, cell.traffic, seed, device, data_dir, Spans())
        units, window_s = work.window(args.seconds)
        work.release()
        gc.collect()
        torch.cuda.empty_cache()
        row = {"seed": seed, "scans": units, "window_s": window_s}
        sides = [("program", None), ("control", "control")]
        if "half_batch" in getattr(work, "stand_ins", ()):
            sides.append(("half_batch", "half_batch"))
        for side, stand_in in sides:
            t = time.perf_counter()
            row[side] = work.check(stand_in)
            row[side + "_s"] = time.perf_counter() - t
        row["total_s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        del work
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
