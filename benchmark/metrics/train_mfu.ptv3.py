"""% of the bf16 peak a PT-v3m1 train step reaches: the products'
operations of the measured window's steps (linears a point, sparse
convolutions an occupied neighbour pair, attention a query-key pair of a
padded patch, 3x for the backward; ``harness/ptv3_counts.py``, from the
program's counters) over the window's wall time."""

from harness import ptv3_counts
from harness.readers import flops_share


def read(run):
    counts = run.counts.get("window")
    if not counts or not counts["steps"]:
        return None
    return flops_share(run, ptv3_counts.train_flops(run.cell.config, counts),
                       run.units)
