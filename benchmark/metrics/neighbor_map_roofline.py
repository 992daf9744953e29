"""% of its roofline kernel E (the neighbour map, ``csrc/neighbor_map.cu``)
reaches in the traced stretch: its least bytes (each cell read once, each
entry written once; ``harness/ptv3_counts.py``, from the stretch's
counters) at 3.35 TB/s over the device time of its two kernels."""

from harness import ptv3_counts
from harness.op_names import roofline_share


def read(run):
    counts = run.counts.get("stretch")
    if run.trace is None or not counts:
        return None
    return roofline_share(run, ("ptv3_neighbor_",),
                          ptv3_counts.neighbor_bytes(run.cell.config, counts))
