"""% of its roofline kernel F (the serialization codes,
``csrc/serialize.cu``) reaches in the traced stretch: its least bytes
(each point's cell and cloud read, its four codes written;
``harness/ptv3_counts.py``) at 3.35 TB/s over its device time."""

from harness import ptv3_counts
from harness.op_names import roofline_share


def read(run):
    counts = run.counts.get("stretch")
    if run.trace is None or not counts:
        return None
    return roofline_share(run, ("ptv3_serialize_kernel",),
                          ptv3_counts.serialize_bytes(counts))
