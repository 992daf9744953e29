"""% of the bf16 peak a train step reaches: the convolutions' operations
of the forward and the backward (3x the forward, counted from the
configuration's shapes) over the step's wall time in the measured window."""

from harness.readers import flops_share


def read(run):
    return flops_share(run, run.counts["step_flops"], run.counts["batch"])
