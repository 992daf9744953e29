"""% of the bf16 peak a labelled scan reaches: the forward's convolution
operations over the scan's wall time in the measured window."""

from harness.readers import flops_share


def read(run):
    return flops_share(run, run.counts["scan_flops"], 1)
