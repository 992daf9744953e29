"""Device ms a PT-v3m1 train step spends in patch attention's kernels
(PyTorch's fused scaled-dot-product attention, forward and backward),
attributed by their names in the traced stretch."""

from harness.op_names import ms_per_step

NAMES = ("flash", "fmha", "attention", "sdpa")


def read(run):
    return ms_per_step(run, NAMES)
