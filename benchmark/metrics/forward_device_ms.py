"""Device ms a scan inside the ``infer`` span (the network's forward
and argmax)."""

from harness.readers import device_ms_per_unit


def read(run):
    return device_ms_per_unit(run, "infer")
