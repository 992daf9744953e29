"""Device ms a scan inside the ``knn`` span (``knn_cleanup``)."""

from harness.readers import device_ms_per_unit


def read(run):
    return device_ms_per_unit(run, "knn")
