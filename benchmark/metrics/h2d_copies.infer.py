"""Blocking copies from the host to the device a scan (the port's
``*.upload`` spans in the traced stretch: the loader's and the kNN's)."""

from harness.port_spans import span_count


def read(run):
    return span_count(run, ("*.upload",))
