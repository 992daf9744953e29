"""Copies from the host to the device a PT-v3m1 train step (the port's
``*.upload`` spans in the traced stretch)."""

from harness.port_spans import span_count


def read(run):
    return span_count(run, ("*.upload",))
