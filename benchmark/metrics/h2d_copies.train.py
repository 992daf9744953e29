"""Blocking copies from the host to the device a train step (the port's
``*.upload`` spans in the traced stretch)."""

from harness.port_spans import span_count


def read(run):
    return span_count(run, ("*.upload",))
