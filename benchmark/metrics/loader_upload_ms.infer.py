"""Host ms a scan's loader spent in its copies to the device (the port's
``loader.upload`` spans in the traced stretch)."""

from harness.port_spans import span_ms


def read(run):
    return span_ms(run, ("loader.upload",))
