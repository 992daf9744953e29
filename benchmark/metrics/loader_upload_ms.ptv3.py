"""Host ms a PT-v3m1 train step's loader spent in its copies to the device
(the port's ``loader.upload`` spans in the traced stretch: each scan's
points, raw labels and label table)."""

from harness.port_spans import span_ms


def read(run):
    return span_ms(run, ("loader.upload",))
