"""Host ms a PT-v3m1 train step's loader spent launching the labels'
lookup on the device (the port's ``loader.labels`` spans in the traced
stretch; the point branch has no projection)."""

from harness.port_spans import span_ms


def read(run):
    return span_ms(run, ("loader.project", "loader.labels"))
