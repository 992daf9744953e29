"""Host ms a train step's loader spent launching the projection, the
features and the labels (the port's ``loader.project`` and
``loader.labels`` spans in the traced stretch)."""

from harness.port_spans import span_ms


def read(run):
    return span_ms(run, ("loader.project", "loader.labels"))
