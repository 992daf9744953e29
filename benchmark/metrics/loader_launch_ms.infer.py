"""Host ms a scan's loader spent launching the projection and the
features (the port's ``loader.project`` spans in the traced stretch)."""

from harness.port_spans import span_ms


def read(run):
    return span_ms(run, ("loader.project",))
