"""Host ms of a scan's forward call (the port's ``model.infer`` span in
the traced stretch)."""

from harness.port_spans import span_ms


def read(run):
    return span_ms(run, ("model.infer",))
