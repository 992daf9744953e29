"""Host ms a PT-v3m1 train step's loader spent reading its scans (the
port's ``loader.read`` and ``loader.pad`` spans in the traced stretch)."""

from harness.port_spans import span_ms


def read(run):
    return span_ms(run, ("loader.read", "loader.pad"))
