"""Device-idle ms a PT-v3m1 train step in the gaps that began while the
loader thread read its scans or launched the labels' lookup (the port's
``loader.*`` spans other than its copies, against the traced stretch's
device operations)."""

from harness.port_spans import idle_ms_in


def read(run):
    return idle_ms_in(run)
