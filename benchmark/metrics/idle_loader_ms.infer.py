"""Device-idle ms a scan in the gaps that began while the loader thread
read, padded or projected (the port's ``loader.*`` spans other than its
copies, against the traced stretch's device operations)."""

from harness.port_spans import idle_ms_in


def read(run):
    return idle_ms_in(run)
