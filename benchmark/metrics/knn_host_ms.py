"""Host ms of a scan's kNN cleanup call (the port's ``postproc.knn`` span
in the traced stretch, its copy of the weights included)."""

from harness.port_spans import span_ms


def read(run):
    return span_ms(run, ("postproc.knn",))
