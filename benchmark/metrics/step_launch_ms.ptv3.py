"""Host ms of a PT-v3m1 train step's call (the port's ``model.step`` span
in the traced stretch: grid sampling, serialization, neighbour maps, the
forward, backward and AdamW launches and whatever waits among them)."""

from harness.port_spans import span_ms


def read(run):
    return span_ms(run, ("model.step",))
