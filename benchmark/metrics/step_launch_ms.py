"""Host ms of a train step's call (the port's ``model.step`` span in the
traced stretch: the forward, backward and Adam launches and whatever
waits among them)."""

from harness.port_spans import span_ms


def read(run):
    return span_ms(run, ("model.step",))
