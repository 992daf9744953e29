"""Host ms a scan waited for its read and projection from the
Prefetcher."""

from harness.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "loader_wait")
