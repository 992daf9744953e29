"""Host ms a PT-v3m1 train step waited for its batch from the Prefetcher
(read and upload of the points, the labels' lookup)."""

from harness.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "loader_wait")
