"""Host ms a train step waited for its batch from the Prefetcher (read,
project, features, labels)."""

from harness.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "loader_wait")
