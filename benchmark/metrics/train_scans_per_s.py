"""Scans completed over the whole measured window (host clock)."""

from harness.readers import rate


def read(run):
    return rate(run)
