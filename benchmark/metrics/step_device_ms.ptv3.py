"""Summed device ms of a PT-v3m1 train step's operations in the traced
stretch."""

from harness.readers import device_ms_per_unit


def read(run):
    ms = device_ms_per_unit(run)
    return None if ms is None else ms * run.counts["batch"]
