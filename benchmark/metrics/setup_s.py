"""Seconds from the start of the process to the first measured unit:
imports, the scans made and written, the program built and warmed up."""


def read(run):
    return run.setup_s
