"""% of the PT-v3m1 traced stretch in which no device operation ran."""

from harness.readers import idle_share


def read(run):
    return idle_share(run)
