"""What the port's test modules share (not a test module).

Every ``test_torch_*`` module takes two rules that keep the suite inside its
clock, with ``from torch_suite import shared_cores, time_limit  # noqa: F401``:

- ``shared_cores``: under pytest-xdist the workers share the cores. Each
  worker, and every process it starts, runs ``max(1, cores // workers)``
  PyTorch and OpenMP threads; without xdist nothing is changed. The port's
  plain CPU versions are wavefronts of small tensor ops, which stall when
  each of N workers spins one thread a core.
- ``time_limit``: each test has ``LIMIT_S`` for its call and its
  function-scoped fixtures. Past it the test fails under its own name with
  a traceback; a test held in C code that never returns to the interpreter
  ends its process ``GRACE_S`` later, with every thread's stack on stderr.
"""

import dataclasses
import faulthandler
import functools
import os
import signal

import pytest

LIMIT_S = 300
GRACE_S = 30


def share_the_cores():
    """Under xdist, give this process and those it starts this worker's
    share of the cores; -> that share, or None without xdist."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        return None
    n = max(1, len(os.sched_getaffinity(0)) // int(workers))
    os.environ["OMP_NUM_THREADS"] = str(n)
    import torch

    torch.set_num_threads(n)
    return n


@pytest.fixture(scope="session", autouse=True)
def shared_cores():
    """Set before the module's first test and its module fixtures."""
    return share_the_cores()


@functools.cache
def _stderr(config):
    """A copy of the process's own stderr, past pytest's capture: where a
    stuck test's stacks go."""
    capture = config.pluginmanager.getplugin("capturemanager")
    if capture is None:
        return os.dup(2)
    with capture.global_and_fixture_disabled():
        return os.dup(2)


@pytest.fixture(autouse=True)
def time_limit(request):
    """Fail the test once it runs past ``LIMIT_S``; end the process if the
    test cannot be reached for ``GRACE_S`` more."""
    def over(signum, frame):
        pytest.fail(f"{request.node.nodeid} ran past its {LIMIT_S} s "
                    "time limit")

    old = signal.signal(signal.SIGALRM, over)
    signal.setitimer(signal.ITIMER_REAL, LIMIT_S)
    faulthandler.dump_traceback_later(LIMIT_S + GRACE_S, exit=True,
                                      file=_stderr(request.config))
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="session")
def narrow_spec(small_spec):
    """``small_spec``'s beams and fov over 64 columns: a quarter of its
    rays. A catmesh transfer from ``small_spec`` to it marches the same mesh
    (the merged image is at source dims) and casts fewer rays against it."""
    return dataclasses.replace(small_spec, name="test16n",
                               angle_res_hor=360.0 / 64.0)
