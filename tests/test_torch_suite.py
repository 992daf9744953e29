"""The rules of ``tests/torch_suite.py`` that keep the suite inside its clock:
each test's time limit, and the cores shared among pytest-xdist workers.

A case that needs its own session runs a throwaway test file in a fresh
``python -m pytest`` beside a copy of ``torch_suite.py``, so the outer
session's limit and thread count do not mix with the ones under test.
"""

import glob
import json
import os
import subprocess
import sys
import textwrap
import xml.etree.ElementTree as ET

import torch

import torch_suite
from torch_suite import shared_cores, time_limit  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
RULES = "from torch_suite import"


def _session(tmp_path, body, *args, edits=()):
    """Run ``body`` as a test file beside a copy of ``torch_suite.py`` with
    ``edits`` made to it; -> the process and its junit test cases by
    name."""
    with open(os.path.join(HERE, "torch_suite.py")) as f:
        suite = f.read()
    for old, new in edits:
        assert old in suite
        suite = suite.replace(old, new)
    (tmp_path / "torch_suite.py").write_text(suite)
    (tmp_path / "test_throwaway.py").write_text(
        f"{RULES} shared_cores, time_limit  # noqa: F401\n"
        + textwrap.dedent(body))
    # the installed plugins (one imports jax) stay out: ``-p`` names any
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_") and k != "OMP_NUM_THREADS"}
    env["PYTEST_DISABLE_PLUGIN_AUTOLOAD"] = "1"
    xml = tmp_path / "out.xml"
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         f"--junitxml={xml}", "test_throwaway.py", *args],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=180)
    cases = {}
    if xml.exists():
        for case in ET.parse(xml).iter("testcase"):
            cases[case.get("name")] = case
    return proc, cases


def test_a_test_past_its_limit_fails_and_the_next_one_runs(tmp_path):
    """A test that sleeps past a 2 s limit fails within a few seconds of it,
    with the line it was on in its traceback; the next test passes."""
    proc, cases = _session(tmp_path, """
        import time


        def test_sleeps_past_its_limit():
            time.sleep(60)


        def test_next_one_passes():
            assert True
        """, edits=[("LIMIT_S = 300", "LIMIT_S = 2")])
    assert proc.returncode == 1, proc.stdout + proc.stderr
    slept = cases["test_sleeps_past_its_limit"]
    failure = slept.find("failure")
    assert failure is not None
    assert "ran past its 2 s time limit" in failure.get("message")
    assert "time.sleep(60)" in failure.text
    assert float(slept.get("time")) < 2 + 5
    nxt = cases["test_next_one_passes"]
    assert nxt.find("failure") is None and nxt.find("error") is None
    assert "1 failed, 1 passed" in proc.stdout


def test_a_test_held_in_c_code_ends_its_process_with_every_stack(tmp_path):
    """A test the signal cannot reach (a loop in C that never returns to the
    interpreter) ends its process ``GRACE_S`` after its limit, with the
    stacks on the process's own stderr, past pytest's capture."""
    proc, _ = _session(tmp_path, """
        def test_held_in_c():
            sum(range(10 ** 15))
        """, edits=[("LIMIT_S = 300", "LIMIT_S = 1"),
                    ("GRACE_S = 30", "GRACE_S = 2")])
    assert proc.returncode != 0
    assert "Timeout (0:00:03)!" in proc.stderr, proc.stderr[-4000:]
    assert "test_held_in_c" in proc.stderr


def test_xdist_workers_share_the_cores(tmp_path):
    """Under ``-n 2`` a worker and the process it starts run
    ``max(1, cores // 2)`` threads, and ``OMP_NUM_THREADS`` says so."""
    out = tmp_path / "threads.json"
    proc, _ = _session(tmp_path, f"""
        import json
        import os
        import subprocess
        import sys

        import torch


        def test_record_threads():
            child = subprocess.run(
                [sys.executable, "-c",
                 "import torch; print(torch.get_num_threads())"],
                capture_output=True, text=True, timeout=120)
            with open({str(out)!r}, "w") as f:
                json.dump(dict(torch=torch.get_num_threads(),
                               child=int(child.stdout),
                               omp=os.environ.get("OMP_NUM_THREADS")), f)
        """, "-p", "xdist", "-n", "2")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    want = max(1, len(os.sched_getaffinity(0)) // 2)
    assert json.loads(out.read_text()) == dict(torch=want, child=want,
                                               omp=str(want))


def test_without_xdist_nothing_changes(monkeypatch):
    """Outside xdist the share is None, and PyTorch's count and
    ``OMP_NUM_THREADS`` are left as they were."""
    monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT", raising=False)
    before = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    assert torch_suite.share_the_cores() is None
    assert (torch.get_num_threads(),
            os.environ.get("OMP_NUM_THREADS")) == before


def test_every_port_test_module_takes_both_rules():
    """A ``test_torch_*`` module without the import would run its tests
    at every worker's full thread count and without a limit."""
    without = []
    for path in glob.glob(os.path.join(HERE, "test_torch_*.py")):
        with open(path) as f:
            if not any(line.startswith(RULES) and "shared_cores" in line
                       and "time_limit" in line for line in f):
                without.append(os.path.basename(path))
    assert without == []
