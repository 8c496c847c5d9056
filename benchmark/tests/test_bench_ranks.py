"""The training driver across processes, two gloo ranks on the CPU: the
reference steps the global batch in one process and the run is correct;
with the gradients' exchange left out it is not; the control (the
reference on every rank, gradients averaged) runs through the same
driver."""

import json
import socket
import subprocess
import sys

import pytest

from benchmark.harness import ROOT


def _port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("fault, expect", [("none", True), ("exchange", False), ("control", True)])
def test_two_ranks(fault, expect):
    port = str(_port())
    cmd = [sys.executable, "-m", "benchmark.tests.ranks"]
    other = subprocess.Popen(cmd + ["1", "2", port, fault], cwd=ROOT, stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
    try:
        out = subprocess.run(cmd + ["0", "2", port, fault], cwd=ROOT, capture_output=True, text=True, timeout=300)
    finally:
        other.wait(timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads([ln for ln in out.stdout.splitlines() if ln.startswith('{"correct"')][-1])
    assert line["correct"] is expect, line["checks"]
    assert other.returncode == 0
