"""The port's multi-host start (``repro_torch.launch.multihost.initialize``),
on the CPU: alone it starts no group and returns the single-process
numbers, as the reference's ``initialize`` does in a CPU container; given
``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and ``PROCESS_ID`` it joins a
gloo group over TCP (one process, and two joined at one coordinator, each in
a subprocess); a process count without a coordinator raises."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

from repro_torch.launch import multihost

SRC = Path(__file__).resolve().parent.parent / "src"
VARS = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")
CHILD = (
    "import json, torch.distributed as dist\n"
    "from repro_torch.launch import multihost\n"
    "out = multihost.initialize(device='cpu')\n"
    "out['backend'] = dist.get_backend() if dist.is_initialized() else None\n"
    "if dist.is_initialized():\n"
    "    dist.destroy_process_group()\n"
    "print(json.dumps(out))\n"
)


@pytest.fixture
def no_multihost_env(monkeypatch):
    for name in VARS:
        monkeypatch.delenv(name, raising=False)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(env_vars: dict) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items() if k not in VARS}
    env.update(PYTHONPATH=str(SRC), **env_vars)
    return subprocess.Popen([sys.executable, "-c", CHILD], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _result(proc) -> dict:
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.splitlines()[-1])


def test_single_process_starts_no_group(no_multihost_env):
    assert not dist.is_initialized()
    assert multihost.initialize(device="cpu") == {
        "process_index": 0, "process_count": 1, "local_devices": 1, "global_devices": 1}
    assert not dist.is_initialized()


def test_count_without_coordinator_raises(no_multihost_env, monkeypatch):
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.setenv("PROCESS_ID", "0")
    with pytest.raises(ValueError, match="coordinator=None"):
        multihost.initialize(device="cpu")
    monkeypatch.delenv("PROCESS_ID")
    with pytest.raises(ValueError, match="process_id=None"):
        multihost.initialize(coordinator="127.0.0.1:1", device="cpu")
    assert not dist.is_initialized()


def test_coordinator_and_one_process_start_a_gloo_group():
    port = _free_port()
    got = _result(_start({"COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "NUM_PROCESSES": "1",
                          "PROCESS_ID": "0"}))
    assert got == {"process_index": 0, "process_count": 1, "local_devices": 1,
                   "global_devices": 1, "backend": "gloo"}


def test_two_processes_join_one_group():
    port = _free_port()
    procs = [_start({"COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "NUM_PROCESSES": "2",
                     "PROCESS_ID": str(i)}) for i in range(2)]
    got = [_result(p) for p in procs]
    assert got == [{"process_index": i, "process_count": 2, "local_devices": 1,
                    "global_devices": 2, "backend": "gloo"} for i in range(2)]
