"""The command on the card (marked ``gpu``; skips without a CUDA device):
one short run of each cell, its line, and the control at a cell's size."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _cells():
    return [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_each_cell_runs_on_the_card(trace):
    _card()
    for name in _cells():
        out = subprocess.run(
            [sys.executable, "perfbench/run.py", "--workload", name, "--seed", "424242424242",
             "--seconds", "3", "--trace", str(trace)],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] is True, line["compared"]
        assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
        assert out.stderr.strip().splitlines()[-1].startswith("compared ")


@pytest.mark.gpu
def test_control_is_not_correct_on_the_card():
    """The TF32 control at t1.bulk's size (the smaller configuration) fails
    the cell's limits on three seeds."""
    _card()
    from perfbench.harness import cell as cell_mod
    from perfbench.harness import compare
    from perfbench.tools.readings import control_numbers

    c = cell_mod.load_cell(ROOT, "t1.bulk")
    for seed in (31, 32, 33):
        ok, _ = compare.verdict(control_numbers(c, seed, 1.0, "cuda"), c.limits)
        assert not ok
