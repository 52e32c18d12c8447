"""The harness's ``"coo"`` form on the card (marked ``gpu``; skips without a
CUDA device): ``mf2327.json``, square n = 2327 at 99.85%, J = 8, the direct
Gram solve, k = 32, 300 epochs, its matrix drawn from its ``matrix_seed``,
through ``run_cell`` on the matrix-free path and judged by the test
reference. Each run prints its result line."""
import json
import time
from pathlib import Path

import pytest

from perfbench.harness import cell as cell_mod
from perfbench.tests import matfree_ref

HERE = Path(__file__).resolve().parent
SEEDS = {False: 2900000701, True: 2900000702}
PEAK_SEEDS = (2900003101, 2900003102, 2900003103)


def _mf2327(monkeypatch):
    """The configuration as a cell, with the test reference routed in;
    skips without a CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = json.loads((HERE / "mf2327.json").read_text())
    e2e = ["solve_ms", "peak_mem_gb", "setup_s"]
    layer = ["prepare_s", "idle_share.solve", "launches_per_epoch", "mfu.solve"]
    monkeypatch.setattr(cell_mod, "load_reference", lambda config: matfree_ref)
    return cell_mod.Cell("mf2327.batch", spec["config"], spec["mix"], spec["limits"], e2e,
                         layer, {"solve_ms": "ms", "peak_mem_gb": "GB", "setup_s": "s",
                                 "prepare_s": "s", "idle_share.solve": "%",
                                 "launches_per_epoch": "launches/epoch", "mfu.solve": "%"})


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [False, True])
def test_mf2327_is_correct_on_the_card(monkeypatch, trace):
    t0 = time.perf_counter()
    c = _mf2327(monkeypatch)
    out = cell_mod.run_cell(c, SEEDS[trace], 10.0, trace, "cuda", t0)
    print(f"mf2327 trace={int(trace)} seed={SEEDS[trace]}: {json.dumps(out)}")
    assert out["correct"] is True, out["compared"]
    assert out["failed"] == 0 and out["attempted"] > 0
    if trace:
        assert "mfu.solve" not in out["metrics"]  # the dense counts read None here
        assert out["device"]["busy_s"] > 0


@pytest.mark.gpu
def test_mf2327_window_peak_repeats_across_run_seeds(monkeypatch):
    """Three run seeds under the configuration's matrix_seed solve one
    matrix, each with its own right-hand sides: every run is correct under
    its limits, and the window's peak bytes are equal."""
    c = _mf2327(monkeypatch)
    peaks = []
    for seed in PEAK_SEEDS:
        out = cell_mod.run_cell(c, seed, 5.0, False, "cuda", time.perf_counter())
        print(f"mf2327 peak seed={seed}: {json.dumps(out)}")
        assert out["correct"] is True, out["compared"]
        assert out["failed"] == 0 and out["attempted"] > 0
        peaks.append(out["device"]["memory_peak_bytes"])
    assert peaks == [peaks[0]] * len(peaks), peaks
