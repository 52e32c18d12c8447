"""A whole run of the harness on the CPU at a tiny size (the look for a card
skipped): sound runs come out correct, the control and every fault a cell
can have come out not correct."""
import json

import numpy as np
import pytest
import torch

from perfbench.harness import cell as cell_mod
from perfbench.harness import compare
from perfbench.tests import tiny
from perfbench.tools.readings import control_numbers

SEED = 2 ** 33 + 11  # seeds run beyond 32 bits


def _run(kind, seed=SEED, trace=False, seconds=0.6):
    import time

    return cell_mod.run_cell(tiny.cell(kind), seed, seconds, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("kind", ["closed", "tol", "served"])
def test_sound_run_is_correct(kind):
    out = _run(kind)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "compared"
    want = {"x_gap", "resid_gap"} | ({"stop_gap"} if kind != "closed" else set())
    assert set(out["compared"]) == want
    for c in out["compared"].values():
        assert 0.0 <= c["value"] <= c["limit"]
    e2e = "served_p95_ms" if kind == "served" else "solve_ms"
    assert {e2e, "peak_mem_gb", "setup_s"} <= set(out["metrics"])
    json.dumps(out)


@pytest.mark.parametrize("kind", ["closed", "served"])
def test_traced_run_reports_its_layers(kind):
    out = _run(kind, trace=True, seconds=1.0)
    assert out["correct"] is True
    assert "prepare_s" in out["metrics"]
    assert "window_s" in out["device"] and out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert any(label.startswith("bench.") for label, _ in out["breakdown"]["idle_gaps"])


@pytest.mark.parametrize("kind", ["closed", "tol", "served"])
def test_control_is_not_correct(kind):
    """The reference in TF32 put in the program's place fails the limits."""
    c = tiny.cell(kind)
    numbers = control_numbers(c, SEED, 0.6, "cpu")
    ok, _ = compare.verdict(numbers, c.limits)
    assert not ok


def _real_columns(b):
    b = np.asarray(b)
    return np.flatnonzero(np.linalg.norm(b.reshape(b.shape[0], -1), axis=0) > 0)


def _break(monkeypatch, fault):
    """Plant ``fault`` in the program for the rest of the test."""
    from repro_torch.core import consensus, prepared
    from repro_torch.kernels.project import ops as project_ops

    if fault == "state_unchanged":  # the projection step returns its state unchanged
        monkeypatch.setattr(project_ops, "project", lambda w, v: torch.zeros_like(v))
        return
    if fault == "half_blocks":  # the consensus mean over half of the blocks
        orig = consensus.run_consensus

        def half(x0s, apply_fn, *args, **kwargs):
            h = x0s.shape[0] // 2

            def apply_half(v):
                full = torch.zeros((x0s.shape[0],) + tuple(v.shape[1:]), dtype=v.dtype)
                full[:h] = v
                return apply_fn(full)[:h]

            return orig(x0s[:h], apply_half, *args, **kwargs)

        monkeypatch.setattr(consensus, "run_consensus", half)
        return
    orig_solve = prepared.PreparedSolver.solve

    def solve(self, b, *args, **kwargs):
        res = orig_solve(self, b, *args, **kwargs)
        x = np.array(res.x, copy=True)
        x2 = x if x.ndim == 2 else x[:, None]
        real = _real_columns(b)
        if fault == "half_columns":  # half of the batch left out, the mean over the rest
            keep, drop = real[: (len(real) + 1) // 2], real[(len(real) + 1) // 2:]
            if len(drop):
                x2[:, drop] = x2[:, keep].mean(axis=1, keepdims=True)
            else:
                x2[:, keep] = 0.0
        elif fault == "answer_altered":  # one answer changed where it is produced
            c = real[0]
            x2[0, c] += 0.01 * np.linalg.norm(x2[:, c])
        return prepared.dataclasses.replace(res, x=x2 if x.ndim == 2 else x2[:, 0])

    monkeypatch.setattr(prepared.PreparedSolver, "solve", solve)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_blocks", "half_columns",
                                   "answer_altered"])
@pytest.mark.parametrize("kind", ["closed", "served"])
def test_fault_is_not_correct(monkeypatch, kind, fault):
    _break(monkeypatch, fault)
    out = _run(kind)
    assert out["correct"] is False, out["compared"]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    import types

    for name in ("repro_torchish", "jaxtyping", "repro_x.core"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert cell_mod.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert cell_mod.forbidden_modules() == ["jax", "repro.core"]
