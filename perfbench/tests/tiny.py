"""Cells small enough for the CPU: the benchmark's code paths at a size a
test run holds. ``CONFIG`` is the dense form (m = 200, n = 64, J = 8 wide
blocks); ``COO_CONFIG`` the ``"coo"`` form on the program's matrix-free path
(square n = 256 at 95%, J = 8, the direct Gram solve, its matrix drawn from
its own ``matrix_seed``), judged by the test reference
``perfbench/tests/matfree_ref.py``."""
from __future__ import annotations

import copy

from perfbench.harness.cell import Cell

CONFIG = {
    "problem": {"m": 200, "n": 64, "sparsity": 0.9, "value_mean": 0.013, "value_std": 24.31},
    "prepare": {"method": "dapc", "num_blocks": 8, "mode": "wide", "materialize_p": False,
                "use_kernels": True, "gamma": 1.0, "eta": 0.9},
    "tol": 10.0,
    "reference": "dapc",
}
MIXES = {
    "closed": {"kind": "closed_loop", "k": 4, "pool": 3, "epochs": 40, "tol": None},
    "tol": {"kind": "closed_loop", "k": 4, "pool": 3, "epochs": 300, "tol": "config"},
    "served": {"kind": "open_poisson", "rate_per_s": 40, "max_batch": 8, "max_wait_ms": 5,
               "epochs": 300, "tol": "config", "sample": 256},
}
# at this size sound runs read about 1e-6 (x) and 2e-5 (residual) and 0
# (stop); the TF32 control about 1e-3, 1e-2 and 5e-3
LIMITS = {"x_gap": 1e-4, "resid_gap": 1e-3, "stop_gap": 1e-3}


COO_CONFIG = {
    "problem": {"form": "coo", "m": 256, "n": 256, "sparsity": 0.95, "value_mean": 0.013,
                "value_std": 24.31, "matrix_seed": 2 ** 33 + 23},
    "prepare": {"method": "dapc", "num_blocks": 8, "mode": "matfree", "gram_solver": "direct",
                "use_kernels": True, "gamma": 2.0, "eta": 1.9},
    "tol": 10.0,
    "reference": "matfree_ref",
}
# the same limits: sound runs read about 5e-7 (x) and 1e-6 (residual) here


def cell(kind: str, config: dict = CONFIG) -> Cell:
    e2e = ["served_p95_ms"] if kind == "served" else ["solve_ms"]
    e2e += ["peak_mem_gb", "setup_s"]
    layer = ["prepare_s", "mfu.served", "served_queue_ms", "served_batch_size"] \
        if kind == "served" else ["prepare_s", "mfu.solve"]
    name = "tiny_coo" if config["problem"].get("form") == "coo" else "tiny"
    return Cell(f"{name}.{kind}", copy.deepcopy(config), copy.deepcopy(MIXES[kind]),
                dict(LIMITS), e2e, layer, {n: "u" for n in e2e + layer})
