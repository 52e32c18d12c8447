"""The one traffic generator. A mix is a data file under
``perfbench/traffic/`` whose ``kind`` picks one of two shapes:

- ``closed_loop``: ``pool`` batches of ``k`` right-hand sides, each B = A·X
  with X drawn from the seed; the window cycles them.
- ``open_poisson``: ``rate_per_s`` × seconds single right-hand sides, due at
  the order statistics of as many uniform draws over the window. That is a
  Poisson process held to a fixed count, so every seed brings the same amount
  of work in another order.

Every mix names ``epochs``, and ``tol``: null, or ``"config"`` for the
accuracy the configuration states.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.harness.problem import sub_seed

KINDS = ("closed_loop", "open_poisson")


@dataclasses.dataclass
class Load:
    """The host arrays a window sends."""

    pool: list | None = None  # closed loop: (m, k) batches
    rhs: np.ndarray | None = None  # open loop: (m, N), column i is request i
    due_s: np.ndarray | None = None  # open loop: (N,) due times in the window
    warm: np.ndarray | None = None  # open loop: (m, w) warm-up requests


def tolerance(mix: dict, config: dict):
    tol = mix.get("tol")
    if tol is None:
        return None
    if tol != "config":
        raise ValueError(f"tol must be null or 'config', got {tol!r}")
    return float(config["tol"])


def _host(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.cpu().numpy())


def make_load(mix: dict, system, seed: int, seconds: float) -> Load:
    kind = mix["kind"]
    if kind == "closed_loop":
        return Load(pool=[_host(system.rhs(int(mix["k"]), purpose=i))
                          for i in range(int(mix["pool"]))])
    if kind == "open_poisson":
        n = max(1, int(round(float(mix["rate_per_s"]) * seconds)))
        rng = np.random.default_rng(sub_seed(seed, 2))
        due = np.sort(rng.uniform(0.0, seconds, size=n))
        warm = int(mix["max_batch"]) * int(mix.get("warm_batches", 2))
        return Load(rhs=_host(system.rhs(n, purpose=100)), due_s=due,
                    warm=_host(system.rhs(warm, purpose=200)))
    raise ValueError(f"traffic kind must be one of {KINDS}, got {kind!r}")
