"""Synthetic token pipeline, ported from the JAX package's
``repro.training.data``: deterministic and restart-exact.

Each batch is a pure function of ``(seed, step)``: it is drawn from
``np.random.default_rng((seed, step))``, so a restarted run consumes
identical data with no host state. The stream is the reference's
distribution (a Zipf-ish marginal from a squared uniform, with short-range
repetition so that tiny models show a learning signal), drawn from numpy's
generator where the reference folds ``step`` into a ``jax.random`` key; the
draws differ, the distribution does not.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    repeat_prob: float = 0.5  # learnable short-range structure


def make_batch(cfg: DataConfig, step: int, device=None) -> dict:
    """{"tokens": (B, S), "targets": (B, S)} int64 for this step, on
    ``device`` (the card unless the caller says)."""
    rng = np.random.default_rng((cfg.seed, step))
    b, s = cfg.global_batch, cfg.seq_len + 1
    u = rng.random((b, s), dtype=np.float32)
    fresh = (u * u * (cfg.vocab_size - 1)).astype(np.int64)
    # with prob repeat_prob, repeat the previous token (learnable signal)
    rep = rng.random((b, s), dtype=np.float32) < cfg.repeat_prob
    shifted = np.pad(fresh, ((0, 0), (1, 0)))[:, :s]
    toks = torch.from_numpy(np.where(rep, shifted, fresh)).to(resolve_device(device))
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def host_iterator(cfg: DataConfig, start_step: int = 0, device=None):
    step = start_step
    while True:
        yield make_batch(cfg, step, device)
        step += 1
