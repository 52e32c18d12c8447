"""Assigned input shapes (same four for every LM arch), copied from the
JAX package's ``repro.configs.shapes``.

``decode_*`` / ``long_*`` are one-token serve steps against a KV cache of
seq_len; ``train_4k`` is a train step; ``prefill_32k`` the forward prefill.
``long_500k`` requires sub-quadratic sequence mixing and applies only to
SSM/hybrid archs. ``models.costs.step_cost`` prices each (arch, shape) cell.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) — the 40-cell ledger logic."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "full quadratic attention at 500k ctx (skip per assignment)"
    return True, ""
