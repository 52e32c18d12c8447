"""Gradient compression for the data-parallel all-reduce, ported from the
JAX package's ``repro.distributed.compression``: per-tensor symmetric int8
with error feedback.

The residual (what quantisation lost) is added back next step, which keeps
the quantisation bias out of the long-run trajectory. Trees are {name:
tensor} mappings (a model's parameter names).
"""
from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor):
    """Per-tensor symmetric int8. Returns (q, scale: a 0-d f32 tensor)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: dict, residuals: dict):
    """Error feedback, then quantise each leaf. Returns ({name: (q, scale)},
    new residuals)."""
    qtree, new_res = {}, {}
    for name, g in grads.items():
        g = g.float() + residuals[name]
        q, s = quantize_int8(g)
        qtree[name] = (q, s)
        new_res[name] = g - dequantize_int8(q, s)
    return qtree, new_res


def decompress_tree(qtree: dict) -> dict:
    return {name: dequantize_int8(q, s) for name, (q, s) in qtree.items()}


def init_residuals(params: dict) -> dict:
    """f32 zeros per tensor of a {name: tensor} mapping."""
    return {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for name, p in params.items()}
