"""Mamba2 (SSD) block: the parameter and cache declarations only, copied
from the JAX package's ``repro.models.ssm``. The chunked SSD forward and the
recurrent decode are ROADMAP Queue 1 item 10b."""
from __future__ import annotations

import torch

from repro_torch.models.spec import ParamSpec


def mamba2_spec(cfg):
    d, inner = cfg.d_model, cfg.ssm_inner
    n, h, k = cfg.ssm_state, cfg.ssm_heads, cfg.conv_kernel
    conv_dim = inner + 2 * n
    return {
        "in_proj": ParamSpec((d, 2 * inner + 2 * n + h), ("embed", "inner")),
        "conv_w": ParamSpec((k, conv_dim), (None, "inner"), scale=k**-0.5),
        "conv_b": ParamSpec((conv_dim,), ("inner",), init="zeros"),
        "a_log": ParamSpec((h,), (None,), init="ones"),
        "d_skip": ParamSpec((h,), (None,), init="ones"),
        "dt_bias": ParamSpec((h,), (None,), init="zeros"),
        "norm": ParamSpec((inner,), ("inner",), init="zeros"),
        "out_proj": ParamSpec((inner, d), ("inner", "embed")),
    }


def mamba2_cache_shapes(cfg, batch):
    n, h, pd, k = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim, cfg.conv_kernel
    conv_dim = cfg.ssm_inner + 2 * n
    return {
        "state": ((batch, h, n, pd), torch.float32, ("batch", None, None, None)),
        "conv": ((batch, k - 1, conv_dim), torch.float32, ("batch", None, "inner")),
    }
