"""xLSTM blocks (mLSTM, sLSTM): the parameter and cache declarations only,
copied from the JAX package's ``repro.models.xlstm``. Their chunked forward
and recurrent decode are ROADMAP Queue 1 item 10b."""
from __future__ import annotations

import torch

from repro_torch.models.spec import ParamSpec


def _mlstm_dims(cfg):
    inner = int(cfg.mlstm_proj_factor * cfg.d_model)
    h = cfg.num_heads
    return inner, h, inner // h


def mlstm_spec(cfg):
    d = cfg.d_model
    inner, h, pd = _mlstm_dims(cfg)
    return {
        "up_proj": ParamSpec((d, 2 * inner), ("embed", "inner"), scale=d**-0.5),
        "conv_w": ParamSpec(
            (cfg.conv_kernel, inner), (None, "inner"), scale=cfg.conv_kernel**-0.5
        ),
        "conv_b": ParamSpec((inner,), ("inner",), init="zeros"),
        # headwise (block-diagonal) projections, as in the official xLSTM
        "w_q": ParamSpec((h, pd, pd), (None, "inner", None), scale=pd**-0.5),
        "w_k": ParamSpec((h, pd, pd), (None, "inner", None), scale=pd**-0.5),
        "w_v": ParamSpec((h, pd, pd), (None, "inner", None), scale=pd**-0.5),
        "w_if": ParamSpec((inner, 2 * h), ("inner", None), scale=0.01),
        "b_if": ParamSpec((2 * h,), (None,), init="zeros"),
        "norm": ParamSpec((inner,), ("inner",), init="zeros"),
        "down_proj": ParamSpec((inner, d), ("inner", "embed"), scale=inner**-0.5),
    }


def mlstm_cache_shapes(cfg, batch):
    inner, h, pd = _mlstm_dims(cfg)
    return {
        "c": ((batch, h, pd, pd), torch.float32, ("batch", None, None, "inner")),
        "n": ((batch, h, pd), torch.float32, ("batch", None, None)),
        "conv": (
            (batch, cfg.conv_kernel - 1, inner), torch.float32,
            ("batch", None, "inner"),
        ),
    }


def _slstm_dims(cfg):
    h = cfg.num_heads
    return h, cfg.d_model // h


def slstm_spec(cfg):
    d = cfg.d_model
    h, pd = _slstm_dims(cfg)
    ff = int(cfg.slstm_proj_factor * d)
    return {
        "w_gates": ParamSpec((d, 4 * d), ("embed", "inner"), scale=d**-0.5),
        "r_gates": ParamSpec((h, pd, 4 * pd), (None, None, None), scale=pd**-0.5),
        "b_gates": ParamSpec((4 * d,), ("inner",), init="zeros"),
        "norm": ParamSpec((d,), (None,), init="zeros"),
        "out_proj": ParamSpec((d, d), ("embed", None), scale=d**-0.5),
        "ffn": {
            "w_in": ParamSpec((d, ff), ("embed", "ff"), scale=d**-0.5),
            "w_gate": ParamSpec((d, ff), ("embed", "ff"), scale=d**-0.5),
            "w_out": ParamSpec((ff, d), ("ff", "embed"), scale=ff**-0.5),
        },
    }


def slstm_cache_shapes(cfg, batch):
    h, pd = _slstm_dims(cfg)
    return {
        k: ((batch, h, pd), torch.float32, ("batch", None, None))
        for k in ("c", "n", "m", "h")
    }
