"""Block registry, ported from the JAX package's ``repro.models.blocks``.

Every architecture is a sequence of block types. The spec declarations of
all ten types are here (pure declarations: ``param_specs`` and
``count_params`` equal the reference's for every arch), and so are their
cache declarations (``cache_shapes``, which ``costs.py`` counts). The dense
block (``dense``, and ``zamba_attn``, the same block with shared weights)
runs; ``apply_block`` and a model or cache built for any other type raise
``NotImplementedError`` naming its ROADMAP item.

``mode`` ∈ {"train", "prefill", "decode"}: train = full-seq causal, no cache;
prefill = full-seq causal writing the cache; decode = one token + cache.
KV caches are FLAT (B, Smax, Hkv·Dh) in ``cfg.cache_dtype``. Unlike the
reference, which returns fresh arrays, prefill and decode write the cache
in place and return it.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers, moe, ssm, xlstm
from repro_torch.models.spec import ParamSpec, SpecModule

# block types whose apply is not ported, with the ROADMAP item that ports it
UNPORTED = {
    "moe": "10b",
    "mla_moe": "10b",
    "mamba2": "10b",
    "mlstm": "10b",
    "slstm": "10b",
    "cross": "10b",
    "enc": "10b",
    "encdec_dec": "10b",
}


def require_ported(btype: str) -> None:
    if btype in UNPORTED:
        raise NotImplementedError(
            f"block type '{btype}' is not ported yet (ROADMAP Queue 1 item "
            f"{UNPORTED[btype]}: the other block families' serving paths)"
        )


# ---------------------------------------------------------------------------
# GQA attention sub-module (shared by dense / moe / cross / zamba / encdec)
# ---------------------------------------------------------------------------


def _attn_spec(cfg, cross=False):
    d = cfg.d_model
    dh = cfg.head_dim_actual
    qf = cfg.num_heads * dh
    kf = cfg.num_kv_heads * dh
    spec = {
        "w_q": ParamSpec((d, qf), ("embed", "heads_flat")),
        "w_k": ParamSpec((d, kf), ("embed", "kv_flat")),
        "w_v": ParamSpec((d, kf), ("embed", "kv_flat")),
        "w_o": ParamSpec((qf, d), ("heads_flat", "embed")),
    }
    if cfg.qkv_bias and not cross:
        spec["b_q"] = ParamSpec((qf,), (None,), init="zeros")
        spec["b_k"] = ParamSpec((kf,), (None,), init="zeros")
        spec["b_v"] = ParamSpec((kf,), (None,), init="zeros")
    return spec


class Attention(SpecModule):
    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__(_attn_spec(cfg), device, dtype)
        self.cfg = cfg

    def forward(self, x, mode="train", cache=None, pos=0):
        return _self_attn(self, x, self.cfg, mode, cache, pos)


def _qkv(p, x, cfg):
    b, s, _ = x.shape
    dh = cfg.head_dim_actual
    q = x @ p.w_q
    k = x @ p.w_k
    v = x @ p.w_v
    if "b_q" in p.specs:
        q, k, v = q + p.b_q, k + p.b_k, v + p.b_v
    return (
        q.reshape(b, s, cfg.num_heads, dh),
        k.reshape(b, s, cfg.num_kv_heads, dh),
        v.reshape(b, s, cfg.num_kv_heads, dh),
    )


def _self_attn(p, x, cfg, mode, cache, pos, causal=True):
    """Returns (attn_out (B,S,d), cache). Decode attends to the cache cast
    back to ``x.dtype``; prefill attends to the prompt's own k, v and only
    writes the cache."""
    b, s, _ = x.shape
    dh = cfg.head_dim_actual
    kf = cfg.num_kv_heads * dh
    q, k, v = _qkv(p, x, cfg)
    if mode == "decode":
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    else:
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    if cfg.pos_embed == "rope":
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    if mode == "decode":
        kc, vc = cache["k"], cache["v"]
        kc[:, pos] = k.reshape(b, kf).to(kc.dtype)
        vc[:, pos] = v.reshape(b, kf).to(vc.dtype)
        smax = kc.shape[1]
        out = layers.decode_attention(
            q,
            kc.reshape(b, smax, cfg.num_kv_heads, dh).to(x.dtype),
            vc.reshape(b, smax, cfg.num_kv_heads, dh).to(x.dtype),
            pos + 1,
        )
    else:
        if mode == "prefill" and cache is not None:
            cache["k"][:, :s] = k.reshape(b, s, kf).to(cache["k"].dtype)
            cache["v"][:, :s] = v.reshape(b, s, kf).to(cache["v"].dtype)
        out = layers.attention(
            q, k, v, causal=causal,
            chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
        )
    return out.reshape(b, q.shape[1], -1) @ p.w_o, cache


def _attn_cache_shapes(cfg, batch, max_seq, dtype=None):
    dtype = dtype or getattr(torch, cfg.cache_dtype)
    kf = cfg.num_kv_heads * cfg.head_dim_actual
    return {
        "k": ((batch, max_seq, kf), dtype, ("batch", "seq_kv", "kv_flat")),
        "v": ((batch, max_seq, kf), dtype, ("batch", "seq_kv", "kv_flat")),
    }


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------


def dense_spec(cfg):
    return {
        "ln1": layers.norm_spec(cfg),
        "attn": _attn_spec(cfg),
        "ln2": layers.norm_spec(cfg),
        "mlp": layers.mlp_spec(cfg),
    }


class DenseBlock(torch.nn.Module):
    """GQA attention + MLP, pre-norm residual (also ``zamba_attn``)."""

    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__()
        self.ln1 = layers.make_norm(cfg, device, dtype)
        self.attn = Attention(cfg, device, dtype)
        self.ln2 = layers.make_norm(cfg, device, dtype)
        self.mlp = layers.MLP(cfg, device, dtype)

    def forward(self, x, mode="train", cache=None, pos=0):
        h, cache = self.attn(self.ln1(x), mode, cache, pos)
        x = x + h
        x = x + self.mlp(self.ln2(x))
        return x, cache


# ---------------------------------------------------------------------------
# declarations of the block types not ported yet (item 10b)
# ---------------------------------------------------------------------------


def moe_block_spec(cfg):
    return {
        "ln1": layers.norm_spec(cfg),
        "attn": _attn_spec(cfg),
        "ln2": layers.norm_spec(cfg),
        "moe": moe.moe_spec(cfg),
    }


def mla_spec(cfg):
    d = cfg.d_model
    h = cfg.num_heads
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "w_dq": ParamSpec((d, cfg.q_lora_rank), ("embed", None)),
        "q_norm": {"scale": ParamSpec((cfg.q_lora_rank,), (None,), init="zeros")},
        "w_uq": ParamSpec((cfg.q_lora_rank, h * (nope + rope)), (None, "heads_flat")),
        "w_dkv": ParamSpec((d, cfg.kv_lora_rank + rope), ("embed", None)),
        "kv_norm": {"scale": ParamSpec((cfg.kv_lora_rank,), (None,), init="zeros")},
        "w_ukv": ParamSpec(
            (cfg.kv_lora_rank, h * (nope + vd)), (None, "heads_flat")
        ),
        "w_o": ParamSpec((h * vd, d), ("heads_flat", "embed")),
    }


def mla_moe_spec(cfg):
    return {
        "ln1": layers.norm_spec(cfg),
        "attn": mla_spec(cfg),
        "ln2": layers.norm_spec(cfg),
        "moe": moe.moe_spec(cfg),
    }


def _mla_cache_shapes(cfg, batch, max_seq, dtype=torch.bfloat16):
    return {
        "ckv": ((batch, max_seq, cfg.kv_lora_rank), dtype, ("batch", "seq_kv", None)),
        "kpe": ((batch, max_seq, cfg.qk_rope_dim), dtype, ("batch", "seq_kv", None)),
    }


def cross_spec(cfg):
    return {
        "ln1": layers.norm_spec(cfg),
        "attn": _attn_spec(cfg),
        "ln_c": layers.norm_spec(cfg),
        "xattn": _attn_spec(cfg, cross=True),
        "gate": ParamSpec((1,), (None,), init="zeros"),
        "ln2": layers.norm_spec(cfg),
        "mlp": layers.mlp_spec(cfg),
    }


def _cross_cache_shapes(cfg, batch, max_seq, src_seq, dtype=torch.bfloat16):
    kf = cfg.num_kv_heads * cfg.head_dim_actual
    out = _attn_cache_shapes(cfg, batch, max_seq, dtype)
    out["ck"] = ((batch, src_seq, kf), dtype, ("batch", None, "kv_flat"))
    out["cv"] = ((batch, src_seq, kf), dtype, ("batch", None, "kv_flat"))
    return out


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_SPECS = {
    "dense": dense_spec,
    "moe": moe_block_spec,
    "mla_moe": mla_moe_spec,
    "mamba2": ssm.mamba2_spec,
    "mlstm": xlstm.mlstm_spec,
    "slstm": xlstm.slstm_spec,
    "cross": cross_spec,
    "zamba_attn": dense_spec,
    "enc": dense_spec,
    "encdec_dec": cross_spec,
}


def block_spec(cfg, btype):
    return _SPECS[btype](cfg)


def make_block(cfg, btype, device=None, dtype=torch.float32) -> torch.nn.Module:
    require_ported(btype)
    if btype not in ("dense", "zamba_attn"):
        raise ValueError(f"unknown block type {btype}")
    return DenseBlock(cfg, device, dtype)


def apply_block(cfg, btype, p, x, mode="train", cache=None, pos=0, aux=None):
    """(x, cache, aux_loss) after one block; ``p`` is the block's module."""
    require_ported(btype)
    if btype not in ("dense", "zamba_attn"):
        raise ValueError(f"unknown block type {btype}")
    x, cache = p(x, mode, cache, pos)
    return x, cache, 0.0


def cache_shapes(cfg, btype, batch, max_seq):
    """{name: (shape, dtype, logical_axes)} for one block's decode cache: a
    declaration for every type (``init_cache`` allocates the ported ones)."""
    if btype in ("dense", "moe", "mla_moe", "zamba_attn"):
        if btype == "mla_moe":
            return _mla_cache_shapes(cfg, batch, max_seq)
        return _attn_cache_shapes(cfg, batch, max_seq)
    if btype == "mamba2":
        return ssm.mamba2_cache_shapes(cfg, batch)
    if btype == "mlstm":
        return xlstm.mlstm_cache_shapes(cfg, batch)
    if btype == "slstm":
        return xlstm.slstm_cache_shapes(cfg, batch)
    if btype == "cross":
        return _cross_cache_shapes(cfg, batch, max_seq, cfg.vision_seq)
    if btype == "encdec_dec":
        return _cross_cache_shapes(cfg, batch, max_seq, cfg.encoder_seq)
    if btype == "enc":
        return None
    raise ValueError(btype)
