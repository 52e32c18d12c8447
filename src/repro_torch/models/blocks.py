"""Block registry, ported from the JAX package's ``repro.models.blocks``.

Every architecture is a sequence of block types: ``dense`` (GQA attn +
MLP), ``moe`` (attn + fine-grained MoE), ``mla_moe`` (DeepSeek-V2 MLA attn
+ MoE), ``mamba2``, ``mlstm``, ``slstm``, ``cross`` (self-attn + gated
cross-attn to patch embeddings + MLP), ``zamba_attn`` (the dense block with
weights shared across its occurrences), ``enc`` (non-causal encoder block)
and ``encdec_dec`` (decoder block with ungated cross-attn to the encoder
output). ``make_block`` builds one as a module whose parameter names follow
the reference's tree; ``apply_block`` runs it and returns (x, cache,
aux_loss). ``cache_shapes`` declares each type's decode cache.

``mode`` ∈ {"train", "prefill", "decode"}: train = full-seq causal, no cache;
prefill = full-seq causal writing the cache; decode = one token + cache.
KV caches are FLAT (B, Smax, Hkv·Dh) in ``cfg.cache_dtype`` (MLA's and the
cross caches in bf16, as the reference declares them); recurrent states are
f32. Unlike the reference, which returns fresh arrays, prefill and decode
write every cache and state in place and return the same tree.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers, moe, ssm, xlstm
from repro_torch.models.spec import ParamSpec, SpecModule

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
    def __init__(self, cfg, device=None, dtype=torch.float32, cross=False):
        super().__init__(_attn_spec(cfg, cross), device, dtype)
        self.cfg = cfg

    def forward(self, x, mode="train", cache=None, pos=0, causal=True):
        return _self_attn(self, x, self.cfg, mode, cache, pos, causal)


def _qkv(p, x, cfg):
    b, s, _ = x.shape
    dh = cfg.head_dim_actual
    q = layers.matmul(x, p.w_q)
    k = layers.matmul(x, p.w_k)
    v = layers.matmul(x, p.w_v)
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
    return layers.matmul(out.reshape(b, q.shape[1], -1), p.w_o), cache


def _attn_cache_shapes(cfg, batch, max_seq, dtype=None):
    dtype = dtype or getattr(torch, cfg.cache_dtype)
    kf = cfg.num_kv_heads * cfg.head_dim_actual
    return {
        "k": ((batch, max_seq, kf), dtype, ("batch", "seq_kv", "kv_flat")),
        "v": ((batch, max_seq, kf), dtype, ("batch", "seq_kv", "kv_flat")),
    }


# ---------------------------------------------------------------------------
# dense (also zamba_attn, and enc without the causal mask)
# ---------------------------------------------------------------------------


def dense_spec(cfg):
    return {
        "ln1": layers.norm_spec(cfg),
        "attn": _attn_spec(cfg),
        "ln2": layers.norm_spec(cfg),
        "mlp": layers.mlp_spec(cfg),
    }


class DenseBlock(torch.nn.Module):
    """GQA attention + MLP, pre-norm residual (also ``zamba_attn``). As the
    ``enc`` block (``causal=False``) it attends both ways and keeps no
    cache, whatever the mode (the reference's ``enc_apply``)."""

    def __init__(self, cfg, device=None, dtype=torch.float32, causal=True):
        super().__init__()
        self.ln1 = layers.make_norm(cfg, device, dtype)
        self.attn = Attention(cfg, device, dtype)
        self.ln2 = layers.make_norm(cfg, device, dtype)
        self.mlp = layers.MLP(cfg, device, dtype)
        self.causal = causal

    def forward(self, x, mode="train", cache=None, pos=0, aux=None):
        if not self.causal:
            mode, cache, pos = "train", None, 0
        h, cache = self.attn(self.ln1(x), mode, cache, pos, self.causal)
        x = x + h
        x = x + self.mlp(self.ln2(x))
        return x, cache, 0.0


# ---------------------------------------------------------------------------
# moe (attn + fine-grained MoE)
# ---------------------------------------------------------------------------


def moe_block_spec(cfg):
    return {
        "ln1": layers.norm_spec(cfg),
        "attn": _attn_spec(cfg),
        "ln2": layers.norm_spec(cfg),
        "moe": moe.moe_spec(cfg),
    }


class MoEBlock(torch.nn.Module):
    """Attention (GQA, or MLA for ``mla_moe``) + MoE, pre-norm residual; the
    aux loss is the MoE's Switch loss."""

    def __init__(self, cfg, device=None, dtype=torch.float32, mla=False):
        super().__init__()
        self.ln1 = layers.make_norm(cfg, device, dtype)
        self.attn = (MLA if mla else Attention)(cfg, device, dtype)
        self.ln2 = layers.make_norm(cfg, device, dtype)
        self.moe = moe.MoE(cfg, device, dtype)

    def forward(self, x, mode="train", cache=None, pos=0, aux=None):
        h, cache = self.attn(self.ln1(x), mode, cache, pos)
        x = x + h
        y, aux_loss = self.moe(self.ln2(x))
        return x + y, cache, aux_loss


# ---------------------------------------------------------------------------
# mla_moe (DeepSeek-V2: multi-head latent attention + MoE)
# ---------------------------------------------------------------------------


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


class MLA(SpecModule):
    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__(mla_spec(cfg), device, dtype)
        self.cfg = cfg

    def forward(self, x, mode="train", cache=None, pos=0):
        return _mla_attn(self, x, self.cfg, mode, cache, pos)


def _mla_attn(p, x, cfg, mode, cache, pos):
    """Latent q and kv (RMSNorm'd), RoPE on a ``k_pe`` shared by all heads.
    Prefill and train attend in full; decode runs the absorbed form, in the
    512-wide compressed space against the ``ckv``/``kpe`` caches, with the
    reference's dtypes: the scores promote the bf16 caches to f32, the
    softmax weights are cast to the cache's bf16 before the value product."""
    b, s, _ = x.shape
    h = cfg.num_heads
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    lkv = cfg.kv_lora_rank
    if mode == "decode":
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    else:
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    cq = layers.rms_norm(x @ p.w_dq, p.q_norm.scale, cfg.norm_eps)
    q = (cq @ p.w_uq).reshape(b, s, h, nope + rope)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    q_pe = layers.apply_rope(q_pe, positions, cfg.rope_theta)
    dkv = x @ p.w_dkv
    ckv = layers.rms_norm(dkv[..., :lkv], p.kv_norm.scale, cfg.norm_eps)
    k_pe = layers.apply_rope(dkv[..., lkv:][:, :, None, :], positions,
                             cfg.rope_theta)[:, :, 0]  # (B,S,rope) shared across heads
    w_ukv = p.w_ukv.reshape(lkv, h, nope + vd)
    if mode == "decode":
        ckv_c, kpe_c = cache["ckv"], cache["kpe"]
        ckv_c[:, pos] = ckv[:, 0].to(ckv_c.dtype)
        kpe_c[:, pos] = k_pe[:, 0].to(kpe_c.dtype)
        # --- absorbed decode: attention runs in the compressed space ---
        q_abs = torch.einsum("bxhn,lhn->bxhl", *layers.promote(q_nope, w_ukv[..., :nope]))
        scores = torch.einsum("bhl,bsl->bhs", *layers.promote(q_abs[:, 0], ckv_c))
        scores = scores + torch.einsum("bhr,bsr->bhs", *layers.promote(q_pe[:, 0], kpe_c))
        scores = (scores * (nope + rope) ** -0.5).float()
        valid = torch.arange(ckv_c.shape[1], device=x.device) < pos + 1
        scores = scores.masked_fill(~valid, -torch.inf)
        w = torch.softmax(scores, dim=-1).to(ckv_c.dtype)
        out_c = torch.einsum("bhs,bsl->bhl", w, ckv_c)
        out = torch.einsum("bhl,lhv->bhv", *layers.promote(out_c, w_ukv[..., nope:]))
        out = out.reshape(b, 1, h * vd)
    else:
        kv = torch.einsum("bsl,lhd->bshd", ckv, w_ukv)
        k_nope, v = kv[..., :nope], kv[..., nope:]
        k = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, s, h, rope)], dim=-1)
        q_full = torch.cat([q_nope, q_pe], dim=-1)
        if mode == "prefill" and cache is not None:
            cache["ckv"][:, :s] = ckv.to(cache["ckv"].dtype)
            cache["kpe"][:, :s] = k_pe.to(cache["kpe"].dtype)
        out = layers.attention(
            q_full, k, v, causal=True,
            chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
        )
        out = out.reshape(b, s, h * vd)
    return out @ p.w_o, cache


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


# ---------------------------------------------------------------------------
# cross (llama-3.2-vision: self-attn + gated cross-attn to patches + MLP) and
# encdec_dec (whisper's decoder block: the same, ungated, on the encoder output)
# ---------------------------------------------------------------------------


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


def _cross_attn(p, x, kv_src, cfg, cache, mode):
    """Cross-attention; k, v (and their cache) come from the patch or
    encoder embeddings. Prefill writes ``ck``/``cv`` from the source; decode
    reads them with every source position valid."""
    b, s, _ = x.shape
    dh = cfg.head_dim_actual
    kf = cfg.num_kv_heads * dh
    q = (x @ p.w_q).reshape(b, s, cfg.num_heads, dh)
    if mode == "decode":
        smax = cache["ck"].shape[1]
        out = layers.decode_attention(
            q,
            cache["ck"].reshape(b, smax, cfg.num_kv_heads, dh),
            cache["cv"].reshape(b, smax, cfg.num_kv_heads, dh),
            smax,  # all source positions valid
        )
    else:
        sk = kv_src.shape[1]
        k = (kv_src @ p.w_k).reshape(b, sk, cfg.num_kv_heads, dh)
        v = (kv_src @ p.w_v).reshape(b, sk, cfg.num_kv_heads, dh)
        out = layers.attention(q, k, v, causal=False)
        if mode == "prefill" and cache is not None:
            cache["ck"].copy_(k.reshape(b, sk, kf))
            cache["cv"].copy_(v.reshape(b, sk, kf))
    out, w_o = layers.promote(out.reshape(b, s, -1), p.w_o)  # decode: bf16 @ f32
    return out @ w_o


class CrossBlock(SpecModule):
    """Self-attention, cross-attention to ``aux[source]`` (under the
    zero-init ``tanh(gate)`` when ``gated``: llama-vision's image path fades
    in during training; whisper's decoder must hear the encoder at init),
    then the MLP. The cache holds the self-attention's ``k``/``v`` and the
    source's ``ck``/``cv``."""

    def __init__(self, cfg, device=None, dtype=torch.float32, gated=True):
        super().__init__({"gate": cross_spec(cfg)["gate"]}, device, dtype)
        self.ln1 = layers.make_norm(cfg, device, dtype)
        self.attn = Attention(cfg, device, dtype)
        self.ln_c = layers.make_norm(cfg, device, dtype)
        self.xattn = Attention(cfg, device, dtype, cross=True)
        self.ln2 = layers.make_norm(cfg, device, dtype)
        self.mlp = layers.MLP(cfg, device, dtype)
        self.cfg = cfg
        self.gated = gated
        self.source = "patches" if gated else "enc_out"

    def forward(self, x, mode="train", cache=None, pos=0, aux=None):
        self_cache = None if cache is None else {"k": cache["k"], "v": cache["v"]}
        h, _ = self.attn(self.ln1(x), mode, self_cache, pos)
        x = x + h
        kv_src = None if aux is None else aux.get(self.source)
        hc = _cross_attn(self.xattn, self.ln_c(x), kv_src, self.cfg, cache, mode)
        if self.gated:
            hc = torch.tanh(self.gate).to(x.dtype) * hc
        x = x + hc
        x = x + self.mlp(self.ln2(x))
        return x, cache, 0.0


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

_MAKERS = {
    "dense": DenseBlock,
    "zamba_attn": DenseBlock,
    "enc": lambda cfg, device, dtype: DenseBlock(cfg, device, dtype, causal=False),
    "moe": MoEBlock,
    "mla_moe": lambda cfg, device, dtype: MoEBlock(cfg, device, dtype, mla=True),
    "mamba2": ssm.Mamba2,
    "mlstm": xlstm.MLSTM,
    "slstm": xlstm.SLSTM,
    "cross": CrossBlock,
    "encdec_dec": lambda cfg, device, dtype: CrossBlock(cfg, device, dtype, gated=False),
}


def block_spec(cfg, btype):
    return _SPECS[btype](cfg)


def make_block(cfg, btype, device=None, dtype=torch.float32) -> torch.nn.Module:
    """One block of type ``btype`` (its parameters uninitialised)."""
    if btype not in _MAKERS:
        raise ValueError(f"unknown block type {btype}")
    return _MAKERS[btype](cfg, device, dtype)


def apply_block(cfg, btype, p, x, mode="train", cache=None, pos=0, aux=None):
    """(x, cache, aux_loss) after one block; ``p`` is the block's module
    (``make_block``'s)."""
    if btype not in _MAKERS:
        raise ValueError(f"unknown block type {btype}")
    return p(x, mode, cache, pos, aux)


def cache_shapes(cfg, btype, batch, max_seq):
    """{name: (shape, dtype, logical_axes)} for one block's decode cache."""
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
