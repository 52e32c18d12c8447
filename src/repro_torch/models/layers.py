"""Core layers: norms, RoPE, attention (plain, chunked flash with its
backward, decode) and MLPs, ported from the JAX package's
``repro.models.layers``.

Weight layout as in the reference: attention projections are stored FLAT,
(d_model, H·Dh), and heads are recovered by reshape inside the block. The
functions take plain tensors; ``RMSNorm``, ``LayerNorm`` and ``MLP`` hold
their parameters as ``SpecModule``s declared by the same spec functions the
reference uses. The chunked attention is a ``torch.autograd.Function``
whose backward recomputes the probabilities per chunk pair (the
reference's custom VJP); everything else is differentiated by autograd.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.spec import ParamSpec, SpecModule

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps=1e-6):
    """RMS norm with a zero-initialized scale: normalized in f32, cast back
    to ``x.dtype``, then multiplied by (1 + scale)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * (1.0 + scale.to(x.dtype))


def layer_norm(x, scale, bias, eps=1e-6):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return out.to(x.dtype) * scale.to(x.dtype) + bias.to(x.dtype)


def norm_spec(cfg, d=None):
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {
            "scale": ParamSpec((d,), (None,), init="ones"),
            "bias": ParamSpec((d,), (None,), init="zeros"),
        }
    return {"scale": ParamSpec((d,), (None,), init="zeros")}


class RMSNorm(SpecModule):
    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__(norm_spec(cfg), device, dtype)
        self.eps = cfg.norm_eps

    def forward(self, x):
        return rms_norm(x, self.scale, self.eps)


class LayerNorm(SpecModule):
    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__(norm_spec(cfg), device, dtype)
        self.eps = cfg.norm_eps

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, self.eps)


def make_norm(cfg, device=None, dtype=torch.float32):
    return (LayerNorm if cfg.norm == "layernorm" else RMSNorm)(cfg, device, dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def apply_rope(x, positions, theta):
    """x: (..., S, H, D) with D even; positions: (..., S). Rotates the two
    halves of the head dim (not interleaved pairs), in f32."""
    d = x.shape[-1]
    freqs = torch.exp(
        -math.log(theta) * torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    )  # (D/2,)
    angles = positions[..., None].float() * freqs  # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention cores (plain, chunked flash forward, decode)
# ---------------------------------------------------------------------------


def _plain_attention(q, k, v, causal, q_offset=0):
    """q (B,Sq,H,Dqk), k (B,Sk,Hkv,Dqk), v (B,Sk,Hkv,Dv). GQA via groups."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    scores = scores * (1.0 / math.sqrt(d))
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        scores = scores.masked_fill(ki > qi, -math.inf)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return out.reshape(b, sq, h, v.shape[-1])


def _chunk_bias(qi, ki, chunk_q, chunk_kv, sk, causal, device):
    """Additive f32 bias for one chunk pair: -1e30 above the causal diagonal
    and on the right-edge padding (only the last kv chunk can be padded)."""
    neg = -1e30
    bias = torch.zeros((chunk_q, chunk_kv), dtype=torch.float32, device=device)
    if causal:
        qpos = qi * chunk_q + torch.arange(chunk_q, device=device)
        kpos = ki * chunk_kv + torch.arange(chunk_kv, device=device)
        bias = bias.masked_fill(kpos[None, :] > qpos[:, None], neg)
    kpos = ki * chunk_kv + torch.arange(chunk_kv, device=device)
    return bias.masked_fill((kpos >= sk)[None, :], neg)


def _flash_fwd_impl(qs, ks, vs, causal, sk):
    """qs (b,nq,cq,hkv,g,d); ks/vs (b,nk,ck,hkv,·) -> (out (b,nq,cq,hkv,g,dv),
    m, l (b,nq,hkv,g,cq) f32: each row's running max and softmax sum).

    Causal with cq == ck skips the chunk pairs strictly above the diagonal
    (no FLOPs), as the reference's ``lax.cond`` does.
    """
    b, nq, cq, hkv, g, d = qs.shape
    nk, ck = ks.shape[1], ks.shape[2]
    dv = vs.shape[-1]
    scale = 1.0 / math.sqrt(d)
    skippable = causal and cq == ck
    outs, ms, ls = [], [], []
    for qi in range(nq):
        qc = qs[:, qi]
        m = torch.full((b, hkv, g, cq), -1e30, dtype=torch.float32, device=qs.device)
        l = torch.zeros((b, hkv, g, cq), dtype=torch.float32, device=qs.device)
        acc = torch.zeros((b, hkv, g, cq, dv), dtype=torch.float32, device=qs.device)
        for ki in range(nk):
            if skippable and ki > qi:
                continue
            kc, vc = ks[:, ki], vs[:, ki]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc).float()
            s = s * scale + _chunk_bias(qi, ki, cq, ck, sk, causal, qs.device)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(vc.dtype), vc
            ).float()
            m = m_new
        out = (acc / torch.clamp(l, min=1e-20)[..., None]).to(vs.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4))  # (b, cq, hkv, g, dv)
        ms.append(m)
        ls.append(l)
    return torch.stack(outs, 1), torch.stack(ms, 1), torch.stack(ls, 1)


def _flash_bwd_impl(q, k, v, out, m, l, dout, causal, sk):
    """The flash backward, chunk-tiled (Dao et al.), as the reference's
    ``_flash_bwd``: p is recomputed per chunk pair from the saved row max and
    sum; with Δ = rowsum(do ∘ o), dv = pᵀ do, dp = do vᵀ, ds = p ∘ (dp − Δ),
    dq = ds k, dk = dsᵀ q. Pairs above the diagonal are skipped as in the
    forward. Everything accumulates in f32; the gradients are cast to their
    inputs' dtypes."""
    b, nq, cq, hkv, g, d = q.shape
    nk, ck = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    skippable = causal and cq == ck
    linv = 1.0 / torch.clamp(l, min=1e-20)  # (b,nq,hkv,g,cq)
    delta = torch.einsum("bnqhgd,bnqhgd->bnhgq", dout.float(), out.float())
    dk = torch.zeros((nk,) + k[:, 0].shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros((nk,) + v[:, 0].shape, dtype=torch.float32, device=q.device)
    dqs = []
    for qi in range(nq):
        qc, doc = q[:, qi], dout[:, qi].float()
        mc, lic, dc = m[:, qi], linv[:, qi], delta[:, qi]
        dq = torch.zeros((b, cq, hkv, g, d), dtype=torch.float32, device=q.device)
        for ki in range(nk):
            if skippable and ki > qi:
                continue
            kc, vc = k[:, ki], v[:, ki]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc).float()
            s = s * scale + _chunk_bias(qi, ki, cq, ck, sk, causal, q.device)
            p = torch.exp(s - mc[..., None]) * lic[..., None]  # normalised probs
            dv[ki] += torch.einsum("bhgqk,bqhgd->bkhd", p, doc)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", doc, vc.float())
            ds = p * (dp - dc[..., None]) * scale
            dq += torch.einsum("bhgqk,bkhd->bqhgd", ds, kc.float())
            dk[ki] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qc.float())
        dqs.append(dq)
    return (torch.stack(dqs, 1).to(q.dtype), dk.transpose(0, 1).to(k.dtype),
            dv.transpose(0, 1).to(v.dtype))


class _Flash(torch.autograd.Function):
    """Chunked flash attention with O(S·d) residuals: the forward saves
    (q, k, v, out, m, l), the backward recomputes the scores per chunk pair
    (the reference's ``_flash`` custom VJP)."""

    @staticmethod
    def forward(ctx, qs, ks, vs, causal, sk):
        out, m, l = _flash_fwd_impl(qs, ks, vs, causal, sk)
        ctx.save_for_backward(qs, ks, vs, out, m, l)
        ctx.causal, ctx.sk = causal, sk
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _flash_bwd_impl(*ctx.saved_tensors, dout, ctx.causal, ctx.sk)
        return dq, dk, dv, None, None


def _chunked_attention(q, k, v, causal, chunk_q, chunk_kv):
    """Flash attention over (chunk_q, chunk_kv) tiles: O(chunk²) score
    memory in both directions, for sequences longer than ``chunk_q``."""
    b, sq, h, d = q.shape
    dv = v.shape[-1]
    sk = k.shape[1]
    hkv = k.shape[2]
    g = h // hkv
    nq = -(-sq // chunk_q)
    nk = -(-sk // chunk_kv)
    qpad, kpad = nq * chunk_q - sq, nk * chunk_kv - sk
    q = F.pad(q, (0, 0, 0, 0, 0, qpad))
    k = F.pad(k, (0, 0, 0, 0, 0, kpad))
    v = F.pad(v, (0, 0, 0, 0, 0, kpad))
    qs = q.reshape(b, nq, chunk_q, hkv, g, d)
    ks = k.reshape(b, nk, chunk_kv, hkv, d)
    vs = v.reshape(b, nk, chunk_kv, hkv, dv)
    out = _Flash.apply(qs, ks, vs, causal, sk)
    out = out.reshape(b, nq * chunk_q, h, dv)[:, :sq]
    return out.to(v.dtype)


def attention(q, k, v, causal=True, q_offset=0, chunk_q=0, chunk_kv=0):
    if chunk_q and q.shape[1] > chunk_q:
        return _chunked_attention(q, k, v, causal, chunk_q, chunk_kv or chunk_q)
    return _plain_attention(q, k, v, causal, q_offset)


def promote(*tensors):
    """The tensors cast to their common dtype, as ``jnp.einsum`` and ``@``
    promote mixed operands (bf16 with f32 computes in f32)."""
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return tuple(t.to(dtype) for t in tensors)


def matmul(a, b):
    """``a @ b`` in the operands' common dtype (``promote``): an f32
    activation (after an f32 bias) against a bf16 weight computes in f32."""
    return torch.matmul(*promote(a, b))


def decode_attention(q, k_cache, v_cache, length):
    """q (B,1,H,D); caches (B,Smax,Hkv,D); positions >= length are masked.
    Mixed dtypes promote as the reference's einsums do: the weights are cast
    to the value cache's dtype before the second product."""
    b, _, h, d = q.shape
    hkv = k_cache.shape[2]
    g = h // hkv
    qg = q.reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bkhd->bhgk", *promote(qg, k_cache)).float()
    s = s * (1.0 / math.sqrt(d))
    invalid = torch.arange(k_cache.shape[1], device=q.device) >= length  # (Smax,)
    s = s.masked_fill(invalid, -math.inf)
    w = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", w, v_cache)
    return out.reshape(b, 1, h, v_cache.shape[-1])


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_spec(cfg, d_in=None, d_ff=None):
    d_in = d_in or cfg.d_model
    d_ff = d_ff or cfg.d_ff
    gated = cfg.activation in ("swiglu", "geglu")
    spec = {
        "w_in": ParamSpec((d_in, d_ff), ("embed", "ff")),
        "w_out": ParamSpec((d_ff, d_in), ("ff", "embed")),
    }
    if gated:
        spec["w_gate"] = ParamSpec((d_in, d_ff), ("embed", "ff"))
    return spec


def apply_mlp(p, x, cfg):
    """``p`` maps w_in, w_out (and w_gate) to tensors. ``jax.nn.gelu``
    defaults to the tanh approximation, and so does this."""
    h = matmul(x, p["w_in"])
    if cfg.activation == "swiglu":
        h = F.silu(matmul(x, p["w_gate"])) * h
    elif cfg.activation == "geglu":
        h = F.gelu(matmul(x, p["w_gate"]), approximate="tanh") * h
    else:  # gelu
        h = F.gelu(h, approximate="tanh")
    return matmul(h, p["w_out"])


class MLP(SpecModule):
    def __init__(self, cfg, device=None, dtype=torch.float32, d_ff=None):
        super().__init__(mlp_spec(cfg, d_ff=d_ff), device, dtype)
        self.cfg = cfg

    def forward(self, x):
        return apply_mlp({name: getattr(self, name) for name in self.specs}, x, self.cfg)
