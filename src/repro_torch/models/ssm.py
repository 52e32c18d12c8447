"""Mamba2 (SSD) block, ported from the JAX package's ``repro.models.ssm``.

Prefill and train use the chunked SSD algorithm: within-chunk interactions
are dense L×L products, across-chunk state is a short Python loop over
(B,H,N,P) f32 states (the reference's ``lax.scan``). Decode is the O(1)
recurrent update. All decays are exponentials of non-positive numbers
(A < 0), so the chunked form needs no extra rescaling. Prefill and decode
write the state and the conv cache into ``cache`` in place.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers
from repro_torch.models.spec import ParamSpec, SpecModule

SSD_CHUNK = 128


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


def _split_proj(p, x, cfg):
    inner, n = cfg.ssm_inner, cfg.ssm_state
    zxbcdt = x @ p.in_proj
    z = zxbcdt[..., :inner]
    xbc = zxbcdt[..., inner : 2 * inner + 2 * n]
    dt_raw = zxbcdt[..., 2 * inner + 2 * n :]
    dt = F.softplus(dt_raw.float() + p.dt_bias.float())
    return z, xbc, dt  # dt: f32 (…, H)


def causal_conv(xs, conv_w, conv_b):
    """Depthwise causal conv over seq by K shifted adds, then SiLU. xs
    (B, S, C) -> (B, S, C) in its dtype."""
    k, s = conv_w.shape[0], xs.shape[1]
    out = torch.zeros_like(xs)
    for i in range(k):
        shift = k - 1 - i
        out = out + F.pad(xs, (0, 0, shift, 0))[:, :s] * conv_w[i]
    return F.silu(out + conv_b.to(out.dtype))


def conv_tail(xs, k):
    """The decode conv cache after a prompt: the last K − 1 raw (pre-conv)
    channels in f32, zero-padded in front when the prompt is shorter."""
    s = xs.shape[1]
    return F.pad(xs.float(), (0, 0, max(k - 1 - s, 0), 0))[:, -(k - 1):]


def pad_chunks(t, l):
    """(B, S, …) -> (B, nc, L, …), zero-padded at the end of the sequence."""
    b, s = t.shape[:2]
    pad = (-s) % l
    t = F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
    return t.reshape((b, (s + pad) // l, l) + t.shape[2:])


def _gated_out(p, y, z, cfg):
    y = layers.rms_norm(y * F.silu(z), p.norm, cfg.norm_eps)
    return y @ p.out_proj


def _ssd_chunk(state, xcv, dts, bs, cs, a, tmask):
    """One SSD chunk in f32: (carried state (B,H,N,P), the chunk's
    y (B,L,H,P)) from its x (B,L,H,P), dt (B,L,H), B and C (B,L,N)."""
    xcv, dts, bs, cs = (t.float() for t in (xcv, dts, bs, cs))
    da = dts * a  # (B,L,H) <= 0
    cum = torch.cumsum(da, dim=1)  # inclusive
    # --- intra-chunk (dense) ---
    scores = torch.einsum("bln,bmn->blm", cs, bs)  # (B,L,L) t,s
    decay = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])  # (B,L,L,H)
    m = torch.where(tmask[None, :, :, None], scores[..., None] * decay, 0.0)
    m = m * dts[:, None, :, :]
    y_intra = torch.einsum("blmh,bmhp->blhp", m, xcv)
    # --- inter-chunk (carried state) ---
    y_inter = torch.einsum("bln,bhnp->blhp", cs, state) * torch.exp(cum)[..., None]
    # --- state update ---
    tot = cum[:, -1, :]  # (B,H)
    w = torch.exp(tot[:, None, :] - cum) * dts  # (B,L,H)
    s_c = torch.einsum("bln,blhp->bhnp", bs, w[..., None] * xcv)
    state = torch.exp(tot)[:, :, None, None] * state + s_c
    return state, y_intra + y_inter


def apply_mamba2(p, x, cfg, chunk=SSD_CHUNK, cache=None):
    """x (B,S,D) -> (B,S,D). Chunked SSD scan; with ``cache``, the final
    state and the conv cache are written into it (prefill). Under autograd
    each chunk is checkpointed (the reference's ``jax.checkpoint`` of
    ``chunk_step``)."""
    b, s, _ = x.shape
    inner, n, h, pd = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc_raw, dt = _split_proj(p, x, cfg)
    xbc = causal_conv(xbc_raw, p.conv_w, p.conv_b)
    xv = xbc[..., :inner]
    bmat = xbc[..., inner : inner + n].float()
    cmat = xbc[..., inner + n :].float()
    a = -torch.exp(p.a_log.float())  # (H,) < 0

    l = min(chunk, s)
    nc = -(-s // l)
    # compute dtype outside the chunk body, f32 inside (the reference's casts)
    xh = pad_chunks(xv, l).reshape(b, nc, l, h, pd)
    dtc = pad_chunks(dt.to(x.dtype), l)  # (B,nc,L,H)
    bc = pad_chunks(bmat.to(x.dtype), l)  # (B,nc,L,N)
    cc = pad_chunks(cmat.to(x.dtype), l)
    tmask = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()  # t >= s

    step = _ssd_chunk
    if torch.is_grad_enabled() and xh.requires_grad:
        step = functools.partial(checkpoint, _ssd_chunk, use_reentrant=False)
    state = torch.zeros((b, h, n, pd), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        state, y_c = step(state, xh[:, c], dtc[:, c], bc[:, c], cc[:, c], a, tmask)
        ys.append(y_c)
    y = torch.stack(ys, 1).reshape(b, nc * l, h, pd)[:, :s]
    y = y + xv.reshape(b, s, h, pd).float() * p.d_skip.float()[:, None]
    y = y.reshape(b, s, inner).to(x.dtype)
    out = _gated_out(p, y, z, cfg)
    if cache is not None:
        cache["state"].copy_(state)
        cache["conv"].copy_(conv_tail(xbc_raw, cfg.conv_kernel))
    return out


def mamba2_cache_shapes(cfg, batch):
    n, h, pd, k = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim, cfg.conv_kernel
    conv_dim = cfg.ssm_inner + 2 * n
    return {
        "state": ((batch, h, n, pd), torch.float32, ("batch", None, None, None)),
        "conv": ((batch, k - 1, conv_dim), torch.float32, ("batch", None, "inner")),
    }


def conv_step(cache_conv, xs, conv_w, conv_b):
    """One decode step of the causal conv: the f32 window of the cache and
    the new raw channels (B, 1, C) -> (SiLU output (B, C) f32, next window)."""
    conv_in = torch.cat([cache_conv, xs.float()], dim=1)  # (B,K,C)
    out = F.silu(torch.einsum("bkc,kc->bc", conv_in, conv_w.float()) + conv_b.float())
    return out, conv_in[:, 1:]


def mamba2_decode(p, x, cache, cfg):
    """x (B,1,D) + recurrent state -> y (B,1,D); the state and the conv
    window are updated in ``cache`` in place."""
    b = x.shape[0]
    inner, n, h, pd = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt = _split_proj(p, x, cfg)  # (B,1,·)
    xbc_t, new_conv = conv_step(cache["conv"], xbc, p.conv_w, p.conv_b)
    xv = xbc_t[:, :inner].reshape(b, h, pd)
    bmat = xbc_t[:, inner : inner + n]
    cmat = xbc_t[:, inner + n :]
    a = -torch.exp(p.a_log.float())
    da = torch.exp(dt[:, 0] * a)  # (B,H)
    state = cache["state"] * da[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhnp", dt[:, 0], bmat, xv)
    y = torch.einsum("bn,bhnp->bhp", cmat, state) + xv * p.d_skip.float()[:, None]
    y = y.reshape(b, 1, inner).to(x.dtype)
    cache["state"].copy_(state)
    cache["conv"].copy_(new_conv)
    return _gated_out(p, y, z, cfg)


class Mamba2(SpecModule):
    """The ``mamba2`` block: x + SSD mixer (no pre-norm, as the reference)."""

    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__(mamba2_spec(cfg), device, dtype)
        self.cfg = cfg

    def forward(self, x, mode="train", cache=None, pos=0, aux=None):
        if mode == "decode":
            return x + mamba2_decode(self, x, cache, self.cfg), cache, 0.0
        out = apply_mamba2(self, x, self.cfg, cache=cache if mode == "prefill" else None)
        return x + out, cache, 0.0
