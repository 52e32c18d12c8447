"""xLSTM blocks, ported from the JAX package's ``repro.models.xlstm``:
mLSTM (matrix memory, chunked-parallel) and sLSTM (scalar memory,
recurrent). Both are differentiated by autograd, without the reference's
inner checkpoints (the period checkpoint of ``cfg.remat`` bounds their
activations).

mLSTM runs in a chunkwise-parallel form structurally identical to SSD:
within-chunk terms are dense L×L products gated by cumulative forget-gate
decays, the across-chunk (B,H,P,P) f32 matrix memory is carried by a short
Python loop. Its exponential input gate has no running-max stabiliser, as
in the reference (the gates are log-sigmoids, so every exponent is ≤ 0).

sLSTM is a real recurrence with block-diagonal recurrent weights and the
``m`` stabiliser; it runs as a Python loop over time. Prefill and decode
write every recurrent state into ``cache`` in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.spec import ParamSpec, SpecModule
from repro_torch.models.ssm import causal_conv, conv_step, conv_tail, pad_chunks

MLSTM_CHUNK = 128


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


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


def _mlstm_gates(p, xm, h):
    """log-forget (<=0) and log-input (<=0) gates, f32. (…, H) each."""
    gates = (xm @ p.w_if).float() + p.b_if.float()
    return F.logsigmoid(gates[..., :h]), F.logsigmoid(gates[..., h:])


def _headwise(xs, w):
    """(…, H, P) × (H, P, Q) -> (…, H, Q) f32: the block-diagonal projection."""
    return torch.einsum("...hp,hpq->...hq", *layers.promote(xs, w)).float()


def apply_mlstm(p, x, cfg, chunk=MLSTM_CHUNK, cache=None):
    """x (B,S,D) -> (B,S,D); with ``cache``, the final (c, n) memory and the
    conv cache are written into it (prefill)."""
    b, s, d = x.shape
    inner, h, pd = _mlstm_dims(cfg)
    up = x @ p.up_proj
    xm, z = up[..., :inner], up[..., inner:]
    xc = causal_conv(xm, p.conv_w, p.conv_b)
    xch = xc.reshape(b, s, h, pd)
    xmh = xm.reshape(b, s, h, pd)
    q = _headwise(xch, p.w_q)
    k = _headwise(xch, p.w_k) * pd**-0.5
    v = _headwise(xmh, p.w_v)
    logf, logi = _mlstm_gates(p, xm, h)

    l = min(chunk, s)
    nc = -(-s // l)
    qs, ks, vs, lfs, lis = (pad_chunks(t, l) for t in (q, k, v, logf, logi))
    tmask = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()

    cmat = torch.zeros((b, h, pd, pd), dtype=torch.float32, device=x.device)
    nvec = torch.zeros((b, h, pd), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        qc, kc, vc, lf, li = (t[:, c] for t in (qs, ks, vs, lfs, lis))
        fcum = torch.cumsum(lf, dim=1)  # (B,L,H)
        # D(t,s) = exp(Fcum_t − Fcum_s + logi_s), s<=t — all exponents <= 0
        dmat = torch.exp(fcum[:, :, None, :] - fcum[:, None, :, :] + li[:, None, :, :])
        dmat = torch.where(tmask[None, :, :, None], dmat, 0.0)
        scores = torch.einsum("blhp,bmhp->blmh", qc, kc) * dmat
        y_intra = torch.einsum("blmh,bmhp->blhp", scores, vc)
        n_intra = scores.sum(dim=2)  # (B,L,H)
        decay_t = torch.exp(fcum)[..., None]  # (B,L,H,1)
        y_inter = torch.einsum("blhp,bhpq->blhq", qc, cmat) * decay_t
        n_inter = torch.einsum("blhp,bhp->blh", qc, nvec) * decay_t[..., 0]
        denom = torch.clamp((n_intra + n_inter).abs(), min=1.0)[..., None]
        ys.append((y_intra + y_inter) / denom)
        # carry update
        tot = fcum[:, -1, :]  # (B,H)
        wdec = torch.exp(tot[:, None, :] - fcum + li)  # (B,L,H)
        cmat = torch.exp(tot)[:, :, None, None] * cmat + torch.einsum(
            "blhp,blhq->bhpq", wdec[..., None] * kc, vc)
        nvec = torch.exp(tot)[:, :, None] * nvec + torch.einsum("blh,blhp->bhp", wdec, kc)
    y = torch.stack(ys, 1).reshape(b, nc * l, inner)[:, :s].to(x.dtype)
    y = layers.rms_norm(y, p.norm, cfg.norm_eps) * F.silu(z)
    out = y @ p.down_proj
    if cache is not None:
        cache["c"].copy_(cmat)
        cache["n"].copy_(nvec)
        cache["conv"].copy_(conv_tail(xm, cfg.conv_kernel))
    return out


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


def mlstm_decode(p, x, cache, cfg):
    """x (B,1,D) -> (B,1,D); c, n and the conv window updated in place."""
    b = x.shape[0]
    inner, h, pd = _mlstm_dims(cfg)
    up = x @ p.up_proj
    xm, z = up[..., :inner], up[..., inner:]
    xc, new_conv = conv_step(cache["conv"], xm, p.conv_w, p.conv_b)
    xch = xc.to(x.dtype).reshape(b, h, pd)
    xmh = xm.reshape(b, h, pd)
    q = _headwise(xch, p.w_q)
    k = _headwise(xch, p.w_k) * pd**-0.5
    v = _headwise(xmh, p.w_v)
    logf, logi = _mlstm_gates(p, xm[:, 0], h)  # (B,H)
    f, i = torch.exp(logf), torch.exp(logi)
    c_new = f[:, :, None, None] * cache["c"] + i[:, :, None, None] * (
        k[..., :, None] * v[..., None, :])
    n_new = f[:, :, None] * cache["n"] + i[:, :, None] * k
    num = torch.einsum("bhp,bhpq->bhq", q, c_new)
    den = torch.clamp(torch.einsum("bhp,bhp->bh", q, n_new).abs(), min=1.0)
    y = (num / den[..., None]).reshape(b, 1, inner).to(x.dtype)
    y = layers.rms_norm(y, p.norm, cfg.norm_eps) * F.silu(z)
    cache["c"].copy_(c_new)
    cache["n"].copy_(n_new)
    cache["conv"].copy_(new_conv)
    return y @ p.down_proj


class MLSTM(SpecModule):
    """The ``mlstm`` block: x + mLSTM mixer."""

    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__(mlstm_spec(cfg), device, dtype)
        self.cfg = cfg

    def forward(self, x, mode="train", cache=None, pos=0, aux=None):
        if mode == "decode":
            return x + mlstm_decode(self, x, cache, self.cfg), cache, 0.0
        out = apply_mlstm(self, x, self.cfg, cache=cache if mode == "prefill" else None)
        return x + out, cache, 0.0


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


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


def _slstm_cell(p, xt, state, cfg):
    """One recurrent step. xt (B,D); state dict of (B,H,Pd) f32."""
    b = xt.shape[0]
    h, pd = _slstm_dims(cfg)
    gx = (xt @ p.w_gates + p.b_gates.to(xt.dtype)).reshape(b, h, 4 * pd)
    gr = torch.einsum("bhp,hpq->bhq", *layers.promote(state["h"], p.r_gates))
    g = (gx + gr).float()
    zt, it, ft, ot = torch.split(g, pd, dim=-1)  # (B,H,Pd) each
    m_new = torch.maximum(ft + state["m"], it)  # stabilizer state
    i = torch.exp(it - m_new)
    f = torch.exp(ft + state["m"] - m_new)
    c = f * state["c"] + i * torch.tanh(zt)
    n = f * state["n"] + i
    hid = torch.sigmoid(ot) * c / torch.clamp(n, min=1.0)
    return {"c": c, "n": n, "m": m_new, "h": hid}


def _slstm_out(p, y, cfg):
    """The block's output from the hidden states (B,S,D): RMSNorm, the out
    projection and the gated feed-forward with its residual."""
    y = layers.rms_norm(y, p.norm, cfg.norm_eps) @ p.out_proj
    ff = F.silu(y @ p.ffn.w_gate) * (y @ p.ffn.w_in)
    return y + ff @ p.ffn.w_out


def apply_slstm(p, x, cfg, cache=None):
    """x (B,S,D) -> (B,S,D), a Python loop over time; with ``cache``, the
    final (c, n, m, h) are written into it (prefill)."""
    b, s, d = x.shape
    h, pd = _slstm_dims(cfg)
    state = {k: torch.zeros((b, h, pd), dtype=torch.float32, device=x.device)
             for k in ("c", "n", "m", "h")}
    hs = []
    for t in range(s):
        state = _slstm_cell(p, x[:, t], state, cfg)
        hs.append(state["h"])
    y = torch.stack(hs, 1).reshape(b, s, d).to(x.dtype)
    if cache is not None:
        for k, v in state.items():
            cache[k].copy_(v)
    return _slstm_out(p, y, cfg)


def slstm_cache_shapes(cfg, batch):
    h, pd = _slstm_dims(cfg)
    return {
        k: ((batch, h, pd), torch.float32, ("batch", None, None))
        for k in ("c", "n", "m", "h")
    }


def slstm_decode(p, x, cache, cfg):
    """x (B,1,D) -> (B,1,D); the four states updated in ``cache`` in place."""
    b = x.shape[0]
    new = _slstm_cell(p, x[:, 0], cache, cfg)
    for k, v in new.items():
        cache[k].copy_(v)
    y = new["h"].reshape(b, 1, -1).to(x.dtype)
    return _slstm_out(p, y, cfg)


class SLSTM(SpecModule):
    """The ``slstm`` block: x + sLSTM mixer and its feed-forward."""

    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__(slstm_spec(cfg), device, dtype)
        self.cfg = cfg

    def forward(self, x, mode="train", cache=None, pos=0, aux=None):
        if mode == "decode":
            return x + slstm_decode(self, x, cache, self.cfg), cache, 0.0
        out = apply_slstm(self, x, self.cfg, cache=cache if mode == "prefill" else None)
        return x + out, cache, 0.0
