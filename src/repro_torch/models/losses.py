"""Chunked softmax cross-entropy, ported from the JAX package's
``repro.models.losses``: the (B, S, V) logits tensor is never formed, in
either direction.

Forward: a loop over sequence chunks; each chunk's (B, chunk, V) logits are
consumed by a logsumexp and a gather. Backward (``torch.autograd.Function``,
the reference's custom VJP): each chunk's logits are recomputed, and the
(softmax − one-hot) cotangent is contracted at once into the chunk's
dhidden and an f32 dembed accumulator; the target term is subtracted with a
gather/scatter, never a V-wide one-hot. Residuals are O(S·D + V·D).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import promote


def _chunks(hidden, targets, mask, chunk):
    """(B, S, …) -> (B, nc, chunk, …), zero-padded at the end of the sequence."""
    b, s, d = hidden.shape
    pad = (-s) % chunk
    nc = (s + pad) // chunk
    hid = F.pad(hidden, (0, 0, 0, pad)).reshape(b, nc, chunk, d)
    tgt = F.pad(targets, (0, pad)).reshape(b, nc, chunk)
    msk = F.pad(mask, (0, pad)).reshape(b, nc, chunk)
    return hid, tgt, msk, nc


def _logits(h, embed, pad_cols):
    """One chunk's f32 logits, pad columns at -1e30."""
    return torch.matmul(*promote(h, embed.T)).float().masked_fill(pad_cols, -1e30)


def _fwd_sums(hidden, embed, targets, mask, vocab_size, chunk):
    hid, tgt, msk, nc = _chunks(hidden, targets, mask, chunk)
    pad_cols = torch.arange(embed.shape[0], device=hidden.device) >= vocab_size
    nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(nc):
        h, t, m = hid[:, c], tgt[:, c], msk[:, c]
        logits = _logits(h, embed, pad_cols)
        lse = torch.logsumexp(logits, dim=-1)
        tl = torch.gather(logits, -1, t[..., None])[..., 0]
        nll_sum = nll_sum + ((lse - tl) * m).sum()
        cnt = cnt + m.sum()
    return nll_sum, cnt


class _Xent(torch.autograd.Function):
    """Mean NLL over the mask; the backward recomputes logits per chunk."""

    @staticmethod
    def forward(ctx, hidden, embed, targets, mask, vocab_size, chunk):
        nll_sum, cnt = _fwd_sums(hidden, embed, targets, mask, vocab_size, chunk)
        ctx.save_for_backward(hidden, embed, targets, mask, cnt)
        ctx.vocab_size, ctx.chunk = vocab_size, chunk
        return nll_sum / torch.clamp(cnt, min=1.0)

    @staticmethod
    def backward(ctx, g):
        hidden, embed, targets, mask, cnt = ctx.saved_tensors
        b, s, d = hidden.shape
        hid, tgt, msk, nc = _chunks(hidden, targets, mask, ctx.chunk)
        pad_cols = torch.arange(embed.shape[0], device=hidden.device) >= ctx.vocab_size
        scale = g / torch.clamp(cnt, min=1.0)
        embf = embed.float()
        dembed = torch.zeros(embed.shape, dtype=torch.float32, device=embed.device)
        dhs = []
        for c in range(nc):
            h, t, m = hid[:, c], tgt[:, c][..., None], msk[:, c]
            logits = _logits(h, embed, pad_cols)
            w = (m * scale)[..., None]
            dlogits = torch.softmax(logits, dim=-1) * w  # (B, chunk, Vpad)
            # the one-hot target term, subtracted by a gather and a scatter
            dlogits.scatter_(-1, t, torch.gather(dlogits, -1, t) - w)
            dhs.append((dlogits @ embf).to(h.dtype))
            dembed += torch.einsum("bcv,bcd->vd", dlogits, h.float())
        dhidden = torch.stack(dhs, 1).reshape(b, nc * ctx.chunk, d)[:, :s]
        return dhidden.to(hidden.dtype), dembed.to(embed.dtype), None, None, None, None


def chunked_softmax_xent(
    hidden: torch.Tensor,  # (B, S, D)
    embed: torch.Tensor,  # (Vpad, D): tied softmax weights
    targets: torch.Tensor,  # (B, S) int64
    vocab_size: int,  # true vocab (pad ids masked out)
    chunk: int = 512,
    mask: torch.Tensor | None = None,  # (B, S), 1.0 = count
) -> torch.Tensor:
    """Mean next-token NLL over the counted positions (a 0-d f32 tensor)."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=hidden.device)
    return _Xent.apply(hidden, embed, targets.long(), mask.float(), vocab_size, chunk)
