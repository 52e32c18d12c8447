"""Batched greedy decoding against a KV cache, ported from the JAX
package's ``repro.serving.decode``.

``make_serve_step`` is one new token for the whole batch against a cache of
``max_seq``. ``prepared_serve_step`` builds that step once per (frozen)
config, as the reference does with its jitted step; the port's step is a
plain function (no graph capture). Greedy picks are ``argmax`` over the
first ``vocab_size`` logits, the first index on ties in both packages.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.models import transformer


def make_serve_step(cfg):
    """serve_step(params, caches, tokens (B,1), pos) -> (next_tokens (B,1), caches)."""

    def serve_step(params, caches, tokens, pos, aux=None):
        logits, caches = transformer.decode_step(
            params, caches, tokens, pos, cfg, aux=aux
        )
        nxt = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1)
        return nxt[:, None], caches

    return serve_step


@functools.lru_cache(maxsize=16)
def prepared_serve_step(cfg):
    """The serve_step for ``cfg``, built once per config (configs are frozen
    dataclasses, so they hash as cache keys)."""
    return make_serve_step(cfg)


@torch.no_grad()
def generate(
    params,
    cfg,
    prompts: torch.Tensor,  # (B, P) prompt tokens on the model's device
    max_new: int = 32,
    max_seq: int | None = None,
    aux=None,
    use_prefill: bool = True,
):
    """Greedy generation: the prompt is consumed by a single parallel
    prefill (filling the KV caches), then ``max_new`` tokens decode one at a
    time. ``use_prefill=False`` processes the prompt token by token."""
    b, plen = prompts.shape
    max_seq = max_seq or (plen + max_new)
    step = prepared_serve_step(cfg)
    out = []
    if use_prefill:
        logits, caches = transformer.prefill(params, prompts, cfg, max_seq, aux=aux)
        tok = torch.argmax(logits[:, -1:, : cfg.vocab_size], dim=-1)
        out.append(tok[:, 0])
        start = plen
    else:
        caches = transformer.init_cache(cfg, b, max_seq, device=params.device)
        tok = prompts[:, :1]
        start = 0
    for t in range(start, plen + max_new - 1):
        nxt, caches = step(params, caches, tok, t, aux=aux)
        if t + 1 < plen:
            tok = prompts[:, t + 1 : t + 2]  # teacher-force the prompt
        else:
            tok = nxt
            out.append(nxt[:, 0])
    return torch.stack(out, dim=1)  # (B, max_new)
