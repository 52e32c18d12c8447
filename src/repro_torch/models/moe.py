"""Fine-grained Mixture-of-Experts (DeepSeek-MoE style) with sort-based
dispatch, ported from the JAX package's ``repro.models.moe``.

Token→expert assignments are ordered by a stable sort of the expert ids,
tokens are gathered into a static (E, capacity, D) buffer (overflow goes to
one extra row, which is dropped: the capacity-factor semantics), the
experts run as batched (E, C, D)×(E, D, F) products, and the results are
added back to their tokens weighted by the router gates (``index_add_``).
Capacity is per dispatch chunk, so the chunking is the reference's exactly:
a different chunking drops different tokens.

Shared experts (DeepSeek's 2 always-on experts) are a plain gated MLP of
width ``num_shared_experts · moe_d_ff``.
"""
from __future__ import annotations

import contextlib
import functools
from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers
from repro_torch.models.spec import ParamSpec, SpecModule


def moe_spec(cfg):
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    spec = {
        "router": ParamSpec((d, e), ("embed", None), scale=d**-0.5),
        "w_in": ParamSpec((e, d, f), ("experts", "embed", "ff")),
        "w_gate": ParamSpec((e, d, f), ("experts", "embed", "ff")),
        "w_out": ParamSpec((e, f, d), ("experts", "ff", "embed")),
    }
    if cfg.num_shared_experts:
        fs = cfg.num_shared_experts * cfg.moe_d_ff
        spec["shared"] = layers.mlp_spec(cfg, d_ff=fs)
    return spec


class MoE(SpecModule):
    """Router, stacked expert weights and (``shared``) the shared experts."""

    records = None  # a list while ``record_routing`` is open

    def __init__(self, cfg, device=None, dtype=torch.float32):
        spec = moe_spec(cfg)
        shared = spec.pop("shared", None)
        super().__init__(spec, device, dtype)
        self.cfg = cfg
        if shared is not None:
            self.shared = layers.MLP(cfg, device, dtype,
                                     d_ff=cfg.num_shared_experts * cfg.moe_d_ff)

    def forward(self, x):
        return apply_moe(self, x, self.cfg, self.records)


def capacity(t: int, cfg) -> int:
    """Slots per expert for a dispatch of ``t`` tokens (the reference's
    expression, Python's ``round``)."""
    return max(8, int(round(t * cfg.moe_top_k / cfg.num_experts * cfg.capacity_factor)))


def route(p, x_flat, cfg):
    """The router of one dispatch: (probs (T, E) f32, renormalised gates
    (T, k) f32, expert ids (T, k)), the k slots in descending order of
    probability as ``jax.lax.top_k`` gives them."""
    logits = (x_flat @ p.router).float()
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, cfg.moe_top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, eidx


def _dispatch_combine(p, x_flat, cfg):
    """x_flat (T, D) -> ((T, D), aux loss, (expert ids (T, k), probs (T, E),
    the number of (token, slot) pairs dropped for capacity, a 0-d tensor));
    sort-based capacity dispatch."""
    t, d = x_flat.shape
    e, k = cfg.num_experts, cfg.moe_top_k
    cap = capacity(t, cfg)
    probs, gates, eidx = route(p, x_flat, cfg)

    flat_e = eidx.reshape(-1)  # (T·k,)
    flat_g = gates.reshape(-1).to(x_flat.dtype)
    flat_tok = torch.arange(t, device=x_flat.device).repeat_interleave(k)

    order = torch.sort(flat_e, stable=True).indices
    e_sorted = flat_e[order]
    tok_sorted = flat_tok[order]
    g_sorted = flat_g[order]

    # (E,): a count of static length, as the reference's jnp.bincount(length=e)
    counts = flat_e.new_zeros(e).scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * k, device=x_flat.device) - starts[e_sorted]
    keep = pos_in_e < cap
    slot = torch.where(keep, e_sorted * cap + pos_in_e, e * cap)  # overflow slot

    buf = x_flat.new_zeros((e * cap + 1, d))
    buf[slot] = x_flat[tok_sorted]
    h = buf[: e * cap].reshape(e, cap, d)
    act = F.silu(torch.bmm(h, p.w_gate)) * torch.bmm(h, p.w_in)
    out = torch.bmm(act, p.w_out).reshape(e * cap, d)
    out = torch.cat([out, out.new_zeros((1, d))])  # overflow -> 0

    y = x_flat.new_zeros((t, d)).index_add_(
        0, tok_sorted, out[slot] * (g_sorted * keep)[:, None])

    # Switch-style load-balance aux loss: E · Σ_e fraction_e · mean_prob_e
    frac = counts.float() / max(t * k, 1)
    aux = e * torch.sum(frac * probs.mean(dim=0))
    return y, aux, (eidx, probs, (~keep).sum())


def _chunks(x, cfg):
    """x (B, S, D) -> the (chunk, D) token slices ``apply_moe`` dispatches:
    ``moe_seq_chunk`` tokens each, or one chunk when that does not divide."""
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    t = x_flat.shape[0]
    chunk = min(cfg.moe_seq_chunk, t)
    if t % chunk:
        chunk = t  # the reference's fallback: one dispatch for odd shapes
    return x_flat.split(chunk)


def apply_moe(p, x, cfg, record=None):
    """x (B, S, D) -> (y, aux_loss). Dispatch runs in sequence chunks to
    bound the sort/buffer working set; the aux loss is the chunks' mean.
    Under autograd each chunk's dispatch is checkpointed (the reference's
    ``jax.checkpoint`` of ``run_chunk``): the backward recomputes it from
    the chunk's tokens, routing included. A list ``record`` gets one entry
    of what the dispatch did: (expert ids (T, k), probs (T, E) f32, the
    (token, slot) pairs dropped for capacity over the chunks)."""
    dispatch = _dispatch_combine
    if torch.is_grad_enabled() and (x.requires_grad or p.router.requires_grad):
        dispatch = functools.partial(checkpoint, _dispatch_combine, use_reentrant=False)
    # the weights as this call sees them (a caller's cast copies), so that the
    # recompute in the backward reads the same tensors
    w = SimpleNamespace(**{name: getattr(p, name) for name in ("router", "w_in", "w_gate", "w_out")})
    ys, auxs, routed = zip(*(dispatch(w, xc, cfg) for xc in _chunks(x, cfg)))
    y = torch.cat(ys).reshape(x.shape)
    if cfg.num_shared_experts:
        y = y + p.shared(x)
    if record is not None:
        eidx, probs, dropped = zip(*routed)
        record.append((torch.cat(eidx), torch.cat(probs), int(sum(dropped))))
    return y, torch.stack(auxs).mean()


def routing(p, x, cfg):
    """``apply_moe(p, x, cfg)``'s record: what its dispatch routed."""
    record = []
    apply_moe(p, x, cfg, record)
    return record[0]


@contextlib.contextmanager
def record_routing(model):
    """While open, every ``MoE`` layer of ``model`` that runs appends its
    dispatch's record (``apply_moe``) to the yielded list, one entry per
    call, in call order. The outputs are unchanged."""
    records = []
    moes = [module for module in model.modules() if isinstance(module, MoE)]
    for module in moes:
        module.records = records
    try:
        yield records
    finally:
        for module in moes:
            module.records = None
