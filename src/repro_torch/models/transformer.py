"""Model assembler, inference only, ported from the JAX package's
``repro.models.transformer``.

``cfg.types`` (one block type per layer) is factored into
``(period, num_periods, tail)`` exactly as the reference does, because the
parameter tree and the cache tree are grouped that way: ``main`` holds one
stacked entry per period slot, ``tail`` the trailing uniform run, and
weight-shared blocks (``zamba_attn``) live in ``shared``. The port's model
is an ``nn.Module`` tree with one block module per layer (a weight-shared
block is one module repeated), and ``forward_hidden`` is a Python loop over
them where the reference scans. Layer ``r·len(period) + i`` is slot ``i`` of
period ``r``; its cache is entry ``r`` of the stacked slot cache, a view
that prefill and decode write in place. An encoder–decoder model
(whisper) also holds ``encoder.blocks`` and ``encoder.final_norm``.

``loss_fn`` and ``cast_for_compute`` are the training item (ROADMAP Queue 1
item 10c).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device
from repro_torch.models import blocks, layers
from repro_torch.models.spec import ParamSpec, SpecModule, iter_specs

SHARED_TYPES = {"zamba_attn"}  # weight-shared across occurrences


# ---------------------------------------------------------------------------
# layer-pattern factorization
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Pattern:
    period: tuple[str, ...]  # block types inside one period
    num_periods: int
    tail: tuple[str, ...]  # trailing uniform run


def factor_pattern(types: tuple[str, ...], max_period: int = 8) -> Pattern:
    n = len(types)
    for p in range(1, max_period + 1):
        reps = n // p
        if reps == 0:
            break
        prefix_ok = all(types[i] == types[i % p] for i in range(reps * p))
        tail = types[reps * p :]
        if prefix_ok and len(set(tail)) <= 1:
            return Pattern(tuple(types[:p]), reps, tuple(tail))
    return Pattern(tuple(types), 1, ())  # fallback: single unrolled period


def layer_slots(cfg) -> list[tuple[str, int, int]]:
    """(group, slot, rep) of every layer: where its weights sit in the
    reference's stacked tree and where its cache sits in the cache tree."""
    pat = factor_pattern(cfg.types)
    out = [("main", i, r) for r in range(pat.num_periods) for i in range(len(pat.period))]
    return out + [("tail", 0, t) for t in range(len(pat.tail))]


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def _stack_specs(spec_tree, reps: int):
    if isinstance(spec_tree, ParamSpec):
        return ParamSpec((reps,) + spec_tree.shape, ("layers",) + spec_tree.axes,
                         init=spec_tree.init, scale=spec_tree.scale)
    return {k: _stack_specs(v, reps) for k, v in spec_tree.items()}


def param_specs(cfg):
    """The reference's parameter tree, as ``ParamSpec``s (every arch)."""
    pat = factor_pattern(cfg.types)
    spec = {
        "embed": ParamSpec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed")),
        "final_norm": layers.norm_spec(cfg),
    }
    main = {}
    for i, bt in enumerate(pat.period):
        if bt in SHARED_TYPES:
            continue
        main[f"slot{i}_{bt}"] = _stack_specs(blocks.block_spec(cfg, bt), pat.num_periods)
    spec["main"] = main
    if pat.tail:
        spec["tail"] = {
            f"tail_{pat.tail[0]}": _stack_specs(
                blocks.block_spec(cfg, pat.tail[0]), len(pat.tail)
            )
        }
    shared = {}
    for bt in dict.fromkeys(t for t in cfg.types if t in SHARED_TYPES):
        shared[bt] = blocks.block_spec(cfg, bt)
    if shared:
        spec["shared"] = shared
    if cfg.is_encdec:
        spec["encoder"] = {
            "blocks": _stack_specs(blocks.block_spec(cfg, "enc"), cfg.encoder_layers),
            "final_norm": layers.norm_spec(cfg),
        }
    if not cfg.tie_embeddings:
        spec["lm_head"] = ParamSpec(
            (cfg.padded_vocab, cfg.d_model), ("vocab", "embed")
        )
    return spec


def count_params(cfg, active_only: bool = False) -> int:
    """Analytic parameter count from the spec tree (exact)."""
    total = 0
    frac = cfg.moe_top_k / cfg.num_experts if cfg.num_experts else 1.0
    for path, leaf in iter_specs(param_specs(cfg)):
        n = math.prod(leaf.shape)
        if active_only and "moe/w_" in path:
            n = int(n * frac)
        total += n
    return total


# ---------------------------------------------------------------------------
# the module tree
# ---------------------------------------------------------------------------


class Transformer(SpecModule):
    """Embedding (and an untied head), one block module per layer, final
    norm. Built empty on ``device``; ``init_params`` draws the weights and
    ``convert.params_from_reference`` copies the reference's. ``device=None``
    is the card."""

    def __init__(self, cfg, device=None, dtype=torch.float32):
        device = resolve_device(device)
        specs = param_specs(cfg)
        super().__init__({k: specs[k] for k in ("embed", "lm_head") if k in specs},
                         device, dtype)
        self.cfg = cfg
        shared = {bt: blocks.make_block(cfg, bt, device, dtype)
                  for bt in dict.fromkeys(cfg.types) if bt in SHARED_TYPES}
        self.layers = torch.nn.ModuleList(
            shared[bt] if bt in shared else blocks.make_block(cfg, bt, device, dtype)
            for bt in cfg.types
        )
        self.slots = layer_slots(cfg)
        self.final_norm = layers.make_norm(cfg, device, dtype)
        if cfg.is_encdec:
            self.encoder = torch.nn.Module()
            self.encoder.blocks = torch.nn.ModuleList(
                blocks.make_block(cfg, "enc", device, dtype) for _ in range(cfg.encoder_layers))
            self.encoder.final_norm = layers.make_norm(cfg, device, dtype)

    @property
    def head(self) -> torch.Tensor:
        return self.embed if self.cfg.tie_embeddings else self.lm_head

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg, generator: torch.Generator, dtype=torch.float32) -> Transformer:
    """A model with weights drawn from ``generator``, on the generator's
    device: normal (std 0.02 or the spec's scale), zeros or ones, as each
    spec says."""
    model = Transformer(cfg, generator.device, dtype)
    for module in model.modules():
        if isinstance(module, SpecModule):
            module.reset_parameters(generator)
    return model


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def _sinusoidal(positions, d):
    half = d // 2
    freqs = torch.exp(
        -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=positions.device)
        / half
    )
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _embed(params, tokens, cfg):
    x = params.embed[tokens]
    if cfg.pos_embed == "absolute":
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        x = x + _sinusoidal(pos, cfg.d_model).to(x.dtype)
    return x * math.sqrt(cfg.d_model)


def _encode(params, frames, cfg):
    """The encoder stack over (B, T, D) frames (sinusoidal positions when
    ``pos_embed`` is absolute), then its final norm."""
    if cfg.pos_embed == "absolute":
        pos = torch.arange(frames.shape[1], device=frames.device)[None, :]
        frames = frames + _sinusoidal(pos, cfg.d_model).to(frames.dtype)
    for block in params.encoder.blocks:
        frames, _, _ = blocks.apply_block(cfg, "enc", block, frames)
    return params.encoder.final_norm(frames)


@torch.no_grad()
def forward_hidden(params, tokens, cfg, mode="train", caches=None, pos=0, aux=None):
    """Token ids -> final hidden states. Returns (hidden, caches, aux_loss:
    the blocks' summed MoE losses); prefill and decode write ``caches`` in
    place. ``aux`` holds the modality stubs (``patches``, ``enc_frames``),
    cast to the compute dtype. The encoder runs on ``enc_frames`` in train
    and prefill only: decode's cross-attention reads the ``ck``/``cv``
    caches, so the reference's per-step encoder pass is skipped (the same
    output)."""
    x = _embed(params, tokens, cfg)
    if aux is not None:
        aux = {k: (v.to(x.dtype) if torch.is_tensor(v) else v) for k, v in aux.items()}
        if cfg.is_encdec and "enc_frames" in aux and mode != "decode":
            aux["enc_out"] = _encode(params, aux["enc_frames"], cfg)
    aux_total = 0.0
    for layer, block, (group, slot, rep) in zip(cfg.types, params.layers, params.slots):
        cache = None
        if caches is not None:
            cache = {k: v[rep] for k, v in caches[group][f"cache{slot}"].items()}
        x, _, aux_loss = blocks.apply_block(cfg, layer, block, x, mode, cache, pos, aux)
        aux_total = aux_total + aux_loss
    x = params.final_norm(x)
    return x, caches, aux_total


@torch.no_grad()
def logits_from_hidden(params, hidden, cfg):
    """(B, S, padded_vocab) f32 logits; pad columns are -1e30."""
    logits = hidden @ params.head.T
    pad_cols = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
    return logits.float().masked_fill(pad_cols, -1e30)


# ---------------------------------------------------------------------------
# KV-cache construction + decode
# ---------------------------------------------------------------------------


def cache_shapes(cfg, batch, max_seq):
    """Full cache tree of (shape, dtype, logical_axes), grouped like params."""
    pat = factor_pattern(cfg.types)
    groups = [("main", pat.period, pat.num_periods)]
    if pat.tail:
        groups.append(("tail", pat.tail[:1], len(pat.tail)))
    out = {}
    for gname, gtypes, reps in groups:
        slots = {}
        for j, bt in enumerate(gtypes):
            cs = blocks.cache_shapes(cfg, bt, batch, max_seq)
            if cs is None:
                continue
            slots[f"cache{j}"] = {
                k: ((reps,) + shape, dtype, (None,) + axes)
                for k, (shape, dtype, axes) in cs.items()
            }
        out[gname] = slots or None
    return out


def init_cache(cfg, batch, max_seq, device=None):
    """Zeroed caches on ``device`` (the card unless the caller says)."""
    device = resolve_device(device)
    return {
        gname: None if slots is None else {
            slot: {k: torch.zeros(shape, dtype=dtype, device=device)
                   for k, (shape, dtype, _) in leaves.items()}
            for slot, leaves in slots.items()
        }
        for gname, slots in cache_shapes(cfg, batch, max_seq).items()
    }


@torch.no_grad()
def decode_step(params, caches, tokens, pos, cfg, aux=None):
    """One-token decode. tokens (B,1); pos an int. -> (logits, caches)."""
    hidden, caches, _ = forward_hidden(
        params, tokens, cfg, mode="decode", caches=caches, pos=pos, aux=aux
    )
    return logits_from_hidden(params, hidden, cfg), caches


@torch.no_grad()
def prefill(params, tokens, cfg, max_seq, aux=None):
    """Full-sequence forward that fills a fresh cache. -> (logits, caches)."""
    caches = init_cache(cfg, tokens.shape[0], max_seq, device=params.device)
    hidden, caches, _ = forward_hidden(
        params, tokens, cfg, mode="prefill", caches=caches, pos=0, aux=aux
    )
    return logits_from_hidden(params, hidden, cfg), caches
