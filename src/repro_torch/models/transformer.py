"""Model assembler, ported from the JAX package's
``repro.models.transformer``: the forward, the training loss and
mixed-precision casts, prefill and KV-cache decode.

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

Training runs ``loss_fn`` with autograd: each module computes on bf16
copies of its f32 matrices (``cast_for_compute``), made inside its period,
and each period is checkpointed under ``cfg.remat == "block"``. Serving
(``logits_from_hidden``, ``prefill``, ``decode_step``) runs under
``torch.no_grad`` on f32 weights.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import blocks, layers, losses
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


def _embed(params, tokens, cfg, cast=False):
    """Embedding rows (of the table's ``cast_for_compute`` copy when
    ``cast``), plus sinusoidal positions when ``pos_embed`` is absolute,
    times √d, which is rounded to the rows' dtype first, as the reference's
    ``jnp.asarray(√d, x.dtype)`` is (45.25 for d = 2048 in bf16)."""
    x = (_cast(params.embed, cfg) if cast else params.embed)[tokens]
    if cfg.pos_embed == "absolute":
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        x = x + _sinusoidal(pos, cfg.d_model).to(x.dtype)
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)


def _casts(t, cfg) -> bool:
    """Whether ``cast_for_compute`` copies ``t``: an f32 matrix (ndim >= 2)
    when ``cfg.dtype`` is bfloat16."""
    return cfg.dtype == "bfloat16" and t.dtype == torch.float32 and t.ndim >= 2


def _cast(t, cfg):
    return t.to(torch.bfloat16) if _casts(t, cfg) else t


def cast_for_compute(module, cfg) -> dict:
    """Mixed precision, per module: {name: bf16 copy} of every f32 parameter
    of ``module`` with ndim >= 2 when ``cfg.dtype`` is bfloat16 (empty
    otherwise); vectors (norms, biases, gates) stay f32. The copies are
    differentiable, so gradients flow back to the f32 masters. Run the module
    on them with ``torch.func.functional_call``."""
    return {name: p.to(torch.bfloat16) for name, p in module.named_parameters()
            if _casts(p, cfg)}


@contextlib.contextmanager
def record_compute_dtypes(model):
    """While open, the yielded ``collections.Counter`` counts, by dtype, the
    matrices (parameters with ndim >= 2) that each layer and encoder block
    of ``model`` computes with, once per call: the checkpoint's recompute
    counts again. Under ``cast_for_compute`` every one is a bf16 copy; the
    outputs are unchanged."""
    seen = collections.Counter()

    def count(block, _args, names):
        seen.update(functools.reduce(getattr, name.split("."), block).dtype for name in names)

    units = list(model.layers) + (list(model.encoder.blocks) if model.cfg.is_encdec else [])
    hooks = []
    for block in dict.fromkeys(units):  # a weight-shared block once
        names = [name for name, p in block.named_parameters() if p.ndim >= 2]
        hooks.append(block.register_forward_pre_hook(functools.partial(count, names=names)))
    try:
        yield seen
    finally:
        for hook in hooks:
            hook.remove()


def _call(module, cast, cfg, *args):
    """``module(*args)``, on its ``cast_for_compute`` copies when ``cast``."""
    if not cast:
        return module(*args)
    return torch.func.functional_call(module, cast_for_compute(module, cfg), args)


def _encode(params, frames, cfg, cast=False, remat=False):
    """The encoder stack over (B, T, D) frames (sinusoidal positions when
    ``pos_embed`` is absolute), then its final norm; each block is one
    checkpointed period under ``remat``."""
    if cfg.pos_embed == "absolute":
        pos = torch.arange(frames.shape[1], device=frames.device)[None, :]
        frames = frames + _sinusoidal(pos, cfg.d_model).to(frames.dtype)
    for block in params.encoder.blocks:
        run = functools.partial(_call, block, cast, cfg)
        if remat:
            frames, _, _ = checkpoint(run, frames, use_reentrant=False)
        else:
            frames, _, _ = run(frames)
    return params.encoder.final_norm(frames)


def _periods(params):
    """Runs of layer indices that the reference scans as one period body:
    each repetition of the main period, then each tail layer alone."""
    keys = [(group, rep) for group, _, rep in params.slots]
    return [list(run) for _, run in itertools.groupby(range(len(keys)), keys.__getitem__)]


def _run_period(params, cfg, period, mode, caches, pos, aux, cast, x):
    """The layers of one period on ``x``: (x, their summed aux loss)."""
    aux_loss = 0.0
    for i in period:
        group, slot, rep = params.slots[i]
        cache = None
        if caches is not None:
            cache = {k: v[rep] for k, v in caches[group][f"cache{slot}"].items()}
        x, _, al = _call(params.layers[i], cast, cfg, x, mode, cache, pos, aux)
        aux_loss = aux_loss + al
    return x, aux_loss


def forward_hidden(params, tokens, cfg, mode="train", caches=None, pos=0, aux=None,
                   cast=False):
    """Token ids -> final hidden states. Returns (hidden, caches, aux_loss:
    the blocks' summed MoE losses); prefill and decode write ``caches`` in
    place. ``aux`` holds the modality stubs (``patches``, ``enc_frames``),
    cast to the compute dtype. The encoder runs on ``enc_frames`` in train
    and prefill only: decode's cross-attention reads the ``ck``/``cv``
    caches, so the reference's per-step encoder pass is skipped (the same
    output).

    Autograd records the forward when the weights require gradients (the
    serving entry points run it under ``torch.no_grad``). ``cast`` computes
    each module on its ``cast_for_compute`` copies, made inside the module's
    period. In train mode with gradients enabled and ``cfg.remat ==
    "block"``, each period (``_periods``) runs under non-reentrant
    ``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of the
    scanned period body: the backward recomputes it, casts included."""
    remat = mode == "train" and cfg.remat == "block" and torch.is_grad_enabled()
    x = _embed(params, tokens, cfg, cast)
    if aux is not None:
        aux = {k: (v.to(x.dtype) if torch.is_tensor(v) else v) for k, v in aux.items()}
        if cfg.is_encdec and "enc_frames" in aux and mode != "decode":
            aux["enc_out"] = _encode(params, aux["enc_frames"], cfg, cast, remat)
    aux_total = 0.0
    for period in _periods(params):
        run = functools.partial(_run_period, params, cfg, period, mode, caches, pos, aux, cast)
        x, aux_loss = checkpoint(run, x, use_reentrant=False) if remat else run(x)
        aux_total = aux_total + aux_loss
    x = params.final_norm(x)
    return x, caches, aux_total


@torch.no_grad()
def logits_from_hidden(params, hidden, cfg):
    """(B, S, padded_vocab) f32 logits; pad columns are -1e30."""
    logits = hidden @ params.head.T
    pad_cols = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
    return logits.float().masked_fill(pad_cols, -1e30)


def loss_fn(params, batch, cfg):
    """batch: tokens (B, S), targets (B, S), optional enc_frames / patches /
    mask. -> (nll + 0.01·aux_loss, {"nll", "aux_loss"}), 0-d f32 tensors.
    The matrices compute in ``cfg.dtype`` (``cast_for_compute``); the
    cross-entropy is chunked (``losses.chunked_softmax_xent``)."""
    aux = {k: batch[k] for k in ("enc_frames", "patches") if k in batch}
    hidden, _, aux_loss = forward_hidden(
        params, batch["tokens"], cfg, mode="train", aux=aux or None, cast=True
    )
    nll = losses.chunked_softmax_xent(
        hidden, _cast(params.head, cfg), batch["targets"], cfg.vocab_size,
        chunk=cfg.xent_chunk, mask=batch.get("mask"),
    )
    aux_loss = torch.as_tensor(aux_loss, dtype=torch.float32, device=nll.device)
    total = nll + 0.01 * aux_loss
    return total, {"nll": nll, "aux_loss": aux_loss}


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
