"""Analytic per-step cost model: FLOPs, HBM bytes, collective bytes, copied
from the JAX package's ``repro.models.costs``.

The FLOP and byte counts are the reference's, since they are properties of
the model (the reference validates them against compiled XLA cost analysis
in its own tests). Only the hardware constants differ: the reference's are
a TPU's, the port's are one NVIDIA H100 SXM's data-sheet peaks.

Conventions: 1 MAC = 2 FLOPs; causal attention scores count S²/2; backward
= 2× forward; ``remat="block"`` adds one extra forward recompute.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.shapes import ShapeConfig
from repro_torch.models import transformer
from repro_torch.models.spec import iter_specs


@dataclasses.dataclass(frozen=True)
class StepCost:
    flops: float  # total FLOPs per step (global)
    hbm_bytes: float  # per-DEVICE HBM traffic per step
    coll_bytes: float  # per-DEVICE collective traffic per step
    notes: dict


def _attn_block_fwd(cfg, t, s_ctx, causal=True, queries=None):
    """Dense/GQA attention block fwd FLOPs (global). t = query tokens."""
    d = cfg.d_model
    dh = cfg.head_dim_actual
    qf, kf = cfg.num_heads * dh, cfg.num_kv_heads * dh
    proj = 2 * t * d * (2 * qf + 2 * kf)
    core = 4 * t * s_ctx * cfg.num_heads * dh * (0.5 if causal else 1.0)
    return proj + core


def _mlp_fwd(cfg, t, d_ff=None, gated=None):
    d_ff = cfg.d_ff if d_ff is None else d_ff
    gated = cfg.activation in ("swiglu", "geglu") if gated is None else gated
    return (6 if gated else 4) * t * cfg.d_model * d_ff


def _moe_fwd(cfg, t):
    router = 2 * t * cfg.d_model * cfg.num_experts
    routed = 6 * (t * cfg.moe_top_k * cfg.capacity_factor) * cfg.d_model * cfg.moe_d_ff
    shared = 6 * t * cfg.d_model * (cfg.num_shared_experts * cfg.moe_d_ff)
    return router + routed + shared


def _mla_fwd(cfg, t, s_ctx):
    d, h = cfg.d_model, cfg.num_heads
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    proj = 2 * t * (
        d * cfg.q_lora_rank
        + cfg.q_lora_rank * h * (nope + rope)
        + d * (cfg.kv_lora_rank + rope)
        + cfg.kv_lora_rank * h * (nope + vd)
        + h * vd * d
    )
    core = 2 * t * s_ctx * h * ((nope + rope) + vd) * 0.5
    return proj + core


def _mamba2_fwd(cfg, t):
    d, inner = cfg.d_model, cfg.ssm_inner
    n, h, p = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    l = 128  # SSD chunk
    proj = 2 * t * d * (2 * inner + 2 * n + h) + 2 * t * inner * d
    conv = 2 * t * (inner + 2 * n) * cfg.conv_kernel
    intra = 2 * t * l * (n + h * p)  # scores + decay-weighted matmul
    inter = 4 * t * h * n * p  # state build + readout
    return proj + conv + intra + inter


def _mlstm_fwd(cfg, t):
    d = cfg.d_model
    inner = int(cfg.mlstm_proj_factor * d)
    h = cfg.num_heads
    p = inner // h
    l = 128
    proj = 2 * t * d * 2 * inner + 2 * t * inner * d + 6 * t * inner * p
    intra = 4 * t * l * h * p  # qk scores + weighted v
    inter = 4 * t * h * p * p  # memory readout + update
    return proj + intra + inter


def _slstm_fwd(cfg, t):
    d = cfg.d_model
    h = cfg.num_heads
    pd = d // h
    ff = int(cfg.slstm_proj_factor * d)
    gates = 2 * t * d * 4 * d + 2 * t * h * pd * 4 * pd
    ffn = 6 * t * d * ff
    out = 2 * t * d * d
    return gates + ffn + out


def _cross_fwd(cfg, t, b, s_ctx_self, causal=True):
    d = cfg.d_model
    dh = cfg.head_dim_actual
    qf, kf = cfg.num_heads * dh, cfg.num_kv_heads * dh
    self_attn = _attn_block_fwd(cfg, t, s_ctx_self, causal)
    src = cfg.vision_seq or cfg.encoder_seq
    kv = 2 * b * src * d * 2 * kf
    qo = 2 * t * d * 2 * qf
    core = 4 * t * src * cfg.num_heads * dh
    return self_attn + kv + qo + core


BLOCK_FWD = {}


def block_fwd_flops(cfg, btype, t, b, s_ctx, mode):
    """Forward FLOPs for one block over t query tokens (global)."""
    causal = mode != "enc"
    if btype in ("dense", "zamba_attn", "enc"):
        return _attn_block_fwd(cfg, t, s_ctx, causal) + _mlp_fwd(cfg, t)
    if btype == "moe":
        return _attn_block_fwd(cfg, t, s_ctx, causal) + _moe_fwd(cfg, t)
    if btype == "mla_moe":
        return _mla_fwd(cfg, t, s_ctx) + _moe_fwd(cfg, t)
    if btype == "mamba2":
        return _mamba2_fwd(cfg, t)
    if btype == "mlstm":
        return _mlstm_fwd(cfg, t)
    if btype == "slstm":
        return _slstm_fwd(cfg, t)
    if btype == "cross":
        return _cross_fwd(cfg, t, b, s_ctx) + _mlp_fwd(cfg, t)
    if btype == "encdec_dec":
        return _cross_fwd(cfg, t, b, s_ctx) + _mlp_fwd(cfg, t)
    raise ValueError(btype)


def forward_flops(cfg, b, s, mode="train", s_ctx=None):
    """Whole-model forward FLOPs (global) for b×s query tokens."""
    t = b * s
    s_ctx = s_ctx if s_ctx is not None else s
    total = 0.0
    for bt in cfg.types:
        total += block_fwd_flops(cfg, bt, t, b, s_ctx, mode)
    if cfg.is_encdec:
        te = b * cfg.encoder_seq
        for _ in range(cfg.encoder_layers):
            total += block_fwd_flops(cfg, "enc", te, b, cfg.encoder_seq, "enc")
    total += 2 * t * cfg.d_model * cfg.padded_vocab  # logits
    return total


def model_flops_6nd(cfg, b, s, active=True):
    """The classic 6·N·D reference (N = active params, D = tokens)."""
    n = cfg.active_param_count() if active else cfg.param_count()
    return 6.0 * n * b * s


# ---------------------------------------------------------------------------
# per-step cost for a (cfg, shape, mesh) cell
# ---------------------------------------------------------------------------


def _cache_bytes_global(cfg, b, s):
    """Total decode-cache bytes (global) — mirrors transformer.cache_shapes
    (2 bytes for bfloat16 leaves, 4 for any other, as the reference counts)."""
    total = 0
    for slots in transformer.cache_shapes(cfg, b, s).values():
        for leaves in (slots or {}).values():
            for shape, dtype, _ in leaves.values():
                total += math.prod(shape) * (2 if dtype == torch.bfloat16 else 4)
    return total


def decode_bytes(cfg, b, s):
    """The least HBM bytes of one decode step of batch ``b`` against caches
    of ``s`` positions on one device: every weight read once at 4 bytes
    (f32, as ``init_params`` draws them), the encoder's excepted (decode reads the cross
    caches instead), and the whole cache read once. A MoE layer reads all of
    its experts: the capacity dispatch gives each expert at least 8 slots,
    so every expert runs on a decode step."""
    weights = sum(math.prod(leaf.shape) for path, leaf in iter_specs(transformer.param_specs(cfg))
                  if not path.startswith("encoder/"))
    return weights * 4 + _cache_bytes_global(cfg, b, s)


def step_cost(cfg, shape: ShapeConfig, num_devices: int, mesh_shape: dict,
              remat: bool = True) -> StepCost:
    """Analytic roofline inputs for one cell.

    mesh_shape: dict like {"pod":2,"data":16,"model":16} (pod optional).
    """
    b, s = shape.global_batch, shape.seq_len
    data_ways = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    model_ways = mesh_shape.get("model", 1)
    p_total = cfg.param_count()
    p_local_f32 = p_total * 4 / num_devices  # fully sharded masters
    p_model_shard_bf16 = p_total * 2 / model_ways  # TP shard, bf16 compute copy

    notes = {}
    if shape.kind == "train":
        fwd = forward_flops(cfg, b, s, "train")
        mult = 4.0 if remat else 3.0  # fwd + 2×bwd (+1 remat recompute)
        flops = fwd * mult
        t_loc = b * s / data_ways
        act = 12 * len(cfg.types) * t_loc * cfg.d_model * 2  # act r/w, bf16
        hbm = (
            2 * 2 * p_total * 2 / num_devices  # weight reads fwd+recompute+bwd (bf16, FSDP-sharded)
            + 9 * p_local_f32  # grads w/r + adam p/m/v read+write
            + act
        )
        # FSDP all-gathers (fwd + bwd re-gather) + grad reduce-scatter, plus
        # TP activation all-reduces (2 per block fwd, 2× that in bwd).
        fsdp = 3 * p_model_shard_bf16 * (data_ways - 1) / data_ways
        tp_ar = (
            6 * len(cfg.types) * (b / data_ways) * s * cfg.d_model * 2
            * (model_ways - 1) / model_ways
        )
        coll = fsdp + tp_ar
        notes["fwd_flops"] = fwd
        notes["model_flops_6nd"] = model_flops_6nd(cfg, b, s)
    elif shape.kind == "prefill":
        flops = forward_flops(cfg, b, s, "prefill")
        t_loc = b * s / data_ways
        cache = _cache_bytes_global(cfg, b, s) / num_devices
        hbm = 2 * p_model_shard_bf16 / max(data_ways, 1) + cache + (
            12 * len(cfg.types) * t_loc * cfg.d_model * 2
        )
        fsdp = p_model_shard_bf16 * (data_ways - 1) / data_ways
        tp_ar = (
            2 * len(cfg.types) * (b / data_ways) * s * cfg.d_model * 2
            * (model_ways - 1) / model_ways
        )
        coll = fsdp + tp_ar
        notes["model_flops_6nd"] = model_flops_6nd(cfg, b, s) / 3.0  # fwd-only
    else:  # decode: one token per sequence, full cache read
        flops = forward_flops(cfg, b, 1, "decode", s_ctx=s)
        cache_loc = _cache_bytes_global(cfg, b, s) / num_devices
        hbm = 2 * p_total / num_devices * 2 + cache_loc  # weights bf16 + cache read
        # TP all-reduce of (b_loc, 1, d) per block, ×2
        b_loc = max(b / data_ways, 1)
        tp_ar = (
            2 * len(cfg.types) * b_loc * cfg.d_model * 2
            * (model_ways - 1) / model_ways
        )
        coll = tp_ar
        notes["cache_bytes_per_dev"] = cache_loc
        notes["model_flops_6nd"] = model_flops_6nd(cfg, b, 1) / 3.0  # fwd-only
    return StepCost(float(flops), float(hbm), float(coll), notes)


# hardware constants: one NVIDIA H100 SXM (data sheet, dense rates without
# sparsity, at its 700 W limit). PEAK_FLOPS_BY_TYPE holds the highest dense
# rate for each input type (f32 outside the tensor cores; f64 and bf16 on
# them); it is the one table of the card's peaks, which chip_smoke.py reads
# for its kernel bounds too. The consensus update runs its f32 products on
# the tensor cores as three TF32 products (3xTF32, 495 TFLOP/s each), so its
# f32 operations count at a third of the TF32 rate. The serving path
# computes in f32 outside the tensor cores, hence PEAK_FLOPS_F32.
PEAK_FLOPS_BY_TYPE = {"float32": 67e12, "float64": 67e12, "bfloat16": 989e12,
                      "float32_3xtf32": 495e12 / 3}
PEAK_FLOPS = PEAK_FLOPS_BY_TYPE["bfloat16"]  # tensor cores
PEAK_FLOPS_F32 = PEAK_FLOPS_BY_TYPE["float32"]  # CUDA cores
HBM_BW = 3.35e12
HBM_BYTES = 80e9  # 80 GB of HBM
LINK_BW = 450e9  # NVLink 4: 900 GB/s per card both ways, one direction


def roofline_terms(cost: StepCost, num_devices: int) -> dict:
    compute_s = cost.flops / (num_devices * PEAK_FLOPS)
    memory_s = cost.hbm_bytes / HBM_BW  # hbm_bytes is already per-device
    coll_s = cost.coll_bytes / LINK_BW  # per-device link traffic
    dominant = max(
        ("compute", compute_s), ("memory", memory_s), ("collective", coll_s),
        key=lambda kv: kv[1],
    )[0]
    total = max(compute_s, memory_s, coll_s)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "dominant": dominant,
        "roofline_fraction": compute_s / total if total > 0 else 0.0,
    }
