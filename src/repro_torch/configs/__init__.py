"""Architecture configs — one module per assigned arch (``--arch <id>``)."""
import dataclasses

from repro_torch.configs.base import ModelConfig, get_config, list_archs, register
from repro_torch.configs.shapes import SHAPES, ShapeConfig, applicable

# populate the registry
from repro_torch.configs import (  # noqa: F401
    zamba2_7b,
    xlstm_1_3b,
    deepseek_moe_16b,
    deepseek_v2_236b,
    gemma_7b,
    granite_3_8b,
    qwen1_5_32b,
    granite_3_2b,
    llama_3_2_vision_90b,
    whisper_small,
)

ARCHS = list_archs()


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Shrink any arch config to CPU-smoke scale, preserving the block
    structure: one pattern period (+ tail block if any), tiny widths, few
    experts, small vocab."""
    from repro_torch.models.transformer import factor_pattern

    pat = factor_pattern(cfg.types)
    types = pat.period + ((pat.tail[0],) if pat.tail else ())
    d_model = 64
    heads = 4
    overrides = dict(
        num_layers=len(types),
        layer_types=types,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=2 if cfg.num_kv_heads < cfg.num_heads else heads,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=128,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=16 if cfg.encoder_layers else cfg.encoder_seq,
        vision_seq=8 if cfg.vision_seq else 0,
        moe_seq_chunk=64,
        xent_chunk=16,
        attn_chunk_q=0,
    )
    if cfg.num_experts:
        overrides.update(num_experts=8, moe_top_k=2, moe_d_ff=32)
    if cfg.kv_lora_rank:
        overrides.update(
            kv_lora_rank=16, q_lora_rank=24, qk_rope_dim=8, qk_nope_dim=16,
            v_head_dim=16,
        )
    if cfg.ssm_state:
        overrides.update(ssm_state=16, ssm_head_dim=8)
    return dataclasses.replace(cfg, **overrides)
