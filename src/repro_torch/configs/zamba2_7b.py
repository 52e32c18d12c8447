"""zamba2-7b [hybrid]: Mamba2 backbone + weight-shared attention blocks
applied every 6th layer (81 = 13 periods of [5 mamba2, shared attn] + 3 tail
mamba2). [arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig, register


@register("zamba2-7b")
def config() -> ModelConfig:
    period = ("mamba2",) * 5 + ("zamba_attn",)
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        num_layers=81,
        layer_types=period * 13 + ("mamba2",) * 3,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        d_ff=14336,
        vocab_size=32000,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
    )
