"""deepseek-moe-16b [moe]: fine-grained MoE, 2 shared + 64 routed top-6
experts of width 1408. [arXiv:2401.06066]"""
from repro_torch.configs.base import ModelConfig, register


@register("deepseek-moe-16b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        num_layers=28,
        layer_types=("moe",) * 28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,
        vocab_size=102400,
        num_experts=64,
        num_shared_experts=2,
        moe_top_k=6,
        moe_d_ff=1408,
    )
