"""deepseek-v2-236b [moe]: MLA (kv_lora=512) + 2 shared / 160 routed top-6
experts of width 1536. [arXiv:2405.04434]"""
from repro_torch.configs.base import ModelConfig, register


@register("deepseek-v2-236b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        num_layers=60,
        layer_types=("mla_moe",) * 60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,
        d_ff=1536,
        vocab_size=102400,
        num_experts=160,
        num_shared_experts=2,
        moe_top_k=6,
        moe_d_ff=1536,
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_rope_dim=64,
        qk_nope_dim=128,
        v_head_dim=128,
    )
