"""gemma-7b [dense]: GeGLU, head_dim=256 (q dim 4096 > d_model).
[arXiv:2403.08295]"""
from repro_torch.configs.base import ModelConfig, register


@register("gemma-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=16,
        num_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab_size=256000,
        activation="geglu",
    )
