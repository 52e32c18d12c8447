"""granite-3-2b [dense]: GQA kv=8, head_dim=64. [hf:ibm-granite/granite-3.0]"""
from repro_torch.configs.base import ModelConfig, register


@register("granite-3-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b",
        family="dense",
        num_layers=40,
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=49155,
    )
