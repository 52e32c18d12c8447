"""granite-3-8b [dense]: GQA kv=8. [hf:ibm-granite/granite-3.0]"""
from repro_torch.configs.base import ModelConfig, register


@register("granite-3-8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b",
        family="dense",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=12800,
        vocab_size=49155,
    )
