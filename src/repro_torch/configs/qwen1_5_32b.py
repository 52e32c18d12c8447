"""qwen1.5-32b [dense]: QKV bias; 40 heads (flat-dim TP handles the
non-divisible head count). [hf:Qwen/Qwen1.5]"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen1.5-32b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,
        d_ff=27392,
        vocab_size=152064,
        qkv_bias=True,
    )
