"""llama-3.2-vision-90b [vlm]: 100 layers, gated cross-attn to image patch
embeddings every 5th layer (stub vision frontend provides 1600 patch
embeddings via input_specs). [hf:meta-llama/Llama-3.2-Vision]"""
from repro_torch.configs.base import ModelConfig, register


@register("llama-3.2-vision-90b")
def config() -> ModelConfig:
    period = ("dense",) * 4 + ("cross",)
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        num_layers=100,
        layer_types=period * 20,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        vision_seq=1600,
        rope_theta=500000.0,
    )
