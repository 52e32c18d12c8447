"""whisper-small [audio]: enc-dec, 12+12 layers, LayerNorm + GELU, sinusoidal
positions; conv frontend is a STUB (input_specs provides 1500 precomputed
frame embeddings). [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig, register


@register("whisper-small")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        num_layers=12,
        layer_types=("encdec_dec",) * 12,
        encoder_layers=12,
        encoder_seq=1500,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        d_ff=3072,
        vocab_size=51865,
        norm="layernorm",
        activation="gelu",
        pos_embed="absolute",
        tie_embeddings=True,
    )
