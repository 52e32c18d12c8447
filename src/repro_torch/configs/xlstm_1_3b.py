"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks, ratio 7:1 (48 = 6 periods of
[7 mLSTM, 1 sLSTM]). d_ff=0: blocks carry their own projections.
[arXiv:2405.04517]"""
from repro_torch.configs.base import ModelConfig, register


@register("xlstm-1.3b")
def config() -> ModelConfig:
    period = ("mlstm",) * 7 + ("slstm",)
    return ModelConfig(
        name="xlstm-1.3b",
        family="ssm",
        num_layers=48,
        layer_types=period * 6,
        d_model=2048,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        mlstm_proj_factor=2.0,
        slstm_proj_factor=4.0 / 3.0,
    )
