"""The model stack's serving path, ported from the JAX package's
``repro.models``: parameter declarations for every block type, the dense
transformer's forward, prefill and KV-cache decode, the weight converter
and the analytic cost model."""
from repro_torch.models import blocks, costs, layers, moe, ssm, transformer, xlstm
from repro_torch.models.convert import params_from_reference
from repro_torch.models.transformer import (
    Transformer,
    cache_shapes,
    count_params,
    decode_step,
    forward_hidden,
    init_cache,
    init_params,
    logits_from_hidden,
    param_specs,
    prefill,
)
