"""The model stack, ported from the JAX package's ``repro.models``:
parameter declarations for every block type, the forward with its training
loss (``loss_fn``, the chunked cross-entropy of ``losses``, flash
attention's backward), prefill and KV-cache decode, the weight converter
both ways and the analytic cost model."""
from repro_torch.models import blocks, costs, layers, losses, moe, ssm, transformer, xlstm
from repro_torch.models.convert import load_reference, params_from_reference, params_to_reference
from repro_torch.models.transformer import (
    Transformer,
    cache_shapes,
    cast_for_compute,
    count_params,
    decode_step,
    forward_hidden,
    init_cache,
    init_params,
    logits_from_hidden,
    loss_fn,
    param_specs,
    prefill,
)
