"""Distributed training helpers, ported from the JAX package's
``repro.distributed``: int8 gradient compression with error feedback
(``compression.py``) and the logical-axis mesh rules with their DTensor
placements (``sharding.py``). ``ParamSpec`` and ``init_from_specs`` are
re-exported from ``models/spec.py``, where the port declares its
parameters, as the reference exports them from its sharding module."""
from repro_torch.distributed.compression import (
    compress_tree,
    decompress_tree,
    dequantize_int8,
    init_residuals,
    quantize_int8,
)
from repro_torch.distributed.sharding import (
    SHARDING_RULES,
    logical_to_spec,
    named_shardings,
    shape_structs,
    tree_pspecs,
)
from repro_torch.models.spec import ParamSpec, init_from_specs
