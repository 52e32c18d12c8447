"""Distributed training helpers, ported from the JAX package's
``repro.distributed``: int8 gradient compression with error feedback. The
mesh rules (``sharding.py``) are ROADMAP item 10d."""
from repro_torch.distributed.compression import (
    compress_tree,
    decompress_tree,
    dequantize_int8,
    init_residuals,
    quantize_int8,
)
