"""Fine-grained Mixture-of-Experts: the parameter declaration only, copied
from the JAX package's ``repro.models.moe``. The sort-based dispatch that
applies it is ROADMAP Queue 1 item 10b."""
from __future__ import annotations

from repro_torch.models import layers
from repro_torch.models.spec import ParamSpec


def moe_spec(cfg):
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    spec = {
        "router": ParamSpec((d, e), ("embed", None), scale=d**-0.5),
        "w_in": ParamSpec((e, d, f), ("experts", "embed", "ff")),
        "w_gate": ParamSpec((e, d, f), ("experts", "embed", "ff")),
        "w_out": ParamSpec((e, f, d), ("experts", "ff", "embed")),
    }
    if cfg.num_shared_experts:
        fs = cfg.num_shared_experts * cfg.moe_d_ff
        spec["shared"] = layers.mlp_spec(cfg, d_ff=fs)
    return spec
