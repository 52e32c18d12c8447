"""AdamW, learning-rate schedules and gradient clipping, ported from the
JAX package's ``repro.training.optimizer``.

The update follows the reference's order of operations (clip by the global
norm, bias-corrected μ and ν, decoupled weight decay on every leaf,
scalars in f32), not ``torch.optim.AdamW``'s, whose rounding differs. It
runs leaf by leaf in place, so its temporaries stay the size of one leaf.
Parameters, gradients and moments are {name: tensor} mappings (a module's
``named_parameters``).
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"  # cosine | linear | constant


def named(params) -> dict:
    """{name: tensor} of a module's parameters, or of a mapping as given."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), a 0-d f32 tensor
    on the step's device: linear warm-up, then the schedule's decay."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1.0 - cfg.min_lr_ratio) * frac
    else:
        decay = 1.0
    return cfg.learning_rate * warm * decay


def init_opt_state(params) -> dict:
    """{"mu", "nu": f32 zeros per parameter, "step": 0-d int32 0}."""
    params = named(params)
    device = next(iter(params.values())).device if params else None
    zeros = {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for name, p in params.items()}
    return {"mu": zeros, "nu": {name: torch.zeros_like(z) for name, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every entry's square, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tensors))


@torch.no_grad()
def adamw_update(cfg: OptConfig, params, grads: dict, state: dict):
    """One AdamW step. Returns (params, new_state, metrics {"grad_norm",
    "lr"}). The parameters and the state's moments are updated in place
    (the returned ones are the same tensors); ``grads`` are read only."""
    params = named(params)
    step = state["step"] + 1
    gnorm = global_norm(grads[name] for name in params)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    for name, p in params.items():
        mu, nu = state["mu"][name], state["nu"][name]
        g = grads[name].float() * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        update = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        update += cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * update)
    new_state = {"mu": state["mu"], "nu": state["nu"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
