"""The training loop, ported from the JAX package's
``repro.training.train_loop``: the train step and a fault-tolerant host
loop.

``make_train_step`` builds the step: ``loss_fn`` with autograd, optional
int8 gradient compression with error feedback, then AdamW in place. The
host loop adds periodic checkpoints in the reference's format, automatic
restart from the latest complete one, simulated failures (for tests) and
the loss log. The state is ``{"params": the model (f32 masters that
require gradients), "opt": {"mu", "nu": {name: tensor}, "step"},
["residuals": {name: tensor}]}``; ``state_tree`` lays it out as the
reference's state pytree, which is what checkpoints hold.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import compression
from repro_torch.models import transformer
from repro_torch.models.convert import load_reference, params_to_reference, reference_like
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training import data as data_lib
from repro_torch.training.optimizer import OptConfig, adamw_update, init_opt_state


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    num_steps: int = 100
    ckpt_dir: str = ""
    ckpt_every: int = 50
    log_every: int = 10
    compress_grads: bool = False
    param_dtype: torch.dtype = torch.float32


def make_train_step(cfg, opt_cfg: OptConfig, compress: bool = False):
    """Returns train_step(state, batch) -> (state, metrics {"loss", "nll",
    "aux_loss", "grad_norm", "lr"}: 0-d tensors, read without a host sync).
    The parameters and moments are updated in place; a parameter the loss
    does not reach gets a zero gradient, as ``jax.grad`` gives it."""

    def train_step(state, batch):
        model = state["params"]
        model.zero_grad(set_to_none=True)
        loss, metrics = transformer.loss_fn(model, batch, cfg)
        loss.backward()
        grads = {name: torch.zeros_like(p) if p.grad is None else p.grad
                 for name, p in model.named_parameters()}
        if compress:
            qtree, new_res = compression.compress_tree(grads, state["residuals"])
            grads = compression.decompress_tree(qtree)
            state = dict(state, residuals=new_res)
        _, new_opt, opt_metrics = adamw_update(opt_cfg, model, grads, state["opt"])
        model.zero_grad(set_to_none=True)
        metrics = dict(metrics, loss=loss.detach(), **opt_metrics)
        return dict(state, opt=new_opt), metrics

    return train_step


def init_state(cfg, generator: torch.Generator, tcfg: TrainConfig) -> dict:
    """Weights drawn from ``generator`` (on its device), trainable f32
    masters, zero moments (and zero residuals with compression)."""
    model = transformer.init_params(cfg, generator, dtype=tcfg.param_dtype)
    model.requires_grad_(True)
    state = {"params": model, "opt": init_opt_state(model)}
    if tcfg.compress_grads:
        state["residuals"] = compression.init_residuals(dict(model.named_parameters()))
    return state


def state_tree(state) -> dict:
    """The state as the reference's state pytree of numpy arrays
    (``params/...``, ``opt/mu/...``, ``opt/nu/...``, ``opt/step``,
    ``residuals/...``)."""
    model = state["params"]
    tree = {"params": params_to_reference(model),
            "opt": {"mu": params_to_reference(model, state["opt"]["mu"]),
                    "nu": params_to_reference(model, state["opt"]["nu"]),
                    "step": np.asarray(state["opt"]["step"].cpu(), np.int32)}}
    if "residuals" in state:
        tree["residuals"] = params_to_reference(model, state["residuals"])
    return tree


def state_like(state) -> dict:
    """``state_tree(state)``'s structure and shapes as ``meta`` tensors, for
    ``checkpoint.restore``; nothing is copied off the card."""
    like = reference_like(state["params"])
    tree = {"params": like,
            "opt": {"mu": like, "nu": like,
                    "step": torch.empty((), dtype=state["opt"]["step"].dtype, device="meta")}}
    if "residuals" in state:
        tree["residuals"] = like
    return tree


def load_state(state, tree) -> None:
    """Copy a reference-layout state tree (``state_tree``'s, or one the JAX
    package wrote; on any device) into ``state`` in place, leaf by leaf."""
    model = state["params"]
    load_reference(model, tree["params"])
    load_reference(model, tree["opt"]["mu"], state["opt"]["mu"])
    load_reference(model, tree["opt"]["nu"], state["opt"]["nu"])
    state["opt"]["step"].copy_(torch.as_tensor(tree["opt"]["step"]))
    if "residuals" in state:
        load_reference(model, tree["residuals"], state["residuals"])


def train(cfg, tcfg: TrainConfig, dcfg: data_lib.DataConfig, fail_at_step: int | None = None,
          state=None, device=None):
    """Fault-tolerant host loop on ``device`` (the card unless the caller
    says; a given ``state`` brings its own). Returns (state, history list).

    Resumes from the latest complete checkpoint in ``tcfg.ckpt_dir``.
    ``fail_at_step`` simulates a node failure (raises); callers re-invoke
    ``train`` and it resumes exactly."""
    step_fn = make_train_step(cfg, tcfg.opt, tcfg.compress_grads)
    if state is None:
        device = resolve_device(device)
        state = init_state(cfg, torch.Generator(device=device).manual_seed(0), tcfg)
    device = state["params"].device

    start = 0
    if tcfg.ckpt_dir:
        latest = ckpt_lib.latest_step(tcfg.ckpt_dir)
        if latest is not None:
            # restored on the host and copied leaf by leaf into the state on
            # its device: no second copy of the state on the card
            load_state(state, ckpt_lib.restore(tcfg.ckpt_dir, latest, state_like(state), "cpu"))
            start = latest

    history = []
    t0 = time.perf_counter()
    for step in range(start, tcfg.num_steps):
        if fail_at_step is not None and step == fail_at_step:
            raise RuntimeError(f"simulated node failure at step {step}")
        batch = data_lib.make_batch(dcfg, step, device)
        state, metrics = step_fn(state, batch)
        if (step + 1) % tcfg.log_every == 0 or step + 1 == tcfg.num_steps:
            history.append({
                "step": step + 1,
                "loss": float(metrics["loss"]),
                "grad_norm": float(metrics["grad_norm"]),
                "seconds": time.perf_counter() - t0,
            })
        if tcfg.ckpt_dir and (step + 1) % tcfg.ckpt_every == 0:
            ckpt_lib.save(tcfg.ckpt_dir, step + 1, state_tree(state))
    if tcfg.ckpt_dir:
        ckpt_lib.save(tcfg.ckpt_dir, tcfg.num_steps, state_tree(state))
    return state, history
