"""The reference's parameters in the port's model.

``params_from_reference(cfg, tree)`` takes the JAX package's parameter
pytree as nested dicts of numpy arrays (``jax.tree.map(np.asarray,
params)``) and returns the port's ``Transformer`` with those weights. The
reference stacks each period slot's layers along a leading axis
(``main/slot{i}_{type}``, ``tail/tail_{type}``); layer ``r·len(period) + i``
is entry ``r`` of slot ``i``; encoder block ``i`` of an encoder–decoder
model is entry ``i`` of ``encoder/blocks``. Every leaf must be used,
exactly once per entry, and every parameter of the port must be filled.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import SHARED_TYPES, Transformer


def _flatten(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    out = {}
    for key, value in tree.items():
        out.update(_flatten(value, f"{prefix}/{key}" if prefix else key))
    return out


def params_from_reference(cfg, tree, device=None, dtype=torch.float32) -> Transformer:
    """The port's model holding the reference's weights, on ``device`` (the
    card unless the caller says)."""
    device = resolve_device(device)
    leaves = _flatten(tree)
    model = Transformer(cfg, device, dtype)
    used: dict[str, set] = {}
    filled: set[int] = set()

    def load(param, path, index=None):
        """Copy leaf ``path`` (entry ``index`` of a stacked leaf) into ``param``."""
        if path not in leaves:
            raise KeyError(f"params_from_reference: the reference tree has no leaf {path}")
        array = leaves[path]
        if index is not None:
            if index >= array.shape[0]:
                raise ValueError(f"params_from_reference: {path} stacks {array.shape[0]} "
                                 f"layers, the port needs {index + 1}")
            array = array[index]
        if tuple(array.shape) != tuple(param.shape):
            raise ValueError(f"params_from_reference: {path} is {array.shape}, "
                             f"the port's parameter is {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.array(array, copy=True)).to(dtype))
        used.setdefault(path, set()).add(index)
        filled.add(id(param))

    for name in model.specs:
        load(getattr(model, name), name)
    for name, param in model.final_norm.named_parameters():
        load(param, f"final_norm/{name}")
    for bt, block, (group, slot, rep) in zip(cfg.types, model.layers, model.slots):
        if bt in SHARED_TYPES:
            prefix, index = f"shared/{bt}", None
        elif group == "main":
            prefix, index = f"main/slot{slot}_{bt}", rep
        else:
            prefix, index = f"tail/tail_{bt}", rep
        for name, param in block.named_parameters():
            load(param, f"{prefix}/{name.replace('.', '/')}", index)
    if cfg.is_encdec:
        for i, block in enumerate(model.encoder.blocks):
            for name, param in block.named_parameters():
                load(param, f"encoder/blocks/{name.replace('.', '/')}", i)
        for name, param in model.encoder.final_norm.named_parameters():
            load(param, f"encoder/final_norm/{name}")
    unfilled = [name for name, param in model.named_parameters() if id(param) not in filled]
    if unfilled:
        raise ValueError(f"params_from_reference: the port's parameters left empty: {unfilled}")
    left = sorted(set(leaves) - set(used))
    if left:
        raise ValueError(f"params_from_reference: reference leaves left over: {left}")
    for path, indices in used.items():
        stacked = None not in indices
        if stacked and len(indices) != leaves[path].shape[0]:
            raise ValueError(f"params_from_reference: {path} has {leaves[path].shape[0]} "
                             f"layers, the port has {len(indices)}")
    return model
