"""The reference's parameters in the port's model, and back.

``params_from_reference(cfg, tree)`` takes the JAX package's parameter
pytree as nested dicts of numpy arrays (``jax.tree.map(np.asarray,
params)``) and returns the port's ``Transformer`` with those weights;
``params_to_reference(model)`` is its inverse. The reference stacks each
period slot's layers along a leading axis (``main/slot{i}_{type}``,
``tail/tail_{type}``); layer ``r·len(period) + i`` is entry ``r`` of slot
``i``; a weight-shared block is one unstacked ``shared/{type}`` tree;
encoder block ``i`` of an encoder–decoder model is entry ``i`` of
``encoder/blocks``. Every leaf must be used, exactly once per entry, and
every parameter of the port must be filled.

The same layout carries any one-tensor-per-parameter state across:
gradients (``p.grad``), the optimizer's moments and the compression
residuals, keyed by the model's parameter names (``load_reference`` and
``params_to_reference(model, values)``). Training checkpoints name their
leaves by it, so a directory one package writes, the other restores.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import SHARED_TYPES, Transformer
from repro_torch.training.checkpoint import flatten, unflatten


def _entries(model):
    """(reference path, stack index or None, parameter name) of every entry
    of the reference's tree, in the model's layer order."""
    cfg = model.cfg
    names = {id(p): name for name, p in model.named_parameters()}

    def under(module, prefix, index):
        for name, param in module.named_parameters():
            yield f"{prefix}/{name.replace('.', '/')}", index, names[id(param)]

    for name in model.specs:
        yield name, None, name
    yield from under(model.final_norm, "final_norm", None)
    shared_seen = set()
    for bt, block, (group, slot, rep) in zip(cfg.types, model.layers, model.slots):
        if bt in SHARED_TYPES:
            if bt not in shared_seen:
                shared_seen.add(bt)
                yield from under(block, f"shared/{bt}", None)
        elif group == "main":
            yield from under(block, f"main/slot{slot}_{bt}", rep)
        else:
            yield from under(block, f"tail/tail_{bt}", rep)
    if cfg.is_encdec:
        for i, block in enumerate(model.encoder.blocks):
            yield from under(block, "encoder/blocks", i)
        yield from under(model.encoder.final_norm, "encoder/final_norm", None)


def load_reference(model, tree, targets: dict | None = None) -> None:
    """Copy a reference-layout tree (numpy arrays, or tensors on any device)
    into ``targets`` ({parameter name: tensor}, the model's own parameters
    by default), checking that every leaf is used once per entry and every
    target is filled."""
    leaves = {path: leaf if torch.is_tensor(leaf) else np.asarray(leaf)
              for path, leaf in flatten(tree).items()}
    if targets is None:
        targets = dict(model.named_parameters())
    used: dict[str, set] = {}
    filled: set[str] = set()
    for path, index, name in _entries(model):
        if path not in leaves:
            raise KeyError(f"params_from_reference: the reference tree has no leaf {path}")
        array = leaves[path]
        if index is not None:
            if index >= array.shape[0]:
                raise ValueError(f"params_from_reference: {path} stacks {array.shape[0]} "
                                 f"layers, the port needs {index + 1}")
            array = array[index]
        target = targets[name]
        if tuple(array.shape) != tuple(target.shape):
            raise ValueError(f"params_from_reference: {path} is {array.shape}, "
                             f"the port's parameter is {tuple(target.shape)}")
        if not torch.is_tensor(array):
            array = torch.from_numpy(np.array(array, copy=True))
        with torch.no_grad():
            target.copy_(array.to(target.dtype))
        used.setdefault(path, set()).add(index)
        filled.add(name)
    unfilled = sorted(set(targets) - filled)
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


def params_from_reference(cfg, tree, device=None, dtype=torch.float32) -> Transformer:
    """The port's model holding the reference's weights, on ``device`` (the
    card unless the caller says)."""
    model = Transformer(cfg, resolve_device(device), dtype)
    load_reference(model, tree)
    return model


def params_to_reference(model, values: dict | None = None) -> dict:
    """The reference's tree (nested dicts of numpy arrays, stacked as the
    reference stacks them) of the model's parameters, or of ``values``
    ({parameter name: tensor}, e.g. ``{n: p.grad for n, p in
    model.named_parameters()}``; a None entry is zeros, as ``jax.grad``
    gives for an unused leaf)."""
    params = dict(model.named_parameters())
    entries: dict[str, dict] = {}
    for path, index, name in _entries(model):
        tensor = params[name] if values is None else values[name]
        if tensor is None:
            tensor = torch.zeros_like(params[name])
        entries.setdefault(path, {})[index] = tensor.detach().cpu().numpy()
    flat = {path: got[None] if None in got else np.stack([got[i] for i in range(len(got))])
            for path, got in entries.items()}
    return unflatten(flat)


def reference_like(model) -> dict:
    """``params_to_reference(model)``'s tree with shape-only (``meta``)
    tensors of the parameters' dtypes for leaves: a like-tree for
    ``checkpoint.restore`` that copies nothing off the model's device, and
    the reference-layout arguments of a dry run."""
    params = dict(model.named_parameters())
    shapes: dict[str, tuple] = {}
    stacked: dict[str, int] = {}
    for path, index, name in _entries(model):
        shapes[path] = (tuple(params[name].shape), params[name].dtype)
        stacked[path] = stacked.get(path, 0) + (index is not None)
    return unflatten({path: torch.empty(((stacked[path],) if stacked[path] else ()) + shape,
                                        dtype=dtype, device="meta")
                      for path, (shape, dtype) in shapes.items()})
