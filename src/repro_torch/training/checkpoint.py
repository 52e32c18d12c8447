"""Training checkpoints in the JAX package's format
(``repro.training.checkpoint``), so a directory one package writes, the
other restores.

Layout: ``<dir>/step_<N>/manifest.json`` + ``shards_p0.npz`` (one process).
The npz holds one array per leaf, keyed by its path in the tree joined by
``/`` (``params/main/slot0_dense/attn/w_q``, ``opt/mu/...``, ``opt/step``);
the manifest records each leaf's logical shape and dtype. Writes go to
``.tmp_step_<N>`` and are published by an atomic rename; ``latest_step``
sees only complete checkpoints (manifest present), so a crash mid-write
never corrupts a restart. Retention keeps the last ``keep`` steps.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.device import resolve_device


def flatten(tree, prefix=""):
    """{path: leaf} of nested dicts, the keys joined by ``/``, in the order
    ``jax.tree`` flattens a dict (sorted keys); the leaves as they are."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for key in sorted(tree):
        out.update(flatten(tree[key], f"{prefix}/{key}" if prefix else str(key)))
    return out


def unflatten(flat: dict) -> dict:
    """The nested dicts of ``flatten``'s {path: leaf}."""
    tree: dict = {}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[name] = leaf
    return tree


def _array(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree, keep: int = 3) -> str:
    """Write ``tree`` (nested dicts of tensors or arrays) as step ``step``."""
    arrays = {k: _array(v) for k, v in flatten(tree).items()}
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "shards_p0.npz"), **arrays)
    manifest = {
        "step": step,
        "format": 1,
        "num_processes": 1,
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)} for k, v in arrays.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int):
    for s in sorted(all_steps(ckpt_dir))[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(name.split("_")[1]) for name in os.listdir(ckpt_dir)
        if name.startswith("step_") and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json"))
    )


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like_tree, device=None, shardings=None):
    """The checkpoint in the structure of ``like_tree`` (nested dicts whose
    leaves have the expected shapes), as tensors on ``device`` (the card
    unless the caller says). ``shardings`` (a matching tree of
    ``distributed.sharding.NamedSharding``, e.g. from ``named_shardings``)
    re-lays each leaf onto any mesh instead, as a DTensor placed by
    ``distribute_tensor`` (each rank keeps its block): the elastic restore
    after the worker count changes."""
    if shardings is not None:
        from torch.distributed.tensor import distribute_tensor

        placed = flatten(shardings)
    else:
        device = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step}")
    with np.load(os.path.join(path, "shards_p0.npz")) as data:
        out = {}
        for key, like in flatten(like_tree).items():
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[key]
            want = tuple(like.shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != expected {want}")
            if shardings is None:
                out[key] = torch.from_numpy(arr).to(device)
            else:
                sh = placed[key]
                out[key] = distribute_tensor(torch.from_numpy(arr), sh.mesh, sh.placements)
    return unflatten(out)
