"""Logical-axis sharding rules and their DTensor placements, ported from the
JAX package's ``repro.distributed.sharding`` (MaxText-style).

Every parameter is declared once as a ``models.spec.ParamSpec`` (shape and
logical axis names); the same declaration yields the initialized tensor
(``models.spec.draw``), the ``meta`` stand-in for dry runs
(``shape_structs``) and the spec (``logical_to_spec``).

Rules (production mesh ``(pod, data, model)``):
  * ``batch``      → (pod, data)   — data parallelism
  * ``embed``      → data          — FSDP-style weight shard of d_model dims
  * ``vocab/ff/heads_flat/experts/inner`` → model — tensor/expert parallelism
  * ``layers``     → None          — the stacked depth dim stays unsharded
  * ``seq``        → None; ``seq_kv`` (cache positions) → (pod, data, model).

Axes that do not divide the mesh axis size are dropped (replicated), and a
mesh axis is used at most once per spec. The rules read only the mesh's
axis sizes, so they take a ``{name: size}`` mapping (``mesh_sizes`` gives it
for a ``DeviceMesh``). A spec is a tuple with one entry per tensor dim:
``None``, an axis name, or a tuple of names — the entries of the reference's
``PartitionSpec``. ``spec_placements`` turns it into the DTensor placements
on a mesh: ``Shard(d)`` on every mesh dim that names tensor dim ``d``,
``Replicate()`` on the rest.

The reference's ``maybe_shard_activations``, ``constrain`` and the
``REPRO_ACT_SEQ`` variable behind them have no counterpart: they steer XLA's
SPMD partitioner while a step is lowered under a mesh and return their input
unchanged everywhere else; the port's steps run unsharded.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.distributed.tensor import Replicate, Shard


SHARDING_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "embed": ("data",),
    "vocab": ("model",),
    "ff": ("model",),
    "heads_flat": ("model",),
    "kv_flat": ("model",),
    "experts": ("model",),
    "inner": ("model",),
    "state": (),
    "seq": (),
    "seq_kv": ("pod", "data", "model"),
    "layers": (),
    "conv": (),
}


def mesh_sizes(device_mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, in its dim order: what the rules
    read (the reference reads ``mesh.shape``)."""
    return dict(zip(device_mesh.mesh_dim_names, device_mesh.shape))


def _mesh_axes_for(logical: str | None, sizes: dict[str, int], dim: int,
                   rules: dict[str, tuple[str, ...]]) -> tuple[str, ...]:
    if logical is None:
        return ()
    names = tuple(a for a in rules.get(logical, ()) if a in sizes)
    # drop trailing axes until divisible (replicate what doesn't fit)
    while names and dim % math.prod(sizes[a] for a in names):
        names = names[:-1]
    return names


def logical_to_spec(
    axes: tuple[str | None, ...],
    shape: tuple[int, ...],
    sizes: dict[str, int],
    rules: dict[str, tuple[str, ...]] | None = None,
) -> tuple:
    """The spec of a tensor of ``shape`` with logical ``axes`` on a mesh of
    axis ``sizes``: one entry per dim (``None``, a name, or a tuple of
    names)."""
    rules = rules or SHARDING_RULES
    used: set[str] = set()
    parts = []
    for dim, logical in zip(shape, axes):
        names = tuple(
            a for a in _mesh_axes_for(logical, sizes, dim, rules) if a not in used
        )
        used.update(names)
        parts.append(None if not names else names[0] if len(names) == 1 else names)
    return tuple(parts)


def tree_map(fn, tree):
    """``fn`` on every leaf of nested dicts; a ``None`` subtree stays ``None``
    (an empty subtree, as ``jax.tree.map`` treats it)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def tree_pspecs(spec_tree: Any, sizes: dict[str, int], rules=None) -> Any:
    """ParamSpec tree → spec tree."""
    return tree_map(lambda s: logical_to_spec(s.axes, s.shape, sizes, rules), spec_tree)


def shape_structs(spec_tree: Any, dtype=torch.float32) -> Any:
    """ParamSpec tree → ``meta`` tensor tree (dry-run stand-ins)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype, device="meta"), spec_tree)


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_placements(spec: tuple, axis_names: tuple[str, ...]) -> tuple:
    """DTensor placements of ``spec`` on a mesh whose dims are named
    ``axis_names``: ``Shard(d)`` on each mesh dim that ``spec`` names for
    tensor dim ``d``, ``Replicate()`` on the others. A DTensor shards a dim
    over several mesh dims in mesh order (the first named major), as a
    ``PartitionSpec`` does when its entry lists them in that order; an entry
    in another order raises."""
    axis_names = tuple(axis_names)
    where: dict[str, int] = {}
    for d, entry in enumerate(spec):
        names = _names(entry)
        missing = [a for a in names if a not in axis_names]
        if missing:
            raise ValueError(f"spec {spec} names {missing}, not axes of the mesh {axis_names}")
        order = [axis_names.index(a) for a in names]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: entry {entry} lists mesh axes out of the "
                             f"mesh's order {axis_names}")
        where.update((a, d) for a in names)
    return tuple(Shard(where[a]) if a in where else Replicate() for a in axis_names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout on a mesh: the counterpart of
    ``jax.sharding.NamedSharding``, placed with
    ``torch.distributed.tensor.distribute_tensor(t, mesh, placements)``."""

    mesh: Any  # torch.distributed.device_mesh.DeviceMesh
    placements: tuple


def named_shardings(spec_tree: Any, device_mesh, rules=None) -> Any:
    """ParamSpec tree → tree of ``NamedSharding`` on ``device_mesh``."""
    sizes = mesh_sizes(device_mesh)
    names = tuple(sizes)
    return tree_map(
        lambda s: NamedSharding(device_mesh, spec_placements(
            logical_to_spec(s.axes, s.shape, sizes, rules), names)),
        spec_tree,
    )

