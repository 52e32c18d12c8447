"""Parameter declarations: the port's counterpart of the JAX package's
``ParamSpec`` and ``init_from_specs`` (``repro.distributed.sharding``).
Initialization draws each spec with ``draw`` through
``SpecModule.reset_parameters``, into the module that holds the parameter.

Every parameter is declared once as a ``ParamSpec`` (shape, logical axis
names, init rule). A spec tree is nested dicts of them, keyed as the
reference's parameter pytree is, so ``count_params`` walks the same paths.
The logical axes name the reference's sharding rules, which
``distributed.sharding`` maps to specs and DTensor placements on a mesh (the
dry run's and the elastic restore's); on one card they place nothing.

The port draws from an explicit ``torch.Generator``. It cannot reproduce
``jax.random.fold_in`` bits, so parity with the reference's weights goes
through ``models.convert.params_from_reference``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declaration of one parameter tensor."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones
    scale: float | None = None  # std for normal; default 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape/axes rank mismatch: {self}")


def iter_specs(tree, prefix: str = "") -> Iterator[tuple[str, ParamSpec]]:
    """(``a/b/c`` path, spec) for every leaf, keys in sorted order (the order
    ``jax.tree`` flattens a dict in)."""
    if isinstance(tree, ParamSpec):
        yield prefix, tree
        return
    for key in sorted(tree):
        yield from iter_specs(tree[key], f"{prefix}/{key}" if prefix else key)


def draw(spec: ParamSpec, generator: torch.Generator, dtype=torch.float32,
         device=None) -> torch.Tensor:
    """One initialized tensor: zeros, ones, or normal with std ``scale``
    (0.02 by default), drawn from ``generator`` on its device."""
    device = generator.device if device is None else device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    std = 0.02 if spec.scale is None else spec.scale
    return std * torch.randn(spec.shape, generator=generator, dtype=dtype, device=device)


def init_from_specs(spec_tree, generator: torch.Generator, dtype=torch.float32, device=None):
    """ParamSpec tree → a tree of initialized tensors of the same keys, each
    leaf drawn with ``draw`` in ``iter_specs`` order (the reference's
    flattening order; its per-leaf ``fold_in`` keys become successive draws
    from ``generator``)."""
    if isinstance(spec_tree, ParamSpec):
        return draw(spec_tree, generator, dtype, device)
    return {key: init_from_specs(spec_tree[key], generator, dtype, device)
            for key in sorted(spec_tree)}


class SpecModule(torch.nn.Module):
    """A module whose parameters are the leaves of one spec dict; the specs
    stay beside them so ``init_params`` can draw each one. A nested dict
    becomes a child ``SpecModule`` of the same name, so parameter names
    follow the reference's tree (``ffn.w_in`` for ``ffn/w_in``). Built on
    ``device``, the card unless the caller asks for the CPU."""

    def __init__(self, specs: dict, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.specs = {}
        for name, spec in specs.items():
            if isinstance(spec, dict):
                self.add_module(name, SpecModule(spec, device, dtype))
                continue
            if not isinstance(spec, ParamSpec):
                raise TypeError(f"{type(self).__name__}: {name} is not a ParamSpec")
            self.specs[name] = spec
            self.register_parameter(name, torch.nn.Parameter(
                torch.empty(spec.shape, dtype=dtype, device=device), requires_grad=False))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for name in sorted(self.specs):
                getattr(self, name).copy_(draw(self.specs[name], generator,
                                               getattr(self, name).dtype))
