"""Dry run of every (arch × shape × mesh) cell over a faked process group,
ported from the JAX package's ``repro.launch.dryrun``.

For each cell this builds the step's arguments as ``meta`` tensors
(``build_cell``), gives every leaf its DTensor placements under the mesh
rules (``distributed.sharding``) and places it as a ``meta`` DTensor on a
``DeviceMesh`` of the production shape — ``(16, 16)`` ``("data", "model")``,
256 ranks; ``(2, 16, 16)`` ``("pod", "data", "model")``, 512 ranks, with
``--multi-pod`` — over a process group that this one process fakes. That
shows, without hardware, that the sharding config is coherent (every
argument leaf has a placement, every sharded dim divides, DTensor accepts
the layout), and gives each rank's argument bytes, taken from DTensor's own
local shapes and checked against one H100's 80 GB. Records land in
``artifacts/dryrun_torch/<cell>.json`` (the reference's ``artifacts/dryrun/``
holds XLA's records, which its benchmark reports read).

What the reference's record holds and this one cannot: XLA lowers and
compiles the sharded step, so its record also has the lower and compile
seconds, the output, temporary, alias and code bytes and their per-device
total, the cost analysis and the compiled collective schedule (its
``collective_bytes`` parses HLO text). torch lowers no sharded step; each
record lists those fields under ``no_counterpart``. The step itself is not
run here: a full-size step on ``meta`` takes seconds to minutes (the
chunked attention and the recurrences are Python loops), so the tests run
each step's shapes (full size at ``decode_32k``, ``reduced_config`` at the
long shapes). "status ok" means every argument and placement was built over
the fake mesh and DTensor accepted it.

The fake group is ``torch.testing._internal.distributed.fake_pg`` (its
``FakeStore`` and the ``"fake"`` backend it registers): the only in-process
fake process group torch ships, and a private module. It is imported only
when a mesh is faked, and the group is destroyed at the end of ``main``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                  # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes    # and the 2-pod mesh
"""
from __future__ import annotations

import argparse
import json
import math
import os
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard, distribute_tensor

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.distributed.sharding import (
    logical_to_spec,
    mesh_sizes,
    named_shardings,
    spec_placements,
    tree_map,
    tree_pspecs,
)
from repro_torch.models import transformer
from repro_torch.models.convert import reference_like
from repro_torch.models.costs import HBM_BYTES
from repro_torch.models.spec import SpecModule, draw
from repro_torch.serving.decode import make_serve_step
from repro_torch.training import train_loop
from repro_torch.training.checkpoint import flatten, unflatten
from repro_torch.training.optimizer import OptConfig, init_opt_state

# the reference's production meshes (launch/mesh.make_production_mesh)
MESH_AXES = {False: ("data", "model"), True: ("pod", "data", "model")}
PRODUCTION_MESH = {False: (16, 16), True: (2, 16, 16)}
# what the reference's record holds from XLA's lowering and compile
NO_COUNTERPART = [
    "lower_seconds", "compile_seconds", "memory.output_bytes", "memory.temp_bytes",
    "memory.alias_bytes", "memory.code_bytes", "memory.per_device_total", "cost",
    "collectives_schedule_bytes",
]


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def aux_specs(cfg, batch, mesh):
    """(structs, specs) of the modality stubs (vision patches, encoder
    frames), bf16; (None, None) for a text-only arch."""
    structs, pspecs = {}, {}
    if cfg.vision_seq:
        shp = (batch, cfg.vision_seq, cfg.d_model)
        structs["patches"] = _meta(shp, torch.bfloat16)
        pspecs["patches"] = logical_to_spec(("batch", None, None), shp, mesh)
    if cfg.is_encdec:
        shp = (batch, cfg.encoder_seq, cfg.d_model)
        structs["enc_frames"] = _meta(shp, torch.bfloat16)
        pspecs["enc_frames"] = logical_to_spec(("batch", None, None), shp, mesh)
    return (structs or None), (pspecs or None)


def batch_specs(cfg, shape, mesh):
    """(structs, specs) for the data batch of a train cell: int32 token ids
    and targets, as the reference's, and the modality stubs."""
    b, s = shape.global_batch, shape.seq_len
    bspec = logical_to_spec(("batch", "seq"), (b, s), mesh)
    structs = {"tokens": _meta((b, s), torch.int32), "targets": _meta((b, s), torch.int32)}
    pspecs = {"tokens": bspec, "targets": bspec}
    aux, aux_sp = aux_specs(cfg, b, mesh)
    return {**structs, **(aux or {})}, {**pspecs, **(aux_sp or {})}


def param_pspecs(cfg, mesh):
    return tree_pspecs(transformer.param_specs(cfg), mesh)


def meta_model(cfg, dtype):
    """The cell's parameters: a ``Transformer`` on ``meta``."""
    return transformer.Transformer(cfg, "meta", dtype)


def state_specs(cfg, mesh):
    """Train state (f32 masters that require gradients, AdamW moments, an
    int32 step) and its specs in the reference's layout."""
    model = meta_model(cfg, torch.float32).requires_grad_(True)
    psp = param_pspecs(cfg, mesh)
    return ({"params": model, "opt": init_opt_state(model)},
            {"params": psp, "opt": {"mu": psp, "nu": psp, "step": ()}})


def cache_specs(cfg, batch, max_seq, mesh):
    shapes = transformer.cache_shapes(cfg, batch, max_seq)
    return (tree_map(lambda leaf: _meta(leaf[0], leaf[1]), shapes),
            tree_map(lambda leaf: logical_to_spec(leaf[2], leaf[0], mesh), shapes))


def build_cell(cfg, shape, mesh):
    """(fn, args, placements, donate) of one cell on a mesh of axis sizes
    ``mesh`` ({name: size} in mesh order; ``sharding.mesh_sizes``).

    ``args`` are the step's arguments in the reference's dtypes: ``meta``
    tensors, a ``meta`` ``Transformer`` for the parameters, and for a decode
    cell the position as a host int32 scalar (the port's decode indexes its
    caches with a Python int; the cell decodes at the cache's last
    position). ``placements`` has one entry per argument: a tree of DTensor
    placements over the leaves of ``argument_trees(args)``, keyed by the
    reference's paths (``params/...``, ``opt/mu/...`` as
    ``train_loop.state_tree`` flattens a state). ``donate`` is the
    reference's ``donate_argnums``: the port's steps update those arguments
    in place. ``fn`` is the port's step: ``train_loop.make_train_step`` (f32
    masters, bf16 compute); prefill returning the last-token logits and the
    filled caches, on bf16 weights; ``decode.make_serve_step`` (one token
    against the caches, ``transformer.decode_step``), on bf16 weights."""
    names = tuple(mesh)

    def place(tree):
        return tree_map(lambda spec: spec_placements(spec, names), tree)

    b = shape.global_batch
    if shape.kind == "train":
        st, sp = state_specs(cfg, mesh)
        bt, bp = batch_specs(cfg, shape, mesh)
        step = train_loop.make_train_step(cfg, OptConfig())
        return step, (st, bt), (place(sp), place(bp)), (0,)

    params = meta_model(cfg, torch.bfloat16)
    psp = place(param_pspecs(cfg, mesh))
    ax, axsp = aux_specs(cfg, b, mesh)
    if shape.kind == "prefill":
        def prefill_step(params, tokens, aux):
            logits, caches = transformer.prefill(params, tokens, cfg, shape.seq_len, aux=aux)
            return logits[:, -1, :], caches  # last-token logits + filled cache

        tok = _meta((b, shape.seq_len), torch.int32)
        tsp = logical_to_spec(("batch", "seq"), tok.shape, mesh)
        return prefill_step, (params, tok, ax), (psp, place(tsp), place(axsp)), ()

    serve = make_serve_step(cfg)

    def serve_step(params, caches, tokens, pos, aux):
        return serve(params, caches, tokens, int(pos), aux=aux)

    ct, csp = cache_specs(cfg, b, shape.seq_len, mesh)
    tok = _meta((b, 1), torch.int32)
    tsp = logical_to_spec(("batch", None), tok.shape, mesh)
    pos = torch.tensor(shape.seq_len - 1, dtype=torch.int32)
    return (serve_step, (params, ct, tok, pos, ax),
            (psp, place(csp), place(tsp), place(()), place(axsp)), (1,))


def argument_trees(args) -> tuple:
    """Each argument in the reference's layout: a ``Transformer`` as
    ``convert.reference_like`` stacks it, a train state as
    ``train_loop.state_like`` lays it out (``meta`` leaves of the same
    dtypes), anything else as it is."""
    def tree(arg):
        if isinstance(arg, transformer.Transformer):
            return reference_like(arg)
        if isinstance(arg, dict) and isinstance(arg.get("params"), transformer.Transformer):
            return train_loop.state_like(arg)
        return arg

    return tuple(tree(arg) for arg in args)


def _leaves(tree) -> dict:
    return {} if tree is None else {k: v for k, v in flatten(tree).items() if v is not None}


def placed_leaves(args, placements):
    """(argument index, reference path, leaf, placements) of every leaf of
    ``argument_trees(args)``; raises if a leaf has no placement or a
    placement no leaf."""
    for i, (tree, place) in enumerate(zip(argument_trees(args), placements)):
        leaves, places = _leaves(tree), _leaves(place)
        if leaves.keys() != places.keys():
            raise ValueError(f"argument {i}: leaves without placements "
                             f"{sorted(leaves.keys() - places.keys())}, placements without "
                             f"leaves {sorted(places.keys() - leaves.keys())}")
        for path, leaf in leaves.items():
            yield i, path, leaf, places[path]


def check_divides(shape, placements, mesh_shape) -> None:
    """Raise unless every dim of ``shape`` that ``placements`` shard divides
    over the product of its mesh dims' extents (``mesh_shape``)."""
    ways = [1] * len(shape)
    for extent, p in zip(mesh_shape, placements):
        if isinstance(p, Shard):
            ways[p.dim] *= extent
    for d, (n, w) in enumerate(zip(shape, ways)):
        if n % w:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {w} ranks "
                             f"({placements})")


def distribute_meta(leaf, placements, device_mesh):
    """``leaf``'s stand-in as a ``meta`` DTensor under ``placements`` on
    ``device_mesh``, once ``check_divides`` holds."""
    check_divides(leaf.shape, placements, device_mesh.shape)
    return distribute_tensor(_meta(leaf.shape, leaf.dtype), device_mesh, placements)


def argument_bytes(args, placements, device_mesh) -> int:
    """One rank's argument bytes: the local shapes of every leaf's ``meta``
    DTensor on ``device_mesh``."""
    total = 0
    for _, _, leaf, place in placed_leaves(args, placements):
        local = distribute_meta(leaf, place, device_mesh).to_local()
        total += local.numel() * local.element_size()
    return total


def fake_mesh(dims, axes):
    """A ``DeviceMesh`` of shape ``dims`` named ``axes`` over a fake process
    group of ``prod(dims)`` ranks, of which this process is rank 0. A fake
    group of another size is replaced; a real group raises."""
    if dist.is_initialized() and dist.get_backend() != "fake":
        raise RuntimeError("the dry run fakes its own process group; this process "
                           f"already has a {dist.get_backend()} group")
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    world = math.prod(dims)
    if dist.is_initialized() and dist.get_world_size() != world:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return init_device_mesh("cpu", tuple(dims), mesh_dim_names=tuple(axes))


def materialize(args, placements, device_mesh, generator):
    """A serving cell's arguments allocated on ``generator``'s device, every
    leaf placed on ``device_mesh`` with ``distribute_tensor`` and kept as
    this rank's local block: each parameter drawn from ``generator`` as
    ``transformer.init_params`` draws it and placed under its own spec's
    ``named_shardings`` (the reference's stacked leaf less its unsharded
    ``layers`` dim), every other ``meta`` leaf zeros, host leaves (the
    decode position) copied. Returns the arguments in ``args``' structure."""
    dev = generator.device

    def local(tensor, place):
        return distribute_tensor(tensor, device_mesh, place).to_local()

    out = []
    for arg, place in zip(args, placements):
        if isinstance(arg, transformer.Transformer):
            for module in arg.modules():
                if not isinstance(module, SpecModule):
                    continue
                for name, sh in named_shardings(module.specs, device_mesh).items():
                    t = draw(module.specs[name], generator, getattr(module, name).dtype, dev)
                    setattr(module, name, torch.nn.Parameter(local(t, sh.placements),
                                                             requires_grad=False))
                    del t
            out.append(arg)
            continue
        if isinstance(arg, dict) and "params" in arg:
            raise TypeError("materialize places a serving cell's arguments, not a train state")

        def leaf(t, p):
            return local(torch.zeros(t.shape, dtype=t.dtype, device=dev) if t.is_meta
                         else t.to(dev), p)

        if arg is None or torch.is_tensor(arg):
            out.append(None if arg is None else leaf(arg, place))
            continue
        places = _leaves(place)
        out.append(unflatten({k: None if v is None else leaf(v, places[k])
                              for k, v in flatten(arg).items()}))
    return tuple(out)


def run_cell(arch: str, shape_name: str, multi_pod: bool, artifacts_dir: str,
             mesh_override: tuple[int, int] | None = None):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    runs, reason = applicable(cfg, shape)
    suffix = "pod2" if multi_pod else "pod1"
    if mesh_override:
        suffix += f"_d{mesh_override[0]}m{mesh_override[1]}"
    cell = f"{arch}__{shape_name}__{suffix}"
    if not runs:
        rec = {"cell": cell, "status": "skip", "reason": reason}
        _save(artifacts_dir, cell, rec)
        return rec

    dims = PRODUCTION_MESH[multi_pod]
    if mesh_override:
        dims = (2, *mesh_override) if multi_pod else tuple(mesh_override)
    device_mesh = fake_mesh(dims, MESH_AXES[multi_pod])
    _, args, placements, _ = build_cell(cfg, shape, mesh_sizes(device_mesh))
    arg_bytes = argument_bytes(args, placements, device_mesh)
    rec = {
        "cell": cell,
        "status": "ok",
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "multi_pod": multi_pod,
        "num_devices": int(device_mesh.size()),
        "memory": {
            "argument_bytes": int(arg_bytes),
            # per-rank arguments against one H100's HBM; temporaries not counted
            "arguments_fit_80gb": bool(arg_bytes < HBM_BYTES),
        },
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "no_counterpart": NO_COUNTERPART,
    }
    _save(artifacts_dir, cell, rec)
    return rec


def _save(artifacts_dir, cell, rec):
    os.makedirs(artifacts_dir, exist_ok=True)
    with open(os.path.join(artifacts_dir, f"{cell}.json"), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCHS + ["all"])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + ["all"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--artifacts", default="artifacts/dryrun_torch")
    ap.add_argument("--data", type=int, default=None,
                    help="override data-axis size (with --model; 256 ranks/pod)")
    ap.add_argument("--model", type=int, default=None)
    args = ap.parse_args(argv)
    mesh_override = (args.data, args.model) if args.data and args.model else None

    archs = ARCHS if args.arch in (None, "all") else [args.arch]
    shapes = list(SHAPES) if args.shape in (None, "all") else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    try:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    try:
                        rec = run_cell(arch, shape, mp, args.artifacts,
                                       mesh_override=mesh_override)
                    except Exception as e:  # a failure here is a sharding bug
                        rec = {
                            "cell": f"{arch}__{shape}__{'pod2' if mp else 'pod1'}",
                            "status": "fail",
                            "error": f"{type(e).__name__}: {e}",
                        }
                        _save(args.artifacts, rec["cell"], rec)
                        traceback.print_exc()
                        failures.append(rec["cell"])
                    status = rec["status"]
                    extra = ""
                    if status == "ok":
                        m = rec["memory"]
                        extra = (f" args/rank={m['argument_bytes'] / 2**30:.2f}GiB"
                                 f" fits_80gb={m['arguments_fit_80gb']}")
                    elif status == "skip":
                        extra = f" ({rec['reason']})"
                    print(f"[{status:4s}] {rec['cell']}{extra}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {failures}")
    print("dry-run complete: every cell's arguments placed over the fake mesh")


if __name__ == "__main__":
    main()
