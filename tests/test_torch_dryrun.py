"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's ``repro.launch.dryrun``, on the CPU:

- ``build_cell`` mirrors ``tests/test_dryrun_specs.py::test_build_cell_consistent``
  (4 archs × 3 shapes): at full size, every argument leaf has a placement,
  the arguments are the reference's leaf for leaf (paths, shapes, dtypes),
  each placement is the reference's ``PartitionSpec`` on ``(16, 16)`` and
  every sharded dim divides; then the step runs on ``meta`` and its output
  shapes equal ``jax.eval_shape`` of the reference's step for the same
  config;
- every cell of the sweep (10 archs × 4 shapes × 2 meshes), run by the
  command line over its fake 256/512-rank group in a subprocess: the same
  cells skip, and each rank's argument bytes equal the reference's
  ``build_cell`` on an ``AbstractMesh``, summed as shard-shape bytes,
  exactly;
- ``run_cell`` at ``--data 2 --model 2``: the record's keys and its
  ``no_counterpart`` list;
- ``materialize`` on a one-rank gloo mesh: the bytes it allocates are the
  dry run's, and the decode step runs on them;
- the MoE archs' steps run on ``meta`` (a static-length expert count).
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding

from repro import compat
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.configs.shapes import applicable as japplicable
from repro.launch import dryrun as jdryrun

from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.configs.shapes import SHAPES, ShapeConfig
from repro_torch.distributed.sharding import mesh_sizes, spec_placements
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.training.checkpoint import flatten

SRC = Path(__file__).resolve().parent.parent / "src"
CELL_ARCHS = ["granite-3-2b", "deepseek-v2-236b", "zamba2-7b", "whisper-small"]
MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _sig(x):
    """(shape, dtype name) of a tensor or a ShapeDtypeStruct; integer
    dtypes as "int" (the port's greedy ids are int64, the reference's
    int32)."""
    name = str(x.dtype).removeprefix("torch.")
    return tuple(x.shape), ("int" if "int" in name else name)


def _sigs(tree) -> dict:
    return {k: _sig(v) for k, v in flatten(tree).items() if v is not None}


def _step_config(arch, shape):
    """The configs the step runs at on ``meta``: full size at
    ``decode_32k``; ``reduced_config`` at the long shapes, keeping the
    arch's own MoE dispatch chunk (``reduced_config``'s 64 tokens would
    loop 16384 dispatches over train_4k's 1M tokens)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    if shape == "decode_32k":
        return cfg, jcfg
    return (dataclasses.replace(reduced_config(cfg), moe_seq_chunk=cfg.moe_seq_chunk),
            dataclasses.replace(jreduced_config(jcfg), moe_seq_chunk=jcfg.moe_seq_chunk))


@pytest.mark.parametrize("arch", CELL_ARCHS)
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_build_cell_consistent(arch, shape):
    """At full size on ``(16, 16)`` the arguments and their placements are
    the reference's; the step's output shapes on ``meta`` are the
    reference's ``eval_shape``. The long steps run at ``reduced_config``
    with the same SHAPES: a full-size step on ``meta`` takes 10 s to
    minutes there (the chunked attention and the recurrences are Python
    loops), where a full-size decode step takes about 1 s."""
    sizes = {"data": 16, "model": 16}
    _, args, placements, donate = dryrun.build_cell(get_config(arch), SHAPES[shape], sizes)
    _, jargs, jshardings, jdonate = jdryrun.build_cell(
        jget_config(arch), JSHAPES[shape], AbstractMesh((16, 16), ("data", "model")))
    assert donate == jdonate
    trees = dryrun.argument_trees(args)
    assert len(trees) == len(jargs) == len(placements)
    placed = list(dryrun.placed_leaves(args, placements))
    assert len(placed) == len(jax.tree.leaves(jargs))
    for i, (tree, jtree, jsh) in enumerate(zip(trees, jargs, jshardings)):
        assert _sigs(tree) == _sigs(jtree), f"argument {i}"
        jflat = flatten(jsh) if isinstance(jsh, dict) else {"": jsh}
        for j, path, leaf, place in placed:
            if j == i:
                assert place == spec_placements(tuple(jflat[path].spec), ("data", "model")), path
                dryrun.check_divides(leaf.shape, place, (16, 16))

    cfg, jcfg = _step_config(arch, shape)
    fn, args, _, _ = dryrun.build_cell(cfg, SHAPES[shape], {"data": 1, "model": 1})
    out = fn(*args)
    jfn, jargs, _, _ = jdryrun.build_cell(jcfg, JSHAPES[shape],
                                          compat.make_mesh((1, 1), ("data", "model")))
    jout = jax.eval_shape(jfn, *jargs)
    if shape == "train_4k":
        (state, metrics), (jstate, jmetrics) = out, jout
        model = state["params"]
        for moment in ("mu", "nu"):
            assert ({n: tuple(t.shape) for n, t in state["opt"][moment].items()}
                    == {n: tuple(p.shape) for n, p in model.named_parameters()})
        assert _sigs(dryrun.argument_trees((state,))[0]) == _sigs(jstate)
        assert _sigs(metrics) == _sigs(dict(jmetrics))
    else:
        assert _sig(out[0]) == _sig(jout[0])
        assert _sigs(out[1]) == _sigs(jout[1])


def _reference_bytes(arch, shape, dims, axes=("data", "model")):
    """The reference's per-device argument bytes of a cell: its
    ``build_cell`` on an ``AbstractMesh``, each argument struct at its
    shard shape."""
    _, args, shardings, _ = jdryrun.build_cell(jget_config(arch), JSHAPES[shape],
                                               AbstractMesh(dims, axes))
    structs = jax.tree.leaves(args)
    shards = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(structs) == len(shards)
    return sum(math.prod(s.shard_shape(a.shape)) * a.dtype.itemsize
               for a, s in zip(structs, shards))


def _run_dryrun(args, artifacts):
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--artifacts", str(artifacts)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """``python -m repro_torch.launch.dryrun --both-meshes``: its stdout and
    its records by cell."""
    artifacts = tmp_path_factory.mktemp("dryrun")
    stdout = _run_dryrun(["--both-meshes"], artifacts)
    records = {p.stem: json.loads(p.read_text()) for p in artifacts.glob("*.json")}
    return stdout, records


def test_sweep_prints_every_cell(sweep):
    stdout, records = sweep
    lines = [line for line in stdout.splitlines() if line.startswith("[")]
    assert len(lines) == len(records) == 80
    assert sum(line.startswith("[ok  ]") for line in lines) == 64
    assert sum(line.startswith("[skip]") for line in lines) == 16
    assert "args/rank=" in next(line for line in lines if line.startswith("[ok  ]"))
    assert stdout.rstrip().endswith("every cell's arguments placed over the fake mesh")


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "pod2"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sweep_argument_bytes_match_reference(sweep, arch, shape, multi_pod):
    """Each rank's argument bytes, from DTensor's local shapes over the fake
    256/512-rank group, equal the reference's shard-shape bytes exactly;
    the same cells skip in both packages."""
    rec = sweep[1][f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}"]
    if not japplicable(jget_config(arch), JSHAPES[shape])[0]:
        assert rec["status"] == "skip"
        return
    assert rec["status"] == "ok"
    assert rec["num_devices"] == math.prod(MESHES[multi_pod][0])
    assert rec["memory"]["argument_bytes"] == _reference_bytes(arch, shape, *MESHES[multi_pod])
    assert rec["memory"]["arguments_fit_80gb"] == (rec["memory"]["argument_bytes"] < 80e9)
    assert rec["params"] == jget_config(arch).param_count()
    assert rec["active_params"] == jget_config(arch).active_param_count()


def test_sweep_byte_figures():
    """The two figures the dry run must reproduce, on the reference's side."""
    assert _reference_bytes("deepseek-v2-236b", "decode_32k", (16, 16)) == 3_465_144_356
    assert _reference_bytes("granite-3-2b", "train_4k", (16, 16)) == 121_290_756


def test_run_cell_mesh_override_record(tmp_path):
    """``--data 2 --model 2``: a 4-rank fake group; the record carries the
    reference's computable keys, ``arguments_fit_80gb`` and the fields it
    has no counterpart for."""
    stdout = _run_dryrun(["--arch", "granite-3-2b", "--data", "2", "--model", "2"], tmp_path)
    assert stdout.count("[ok  ]") == 3 and stdout.count("[skip]") == 1
    rec = json.loads((tmp_path / "granite-3-2b__train_4k__pod1_d2m2.json").read_text())
    assert set(rec) == {"cell", "status", "arch", "shape", "kind", "multi_pod", "num_devices",
                        "memory", "params", "active_params", "no_counterpart"}
    assert set(rec["memory"]) == {"argument_bytes", "arguments_fit_80gb"}
    assert rec["num_devices"] == 4 and rec["kind"] == "train"
    assert rec["no_counterpart"] == dryrun.NO_COUNTERPART
    assert {"lower_seconds", "compile_seconds", "memory.temp_bytes", "cost",
            "collectives_schedule_bytes"} <= set(rec["no_counterpart"])
    assert rec["memory"]["argument_bytes"] == _reference_bytes("granite-3-2b", "train_4k", (2, 2))
    skip = json.loads((tmp_path / "granite-3-2b__long_500k__pod1_d2m2.json").read_text())
    assert skip["status"] == "skip" and skip["reason"]


def test_fake_mesh_refuses_a_real_group():
    assert not dist.is_initialized()
    tmesh.make_debug_mesh(device="cpu")
    try:
        with pytest.raises(RuntimeError, match="fakes its own process group"):
            dryrun.fake_mesh((16, 16), ("data", "model"))
    finally:
        dist.destroy_process_group()


def test_materialize_on_one_rank_mesh():
    """A reduced decode cell's arguments on a one-rank gloo mesh: the bytes
    allocated (the port's layout, one module per layer) are the dry run's
    argument bytes (the reference's stacked layout), each leaf keeps its
    shape, and the decode step runs on them to finite logits."""
    cfg = reduced_config(get_config("xlstm-1.3b"))
    shape = ShapeConfig("decode_small", 64, 2, "decode")
    assert not dist.is_initialized()
    mesh = tmesh.make_debug_mesh(device="cpu")
    try:
        fn, args, placements, _ = dryrun.build_cell(cfg, shape, mesh_sizes(mesh))
        want = dryrun.argument_bytes(args, placements, mesh)
        real = dryrun.materialize(args, placements, mesh, torch.Generator().manual_seed(0))
        params = real[0]
        got = sum(p.numel() * p.element_size() for p in params.parameters())
        got += sum(t.numel() * t.element_size() for a in real[1:] if a is not None
                   for t in flatten(a).values() if t is not None)
        assert got == want
        assert all(p.device.type == "cpu" and p.dtype == torch.bfloat16
                   for p in params.parameters())
        assert _sigs(dryrun.argument_trees(real)[1]) == _sigs(dryrun.argument_trees(args)[1])
        assert int(real[3]) == shape.seq_len - 1
        nxt, caches = fn(*real)
        assert nxt.shape == (2, 1)
        assert all(torch.isfinite(t.float()).all() for t in flatten(caches).values()
                   if t is not None)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v2-236b"])
def test_moe_steps_run_on_meta(arch):
    """The expert count has a static length (the reference's
    ``jnp.bincount(..., length=e)``), so the MoE archs' decode and train
    steps run on ``meta``."""
    cfg = reduced_config(get_config(arch))
    for shape in (ShapeConfig("train_small", 32, 2, "train"),
                  ShapeConfig("decode_small", 32, 2, "decode")):
        fn, args, _, _ = dryrun.build_cell(cfg, shape, {"data": 1, "model": 1})
        first, second = fn(*args)  # (state, metrics) or (next ids, caches)
        tensors = [t for t in flatten(second).values() if t is not None]
        tensors += [first] if torch.is_tensor(first) else []
        assert tensors and all(t.is_meta for t in tensors)
