"""The port's mesh rules (``repro_torch.distributed.sharding``) against the
JAX package's ``repro.distributed.sharding``, and the elastic restore
(``training.checkpoint.restore(..., shardings=)``), on the CPU:

- for all ten archs on the ``(16, 16)``, ``(2, 16, 16)`` and ``(1, 1)``
  meshes, every leaf of ``param_specs``, of ``cache_shapes`` at
  ``decode_32k`` and of ``train_4k``'s batch: the port's spec equals
  ``tuple`` of the reference's ``PartitionSpec`` (computed from axis sizes,
  no process group), and each rank's shape — a ``meta`` DTensor's local
  shape over a fake 256/512/1-rank group, in a subprocess — equals
  ``NamedSharding(AbstractMesh, spec).shard_shape``, exactly;
- ``spec_placements`` and ``named_shardings`` on a one-rank gloo mesh;
- ``tests/test_training.py::test_elastic_restore_new_sharding`` on the
  port, and a (4, 4) leaf restored with ``Shard(0)`` over 2 gloo ranks:
  each rank holds its slice.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding as JNamedSharding
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs import get_config as jget_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.distributed import sharding as jsharding
from repro.launch import dryrun as jdryrun
from repro.models import transformer as jtransformer

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.checkpoint import flatten

SRC = Path(__file__).resolve().parent.parent / "src"
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}
DECODE = SHAPES["decode_32k"]

# each rank's shape of every leaf, from DTensor over a fake group; one
# process for all meshes (the fake group is global to a process)
LOCAL_SHAPES = r"""
import json, sys
import torch
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.distributed.sharding import mesh_sizes, spec_placements
from repro_torch.launch import dryrun
from repro_torch.training.checkpoint import flatten

def local(structs, specs, mesh):
    names = tuple(mesh_sizes(mesh))
    specs = flatten(specs)
    return {path: list(dryrun.distribute_meta(leaf, spec_placements(specs[path], names),
                                              mesh).to_local().shape)
            for path, leaf in flatten(structs).items() if leaf is not None}

out = {}
for label, (dims, axes) in json.loads(sys.argv[1]).items():
    mesh = dryrun.fake_mesh(dims, axes)
    sizes = mesh_sizes(mesh)
    for arch in ARCHS:
        cfg = get_config(arch)
        params = dryrun.meta_model(cfg, torch.float32)
        out[f"{label}/{arch}"] = {
            "params": local(dryrun.argument_trees((params,))[0],
                            dryrun.param_pspecs(cfg, sizes), mesh),
            "cache": local(*dryrun.cache_specs(cfg, 128, 32768, sizes), mesh),
            "batch": local(*dryrun.batch_specs(cfg, SHAPES["train_4k"], sizes), mesh),
        }
torch.distributed.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def local_shapes():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", LOCAL_SHAPES, json.dumps(MESHES)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


def _reference_leaves(arch, mesh):
    """{kind: {path: (shape, logical axes or reference spec)}} of the
    reference's params, decode_32k caches and train_4k batch."""
    jcfg = jget_config(arch)
    params = {p: (s.shape, s.axes) for p, s in flatten(jtransformer.param_specs(jcfg)).items()}
    cache = {p: (leaf[0], leaf[2]) for p, leaf in flatten(
        jtransformer.cache_shapes(jcfg, DECODE.global_batch, DECODE.seq_len)).items()
        if leaf is not None}
    structs, pspecs = jdryrun.batch_specs(jcfg, JSHAPES["train_4k"], mesh)
    batch = {p: (structs[p].shape, pspecs[p]) for p in structs}
    return params, cache, batch


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_match_reference(local_shapes, arch, mesh_name):
    dims, axes = MESHES[mesh_name]
    jmesh = AbstractMesh(dims, axes)
    sizes = dict(zip(axes, dims))
    cfg = get_config(arch)
    jparams, jcache, jbatch = _reference_leaves(arch, jmesh)
    got = local_shapes[f"{mesh_name}/{arch}"]

    port_params = flatten(transformer.param_specs(cfg))
    assert port_params.keys() == jparams.keys()
    want = {}
    for path, (shape, axes_) in jparams.items():
        spec = port_params[path]
        assert (spec.shape, spec.axes) == (tuple(shape), tuple(axes_)), path
        want[path] = jsharding.logical_to_spec(axes_, shape, jmesh)
        assert sharding.logical_to_spec(spec.axes, spec.shape, sizes) == tuple(want[path]), path
    assert sharding.tree_pspecs(transformer.param_specs(cfg), sizes) == \
        dryrun.param_pspecs(cfg, sizes)
    assert flatten(dryrun.param_pspecs(cfg, sizes)) == {p: tuple(s) for p, s in want.items()}
    for path, (shape, _) in jparams.items():
        assert tuple(got["params"][path]) == JNamedSharding(jmesh, want[path]).shard_shape(
            shape), path

    port_cache = {p: leaf for p, leaf in flatten(transformer.cache_shapes(
        cfg, DECODE.global_batch, DECODE.seq_len)).items() if leaf is not None}
    assert port_cache.keys() == jcache.keys() == got["cache"].keys()
    for path, (shape, axes_) in jcache.items():
        assert port_cache[path][0] == tuple(shape) and port_cache[path][2] == tuple(axes_)
        spec = jsharding.logical_to_spec(axes_, shape, jmesh)
        assert sharding.logical_to_spec(axes_, shape, sizes) == tuple(spec), path
        assert tuple(got["cache"][path]) == JNamedSharding(jmesh, spec).shard_shape(shape), path

    _, port_batch = dryrun.batch_specs(cfg, SHAPES["train_4k"], sizes)
    assert port_batch.keys() == jbatch.keys() == got["batch"].keys()
    for path, (shape, spec) in jbatch.items():
        assert port_batch[path] == tuple(spec), path
        assert tuple(got["batch"][path]) == JNamedSharding(jmesh, spec).shard_shape(shape), path


def test_spec_placements():
    names = ("pod", "data", "model")
    assert sharding.spec_placements((("pod", "data"), None, "model"), names) == (
        Shard(0), Shard(0), Shard(2))
    assert sharding.spec_placements((None, "data"), names) == (Replicate(), Shard(1), Replicate())
    assert sharding.spec_placements((), ("data", "model")) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="out of the mesh's order"):
        sharding.spec_placements((("data", "pod"),), names)
    with pytest.raises(ValueError, match="not axes of the mesh"):
        sharding.spec_placements(("pod",), ("data", "model"))


def test_rules_drop_axes_that_do_not_divide():
    """8 KV heads on a 16-way model axis replicate; a batch of 48 on (2, 16)
    keeps ``pod`` only; a mesh axis is used once per spec."""
    sizes = {"pod": 2, "data": 16, "model": 16}
    assert sharding.logical_to_spec(("embed", "kv_flat"), (4096, 8), sizes) == ("data", None)
    assert sharding.logical_to_spec(("batch", "seq"), (48, 4096), sizes) == ("pod", None)
    assert sharding.logical_to_spec(("batch", None, "seq_kv"), (64, 8, 32768), sizes) == (
        ("pod", "data"), None, "model")
    assert sharding.logical_to_spec(("vocab", "ff"), (32, 64), sizes) == ("model", None)


def test_shape_structs_are_meta():
    structs = sharding.shape_structs(transformer.param_specs(get_config("granite-3-2b")),
                                     torch.bfloat16)
    leaves = flatten(structs)
    assert leaves and all(t.is_meta and t.dtype == torch.bfloat16 for t in leaves.values())
    assert leaves["embed"].shape == (49408, 2048)


def test_named_shardings_on_one_rank_mesh():
    assert not dist.is_initialized()
    mesh = tmesh.make_debug_mesh(device="cpu")
    try:
        specs = transformer.param_specs(get_config("granite-3-2b"))
        shardings = flatten(sharding.named_shardings(specs, mesh))
        assert shardings.keys() == flatten(specs).keys()
        assert all(s.mesh is mesh for s in shardings.values())
        # (1, 1): every named axis divides, so the specs' shards stay
        assert shardings["embed"].placements == (Shard(1), Shard(0))
        assert shardings["main/slot0_dense/attn/w_o"].placements == (Shard(2), Shard(1))
        assert shardings["final_norm/scale"].placements == (Replicate(), Replicate())
    finally:
        dist.destroy_process_group()


def test_elastic_restore_new_sharding(tmp_path):
    """Restore onto a different mesh layout (elastic scale event)."""
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    ckpt_lib.save(str(tmp_path), 1, tree)
    assert not dist.is_initialized()
    mesh = tmesh.make_host_local_mesh(1, device="cpu")
    try:
        sh = {"w": sharding.NamedSharding(mesh, sharding.spec_placements(("data", None),
                                                                         ("data",)))}
        back = ckpt_lib.restore(str(tmp_path), 1, tree, shardings=sh)
        assert isinstance(back["w"], DTensor)
        np.testing.assert_array_equal(back["w"].full_tensor().numpy(), tree["w"].numpy())
        assert back["w"].placements == sh["w"].placements == (Shard(0),)
        assert back["w"].device_mesh is mesh
    finally:
        dist.destroy_process_group()


def restore_rank(rank, ckpt_dir, out_dir):
    """A ``run_ranks`` entry: restore the (4, 4) leaf with ``Shard(0)`` over
    the 2-rank ``("data",)`` mesh and save this rank's local block."""
    mesh = tmesh.make_host_local_mesh(2, device="cpu")
    sh = {"w": sharding.NamedSharding(mesh, (Shard(0),))}
    back = ckpt_lib.restore(ckpt_dir, 1, {"w": torch.empty(4, 4, device="meta")}, shardings=sh)
    np.save(os.path.join(out_dir, f"rank{rank}.npy"), back["w"].to_local().numpy())


def test_elastic_restore_over_two_ranks(tmp_path):
    w = np.arange(16.0, dtype=np.float32).reshape(4, 4)
    ckpt_lib.save(str(tmp_path / "ckpt"), 1, {"w": w})
    tmesh.run_ranks(restore_rank, 2, "gloo", "cpu", args=(str(tmp_path / "ckpt"), str(tmp_path)))
    for rank in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"rank{rank}.npy"),
                                      w[2 * rank: 2 * rank + 2])


def test_param_spec_exports():
    """``repro_torch.distributed`` exports ``ParamSpec`` and
    ``init_from_specs`` as ``repro.distributed`` does: ``models/spec.py``'s
    objects, no second copy. ``init_from_specs`` gives the reference's tree
    (keys, shapes, dtypes, the zeros and ones exactly, normal draws at their
    scale)."""
    import jax

    from repro.distributed import ParamSpec as JParamSpec, init_from_specs as jinit
    from repro_torch.distributed import ParamSpec, init_from_specs
    from repro_torch.models import spec

    assert ParamSpec is spec.ParamSpec and init_from_specs is spec.init_from_specs

    def tree(cls):
        return {"w": cls((64, 32), ("embed", "mlp"), scale=0.5),
                "norm": {"g": cls((32,), ("embed",), init="ones"),
                         "b": cls((32,), ("embed",), init="zeros")}}

    want = jinit(tree(JParamSpec), jax.random.PRNGKey(0))
    got = init_from_specs(tree(ParamSpec), torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want) and sorted(got["norm"]) == sorted(want["norm"])
    assert got["w"].shape == want["w"].shape and got["w"].dtype == torch.float32
    assert torch.equal(got["norm"]["g"], torch.ones(32))
    assert torch.equal(got["norm"]["b"], torch.zeros(32))
    assert float(got["w"].std()) == pytest.approx(float(np.asarray(want["w"]).std()), rel=0.1)
