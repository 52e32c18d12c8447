"""The port's host substrate against the JAX package: mixers, problem
generation, Matrix Market IO, partition plans and spectra must agree
exactly; plus the port's rules — device resolution without a CPU fallback,
the multi-device entry points that were stubs of a later slice, and the
import guard that keeps jax and ``repro`` out of ``repro_torch``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import partition as jpart
from repro.core import spectra as jspectra
from repro.sparse import io as jio
from repro.sparse import matrix as jmatrix
from repro_torch.core import partition as tpart
from repro_torch.core import spectra as tspectra
from repro_torch.sparse import io as tio
from repro_torch.sparse import matrix as tmatrix

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _skewed_coo(module, m=120, n=48, seed=0):
    """A two-population sparse system (light and heavy rows) built with the
    given package's COOMatrix."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(m):
        nnz = 3 if i < int(m * 0.65) else 16
        rows.append(np.full(nnz, i))
        cols.append(rng.choice(n, size=nnz, replace=False))
        vals.append(rng.standard_normal(nnz))
    return module.COOMatrix(
        np.concatenate(rows), np.concatenate(cols),
        np.concatenate(vals).astype(np.float32), (m, n),
    )


@pytest.mark.parametrize("m,J", [(256, 8), (235, 8), (9308, 8), (100, 3), (64, 64)])
def test_row_mixer_equal(m, J):
    a, b = jmatrix.make_row_mixer(m, J), tmatrix.make_row_mixer(m, J)
    assert (a.m, a.num_blocks, a.p) == (b.m, b.num_blocks, b.p)
    if a.g is None:
        assert b.g is None
    else:
        np.testing.assert_array_equal(a.g, b.g)
    v = np.random.default_rng(m).standard_normal((m, 3))
    np.testing.assert_array_equal(a.apply(v), b.apply(v))
    np.testing.assert_array_equal(a.apply(v[:, 0]), b.apply(v[:, 0]))


def test_plan_mixer_and_cost_aware_plan_equal():
    ja, ta = _skewed_coo(jmatrix), _skewed_coo(tmatrix)
    jp = jpart.PartitionPlan.cost_aware(ja, 4)
    tp = tpart.PartitionPlan.cost_aware(ta, 4)
    np.testing.assert_array_equal(jp.assignment, tp.assignment)
    np.testing.assert_array_equal(jp.slots, tp.slots)
    assert (jp.kind, jp.max_rows, jp.describe_block(1)) == (tp.kind, tp.max_rows, tp.describe_block(1))
    jm, tm = jmatrix.make_plan_mixer(jp), tmatrix.make_plan_mixer(tp)
    np.testing.assert_array_equal(jm.gather, tm.gather)
    np.testing.assert_array_equal(jm.g, tm.g)
    v = np.random.default_rng(1).standard_normal(120)
    np.testing.assert_array_equal(jm.apply(v), tm.apply(v))


@pytest.mark.parametrize("n,m,dtype", [(50, 235, np.float64), (64, 256, np.float32), (40, None, np.float64)])
def test_make_problem_equal(n, m, dtype):
    a = jio.make_problem(n=n, m=m, seed=3, dtype=dtype)
    b = tio.make_problem(n=n, m=m, seed=3, dtype=dtype)
    for key in ("A", "b", "x_true"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
        assert getattr(a, key).dtype == getattr(b, key).dtype
    for key in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(a.coo, key), getattr(b.coo, key))
    assert jmatrix.matrix_stats(a.coo) == tmatrix.matrix_stats(b.coo)


def test_block_rows_equal():
    prob = tio.make_problem(n=30, m=101, seed=2)
    (ja, jb), (ta, tb) = (
        mod.block_rows(prob.A, prob.b, 4) for mod in (jmatrix, tmatrix)
    )
    np.testing.assert_array_equal(ja, ta)
    np.testing.assert_array_equal(jb, tb)


def test_matrix_market_round_trip_across_packages(tmp_path):
    """The port writes plain floats, which both readers take back exactly.
    (The reference's writer puts numpy 2's "np.float64(...)" repr in the
    file, which no reader parses, so only the port's writer is exercised.)"""
    coo = tio.generate_schenk_like(40, sparsity=0.95, seed=4)
    path = str(tmp_path / "a.mtx")
    tio.save_matrix_market(path, coo)
    for load in (jio.load_matrix_market, tio.load_matrix_market):
        back = load(path)
        assert back.shape == coo.shape
        np.testing.assert_array_equal(back.to_dense(), coo.to_dense())


@pytest.mark.parametrize("J,mode", [(8, "auto"), (4, "auto"), (4, "tall"), (8, "wide")])
@pytest.mark.parametrize("dtype", [None, np.float64])
def test_partition_equal(J, mode, dtype):
    prob = tio.make_problem(n=50, m=235, seed=1)  # f64, 235 % 8 != 0: mixing rows
    # an explicit float64 is the reference with x64 on
    with jax.enable_x64(dtype is not None):
        jb, jmode, jmixer = jpart.partition_matrix(prob.A, J, mode, dtype)
        jbv = np.asarray(jpart.block_rhs(jmixer, prob.b, np.float32 if dtype is None else dtype))
    tb, tmode, tmixer = tpart.partition_matrix(prob.A, J, mode, dtype, device="cpu")
    assert jmode == tmode == jpart.resolve_mode(235, 50, J, mode) == tpart.resolve_mode(235, 50, J, mode)
    # dtype=None: float64 input becomes float32, as the x64-off reference does
    assert tb.dtype == (torch.float32 if dtype is None else torch.float64)
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    np.testing.assert_array_equal(jbv, tpart.block_rhs(tmixer, prob.b, dtype, "cpu").numpy())


def test_partition_with_plan_equal():
    ja, ta = _skewed_coo(jmatrix), _skewed_coo(tmatrix)
    jp = jpart.PartitionPlan.cost_aware(ja, 4)
    tp = tpart.PartitionPlan.cost_aware(ta, 4)
    jb, jmode, _ = jpart.partition_matrix(ja.to_dense(), 4, "auto", plan=jp)
    tb, tmode, _ = tpart.partition_matrix(ta.to_dense(), 4, "auto", plan=tp, device="cpu")
    assert jmode == tmode
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    js = jspectra.block_spectra_dense(np.asarray(jb), plan=jp)
    ts = tspectra.block_spectra_dense(tb.numpy(), plan=tp)
    for key in js:
        np.testing.assert_array_equal(js[key], ts[key])
    for a, b in zip(jspectra.derive_dynamics(js), tspectra.derive_dynamics(ts)):
        np.testing.assert_array_equal(a, b)


def test_partition_system_on_cpu():
    prob = tio.make_problem(n=32, m=128, seed=5, dtype=np.float32)
    part = tpart.partition_system(prob.A, prob.b, 4, device="cpu")
    jp = jpart.partition_system(prob.A, prob.b, 4)
    assert (part.mode, part.num_blocks, part.block_rows, part.num_cols) == (
        jp.mode, jp.num_blocks, jp.block_rows, jp.num_cols)
    np.testing.assert_array_equal(part.bvecs.numpy(), np.asarray(jp.bvecs))


# -- device resolution: no silent CPU fallback -------------------------------


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.core import prepare, solve
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch import linear_probe, serve, serve_solver
    from repro_torch.launch import solve as launch_solve
    from repro_torch.launch import train
    from repro_torch.models import blocks, params_from_reference, transformer
    from repro_torch.training import train_loop
    from repro_torch.training.checkpoint import restore as restore_checkpoint
    from repro_torch.training.data import DataConfig, make_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config(get_config("granite-3-2b"))
    prob = tio.make_problem(n=16, m=64, seed=0, dtype=np.float32)
    for call in (
        lambda: resolve_device(None),
        lambda: resolve_device("cuda"),
        lambda: prepare(prob.A, num_blocks=4),
        lambda: prepare(prob.A, num_blocks=4, device=None),
        lambda: solve(prob.A, prob.b, num_blocks=4),
        lambda: launch_solve.main(["--n", "16", "--m", "64", "--blocks", "4"]),
        lambda: serve_solver.main(["--n", "16", "--m", "64", "--num-blocks", "4",
                                   "--requests", "2"]),
        lambda: serve.main(["--arch", "granite-3-2b", "--reduce"]),
        lambda: linear_probe.main(["--reduce"]),
        lambda: transformer.Transformer(cfg),
        lambda: blocks.make_block(cfg, "dense"),
        lambda: transformer.init_cache(cfg, 1, 4),
        lambda: params_from_reference(cfg, {}),
        lambda: train.main(["--arch", "granite-3-2b", "--reduce", "--steps", "1"]),
        lambda: train_loop.train(cfg, train_loop.TrainConfig(num_steps=1),
                                 DataConfig(cfg.vocab_size, 4, 1)),
        lambda: make_batch(DataConfig(cfg.vocab_size, 4, 1), 0),
        lambda: restore_checkpoint("unused", 0, {}),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


# -- the multi-device entry points (once stubs of a later slice) --------------


def test_not_implemented_stubs():
    """Every entry point that raised before the multi-device slice now takes
    its path: ``mesh=`` prepares the sharded solver (and refuses the dense
    path as the reference does), the collective audit counts, a server pools
    a mesh registration, and ``serve_solver --mesh`` checks its arguments."""
    from repro_torch import obs
    from repro_torch.core import ShardedMatrixFreeSolver, prepare
    from repro_torch.launch import serve_solver
    from repro_torch.serving import SolveServer

    from test_torch_matfree_sharded import one_rank_mesh

    prob = tio.make_problem(n=16, m=64, seed=0, dtype=np.float32)
    big = tio.make_problem(n=256, m=256, seed=0, dtype=np.float32)
    with one_rank_mesh() as mesh:
        sharded = prepare(big.coo, num_blocks=4, mode="matfree", mesh=mesh, device="cpu")
        assert isinstance(sharded, ShardedMatrixFreeSolver)
        with pytest.raises(ValueError, match="matfree"):
            prepare(prob.A, num_blocks=4, mesh=mesh, device="cpu")
        audit = obs.audit_epoch_collectives(sharded, big.b, num_epochs=2)
        assert (audit["ops"], audit["payload_elems"]) == (1, 256)
        assert obs.collect_reduces(audit["found"][:0]) == []
        server = SolveServer(prepare_kwargs=dict(num_blocks=4, mode="matfree", mesh=mesh,
                                                 device="cpu"))
        assert server.pool.prepare_kwargs["mesh"] is mesh
    with pytest.raises(SystemExit):
        serve_solver.main(["--mesh", "4", "--device", "cpu"])  # needs --mode matfree
    prep = prepare(prob.A, num_blocks=4, device="cpu")
    arrays, meta = prep.to_state()
    with pytest.raises(ValueError, match="matrix-free"):
        type(prep).from_state(arrays, {**meta, "path": "matfree"}, device="cpu")


# -- the import guard --------------------------------------------------------


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_port_never_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py"]
    assert len(files) > 20
    ported = {f.relative_to(PORT).as_posix() for f in files if PORT in f.parents}
    assert {"core/dgd.py", "core/cg.py", "core/guard.py", "core/session.py",
            "obs/__init__.py", "obs/convergence.py", "obs/clock.py", "obs/metrics.py",
            "obs/trace.py", "serving/__init__.py", "serving/policy.py",
            "serving/checkpoint.py", "serving/faults.py", "serving/queue.py",
            "launch/serve_solver.py", "configs/base.py", "configs/shapes.py",
            "models/spec.py", "models/layers.py", "models/blocks.py", "models/transformer.py",
            "models/convert.py", "models/costs.py", "serving/decode.py", "launch/serve.py",
            "launch/linear_probe.py", "models/moe.py", "models/ssm.py",
            "models/xlstm.py", "models/losses.py", "training/optimizer.py",
            "training/data.py", "training/checkpoint.py", "training/train_loop.py",
            "distributed/compression.py", "launch/train.py"} <= ported
    offenders = {
        str(f.relative_to(ROOT)): sorted(_imports(f) & {"jax", "jaxlib", "repro"})
        for f in files
    }
    assert not {k: v for k, v in offenders.items() if v}


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, repro_torch.core, repro_torch.launch.solve, repro_torch.kernels.trisolve.ops, "
        "repro_torch.kernels.project.ops, repro_torch.kernels.spmm.ops, repro_torch.core.matfree, "
        "repro_torch.sparse.bsr, repro_torch.core.dgd, repro_torch.core.cg, repro_torch.core.guard, "
        "repro_torch.core.session, repro_torch.obs, repro_torch.obs.convergence, "
        "repro_torch.serving, repro_torch.launch.serve_solver, repro_torch.configs, "
        "repro_torch.models, repro_torch.models.convert, repro_torch.serving.decode, "
        "repro_torch.launch.serve, repro_torch.launch.linear_probe, repro_torch.models.moe, "
        "repro_torch.models.ssm, repro_torch.models.xlstm, repro_torch.models.blocks, "
        "repro_torch.models.losses, repro_torch.training.train_loop, repro_torch.launch.train, "
        "repro_torch.distributed\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
