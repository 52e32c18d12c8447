"""The port's sharded matrix-free solver on a one-rank mesh, against the JAX
package's ``ShardedMatrixFreeSolver`` on ``jax.make_mesh((1,), ("data",))``
and against the port's own unsharded solver.

The one-rank mesh runs the whole SPMD program — placement, the collectives
wrapper, the post-loop residual collapse and gathers — through a ``gloo``
group of this process (a ``HashStore``, started by ``make_host_local_mesh``
and destroyed after the module). The multi-rank runs are
``tests/test_torch_mesh_ranks.py``.

The reference tests' problem: ``generate_schenk_like(192, 0.998, seed=5)``,
J = 8, k = 4, (γ, η) = (2.0, 1.9). Against the reference: x within
1e-4·max|x|, residual history rtol 1e-3 (above the float32 noise floor of
``test_torch_dapc._floor``), equal ``iterations_to_tol`` under
``tol``, equal history shapes; the collective audit's ``ops`` and
``payload_elems`` equal to the reference's jaxpr walk. Against the port's
unsharded solver, both rebuilt from the reference's state with the same
placement code: within 1e-5·max|x| (one rank computes the same arithmetic,
so the two are equal bit for bit here).
"""
import asyncio
import contextlib

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.core as jcore
from repro.obs import convergence as jconv
from repro.sparse import generate_schenk_like as jgenerate
from repro_torch import obs
from repro_torch.core import MatrixFreePreparedSolver, ShardedMatrixFreeSolver, prepare
from repro_torch.core import matfree_sharded
from repro_torch.launch import mesh as tmesh
from repro_torch.serving import PreparedPool, SolveServer
from repro_torch.serving import mesh as mesh_link
from repro_torch.sparse import generate_schenk_like

from test_torch_dapc import _floor

GAMMA, ETA = 2.0, 1.9
N, K, J = 192, 4, 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small solves of many tiny ops: one intra-op thread (also for the
    spawned ranks, which split the launcher's) keeps them fast when
    parallel test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@contextlib.contextmanager
def one_rank_mesh():
    """A one-rank ``("data",)`` mesh on a gloo group of this process (also
    for other modules' tests); the group is destroyed on exit."""
    assert not dist.is_initialized()
    mesh = tmesh.make_host_local_mesh(1, device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh():
    with one_rank_mesh() as m:
        yield m


@pytest.fixture(scope="module")
def problem():
    coo = generate_schenk_like(N, sparsity=0.998, seed=5)
    A = coo.to_dense().astype(np.float32)
    xs = np.random.default_rng(105).standard_normal((N, K)).astype(np.float32)
    return coo, (A @ xs).astype(np.float32), xs


def _jmesh():
    return jax.make_mesh((1,), ("data",))


def _jcoo():
    return jgenerate(N, sparsity=0.998, seed=5)


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


@pytest.mark.parametrize("gram_solver", ["direct", "pcg"])
def test_sharded_matches_reference(mesh, problem, gram_solver):
    coo, B, xs = problem
    ref = jcore.prepare(_jcoo(), mode="matfree", num_blocks=J, mesh=_jmesh(),
                        gram_solver=gram_solver)
    sh = prepare(coo, mode="matfree", num_blocks=J, mesh=mesh, gram_solver=gram_solver,
                 device="cpu")
    assert isinstance(sh, ShardedMatrixFreeSolver) and isinstance(ref, jcore.ShardedMatrixFreeSolver)
    assert sh.path == ref.path == "matfree_sharded" and sh.mode == "matfree"
    assert sh.gram_solver == gram_solver and sh.num_shards == 1 and sh.num_blocks == J
    got = sh.solve(B, num_epochs=120, gamma=GAMMA, eta=ETA, x_ref=xs)
    want = ref.solve(B, num_epochs=120, gamma=GAMMA, eta=ETA, x_ref=xs)
    assert _rel(got.x, want.x) <= 1e-4
    # rtol 1e-3 above the float32 noise floor (1e-9 of the largest ||b||²)
    np.testing.assert_allclose(got.history["residual_sq"], np.asarray(want.history["residual_sq"]),
                               rtol=1e-3, atol=_floor(B))
    for key in ("residual_sq", "inner_iters", "mse"):
        assert got.history[key].shape == np.asarray(want.history[key]).shape == (120, K)
    np.testing.assert_array_equal(got.history["inner_iters"], np.asarray(want.history["inner_iters"]))
    # the same layout, bit for bit (the same host numpy builds it)
    np.testing.assert_array_equal(sh.op.fwd_data.numpy(), np.asarray(ref.op.fwd_data))
    assert sh.memory_bytes == sh.per_device_memory_bytes == sh.local_memory_bytes
    assert len(got.per_column(tol=1e3)) == K


@pytest.mark.parametrize("gram_solver", ["direct", "pcg"])
def test_sharded_iterations_to_tol_match_reference(mesh, problem, gram_solver):
    coo, B, _ = problem
    ref = jcore.prepare(_jcoo(), mode="matfree", num_blocks=J, mesh=_jmesh(),
                        gram_solver=gram_solver)
    sh = prepare(coo, mode="matfree", num_blocks=J, mesh=mesh, gram_solver=gram_solver,
                 device="cpu")
    free = ref.solve(B, num_epochs=120, gamma=GAMMA, eta=ETA)
    tol = float(np.sqrt(np.asarray(free.history["residual_sq"])[-1].max()) * 3.0)
    got = sh.solve(B, num_epochs=120, gamma=GAMMA, eta=ETA, tol=tol)
    want = ref.solve(B, num_epochs=120, gamma=GAMMA, eta=ETA, tol=tol)
    np.testing.assert_array_equal(got.iterations_to_tol(tol), want.iterations_to_tol(tol))
    assert (got.iterations_to_tol(tol) < 120).all()
    assert _rel(got.x, want.x) <= 1e-4


def _carried_pair(mesh, **kw):
    """(port sharded, port unsharded), both from the reference's state."""
    ref = jcore.prepare(_jcoo(), mode="matfree", num_blocks=J, **kw)
    arrays, meta = ref.to_state()
    sh = ShardedMatrixFreeSolver.from_state(arrays, meta, device="cpu", mesh=mesh)
    return sh, MatrixFreePreparedSolver.from_state(arrays, meta, device="cpu")


@pytest.mark.parametrize("gram_solver", ["direct", "pcg"])
def test_sharded_matches_unsharded(mesh, problem, gram_solver):
    _, B, xs = problem
    sh, single = _carried_pair(mesh, gram_solver=gram_solver)
    for kw in ({}, {"tol": 1.0, "block_history": True}):
        got = sh.solve(B, num_epochs=80, gamma=GAMMA, eta=ETA, x_ref=xs, **kw)
        want = single.solve(B, num_epochs=80, gamma=GAMMA, eta=ETA, x_ref=xs, **kw)
        assert _rel(got.x, want.x) <= 1e-5
        np.testing.assert_array_equal(got.x, want.x)  # one rank: the same arithmetic
        for key in want.history:
            if key != "initial":
                np.testing.assert_array_equal(got.history[key], want.history[key])
    # one RHS, a masked warm start, and per-block dynamics ride along
    warm = (np.tile(xs[:, :1], (1, K)), np.array([True, False, True, False]))
    got = sh.solve(B, num_epochs=20, x0=warm)
    np.testing.assert_array_equal(got.x, single.solve(B, num_epochs=20, x0=warm).x)
    got = sh.solve(B[:, 0], num_epochs=20)
    assert got.x.shape == (N,) and got.history["residual_sq"].shape == (20,)
    np.testing.assert_array_equal(got.x, single.solve(B[:, 0], num_epochs=20).x)
    arrays, meta = sh.to_state()  # gathered from the ranks: the whole operator
    want_arrays, want_meta = single.to_state()
    assert meta == want_meta
    for key in want_arrays:
        np.testing.assert_array_equal(arrays[key], want_arrays[key])


def test_sharded_per_block_dynamics(mesh, problem):
    coo, B, _ = problem
    sh = prepare(coo, mode="matfree", num_blocks=J, mesh=mesh, dynamics="per_block",
                 device="cpu", gamma=GAMMA, eta=ETA)
    single = prepare(coo, mode="matfree", num_blocks=J, dynamics="per_block",
                     device="cpu", gamma=GAMMA, eta=ETA)
    np.testing.assert_allclose(sh.block_eta_weights, single.block_eta_weights, rtol=1e-6)
    got, want = sh.solve(B, num_epochs=40), single.solve(B, num_epochs=40)
    assert _rel(got.x, want.x) <= 1e-5
    ref = jcore.prepare(_jcoo(), mode="matfree", num_blocks=J, mesh=_jmesh(),
                        dynamics="per_block", gamma=GAMMA, eta=ETA)
    assert _rel(got.x, np.asarray(ref.solve(B, num_epochs=40).x)) <= 1e-4


@pytest.mark.parametrize("gram_solver", ["direct", "pcg"])
@pytest.mark.parametrize("tol", [None, 1.0])
@pytest.mark.parametrize("block_history", [False, True])
def test_audit_matches_reference(mesh, problem, gram_solver, tol, block_history):
    coo, B, _ = problem
    ref = jcore.prepare(_jcoo(), mode="matfree", num_blocks=J, mesh=_jmesh(),
                        gram_solver=gram_solver, gamma=GAMMA, eta=ETA)
    sh = prepare(coo, mode="matfree", num_blocks=J, mesh=mesh, gram_solver=gram_solver,
                 device="cpu", gamma=GAMMA, eta=ETA)
    want = jconv.audit_epoch_collectives(ref, B, tol=tol, block_history=block_history)
    got = obs.audit_epoch_collectives(sh, B, tol=tol, block_history=block_history)
    assert (got["ops"], got["payload_elems"]) == (want["ops"], want["payload_elems"])
    direct = gram_solver == "direct"
    assert got["ops"] == (1 if direct else 2) + (tol is not None)
    assert got["payload_elems"] == N * K + K * (got["ops"] - 1)
    # the budget asserts on the counted calls
    obs.audit_epoch_collectives(sh, B, tol=tol, max_ops=got["ops"],
                                max_payload_elems=got["payload_elems"])
    with pytest.raises(AssertionError, match="collectives > budget"):
        obs.audit_epoch_collectives(sh, B, tol=tol, max_ops=got["ops"] - 1)
    in_epoch = [f for f in got["found"] if f[0]]
    assert len(in_epoch) == 8 * got["ops"]  # the default 8 epochs, each the same calls
    assert obs.collect_reduces([(None, "all_gather", 3), (0, "all_reduce_sum", 5)]) == [
        (False, "all_gather", 3), (True, "all_reduce_sum", 5)]


def test_single_device_solver_has_no_collectives(problem):
    coo, B, _ = problem
    single = prepare(coo, mode="matfree", num_blocks=J, device="cpu")
    assert obs.audit_epoch_collectives(single, B) == {"payload_elems": 0, "ops": 0, "found": []}


class _FakeMesh:
    """The parts of a ``DeviceMesh`` the layout checks read (no group)."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = shape, names
        self.device_type = "cpu"

    def size(self, dim=None):
        return int(np.prod(self.shape)) if dim is None else self.shape[dim]


def test_mesh_errors(mesh, problem):
    coo, _, _ = problem
    A = coo.to_dense().astype(np.float32)
    with pytest.raises(ValueError, match="matfree"):
        prepare(A, mode="dense", num_blocks=J, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="matfree"):
        prepare(A, mode="auto", num_blocks=J, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        prepare(coo, mode="matfree", num_blocks=J, mesh=mesh, block_axes=("model",),
                device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        prepare(coo, mode="matfree", num_blocks=6, mesh=_FakeMesh((4,), ("data",)),
                device="cpu")
    assert matfree_sharded.mesh_block_devices(_FakeMesh((2, 3), ("data", "model")),
                                              ("data", "model")) == 6
    with pytest.raises(ValueError, match="restores onto a mesh"):
        ShardedMatrixFreeSolver.from_state({}, {})
    with pytest.raises(ValueError, match="gloo"):
        tmesh.pick_backend("cuda", "nccl", torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="CUDA"):
        tmesh.pick_backend("cpu", "nccl", 1)
    assert tmesh.pick_backend("cpu", None, 4) == "gloo"
    with pytest.raises(ValueError, match="asks for 2"):
        tmesh.make_host_local_mesh(2, device="cpu")  # this group has one rank


def test_placement_keeps_this_ranks_blocks(mesh, problem):
    coo, B, _ = problem
    from repro_torch.sparse.bsr import PartitionedBSR

    whole = PartitionedBSR.from_coo(coo, J, with_transpose=True, with_gram=True, balance=True,
                                    device="cpu")
    spec = whole.shard_spec(mesh, ("data",))
    assert set(spec) == {"fwd_indices", "fwd_data", "tra_indices", "tra_data",
                         "gram_indices", "gram_data", "ext_pos", "int_pos"}
    assert all(ranges == [(0, J)] for ranges in spec.values())
    placed = whole.place(mesh, ("data",), device="cpu")
    assert placed.shard == (0, J, J) and placed.global_blocks == J
    np.testing.assert_array_equal(placed.fwd_data.numpy(), whole.fwd_data.numpy())
    np.testing.assert_array_equal(placed.block_rhs(B).numpy(), whole.block_rhs(B).numpy())
    assert placed.dense_bytes == whole.dense_bytes


def test_make_debug_mesh(mesh):
    debug = tmesh.make_debug_mesh(device="cpu")
    assert tuple(debug.mesh_dim_names) == ("data", "model") and debug.size() == 1
    assert tuple(tmesh.make_host_local_mesh(1, device="cpu").mesh_dim_names) == ("data",)


# -- serving a mesh registration ----------------------------------------------


def test_serving_pool_routes_sharded(mesh, problem):
    coo, B, _ = problem
    kw = dict(num_blocks=J, mode="matfree", mesh=mesh, gamma=GAMMA, eta=ETA, device="cpu")

    async def main():
        async with SolveServer(max_batch=3, max_wait_ms=20.0, num_epochs=100,
                               prepare_kwargs=kw) as srv:
            fp = srv.register(coo)
            results = await asyncio.gather(*(srv.submit(fp, B[:, i]) for i in range(3)))
            return results, srv.pool.resident(), srv.pool.get(fp)

    results, resident, pooled = asyncio.run(main())
    assert isinstance(pooled, ShardedMatrixFreeSolver)
    assert resident[0]["path"] == "matfree_sharded"
    want = prepare(coo, **kw).solve(B[:, :3], num_epochs=100).x
    for i, r in enumerate(results):
        np.testing.assert_allclose(r.x, want[:, i], atol=1e-5)
    pool = PreparedPool(**kw)
    fp = pool.register(coo)
    assert not pool.has_fallback(fp)  # mesh-backed entries have no fallback rung
    assert pool.system(fp)[1]["mesh"] is mesh


def _scripted(commands, sent):
    """A ``_broadcast`` stand-in: records what rank 0 sends, and hands a
    follower the scripted commands in turn."""
    feed = iter(commands)

    def broadcast(command):
        if command is not None:
            sent.append(command)
            return command
        return next(feed)

    return broadcast


def test_followers_hear_every_mesh_call_after_local_faults(mesh, problem, monkeypatch):
    """Rank 0 announces a prepare or solve only after its own fault hook,
    and exactly once per call it then makes: an injected solve error on
    rank 0 is announced never, the recovery's re-solve once."""
    from repro_torch.serving.faults import FaultInjector, FaultPlan, FaultRule

    coo, B, _ = problem
    sent = []
    monkeypatch.setattr(mesh_link, "_broadcast", _scripted([], sent))
    monkeypatch.setattr(mesh_link, "_spans_ranks", lambda kw: kw.get("mesh") is not None)
    plan = FaultPlan(rules=(FaultRule(site="solve", kind="error", times=1),))
    kw = dict(num_blocks=J, mode="matfree", mesh=mesh, gamma=GAMMA, eta=ETA, device="cpu")

    async def main():
        async with SolveServer(max_batch=2, max_wait_ms=5.0, num_epochs=40,
                               prepare_kwargs=kw, faults=FaultInjector(plan)) as srv:
            fp = srv.register(coo)
            return fp, await srv.submit(fp, B[:, 0])

    fp, result = asyncio.run(main())
    assert np.isfinite(result.x).all()
    ops = [(c["op"], c["fingerprint"]) for c in sent]
    assert ops == [("prepare", fp), ("solve", fp)]  # the failed attempt sent nothing
    assert "mesh" not in sent[0]["kwargs"] and sent[0]["kwargs"]["num_blocks"] == J
    assert sent[1]["kwargs"]["num_epochs"] == 40 and sent[1]["b"].shape == (N, 2)  # padded


def test_follower_survives_a_failing_solve(mesh, problem, monkeypatch):
    """A follower makes rank 0's calls in order; a solve that raises on it
    (as on rank 0: the same checks on the same inputs) is reported and the
    loop serves the next command until the stop."""
    coo, B, _ = problem
    kw = dict(num_blocks=J, mode="matfree", mesh=mesh, gamma=GAMMA, eta=ETA, device="cpu")
    pool = PreparedPool(**kw)
    fp = pool.register(coo)
    public = mesh_link.public_kwargs(kw)
    calls = []
    real_solve = ShardedMatrixFreeSolver.solve
    monkeypatch.setattr(ShardedMatrixFreeSolver, "solve",
                        lambda self, b, **k: calls.append(real_solve(self, b, **k)))
    commands = [
        {"op": "prepare", "fingerprint": fp, "kwargs": public},
        {"op": "solve", "fingerprint": fp, "b": B[:5], "kwargs": {"num_epochs": 5}},
        {"op": "solve", "fingerprint": fp, "b": B, "kwargs": {"num_epochs": 5}},
        {"op": "stop"},
    ]
    monkeypatch.setattr(mesh_link, "_broadcast", _scripted(commands, []))
    assert mesh_link.serve_follower(pool) == 3
    assert len(calls) == 1 and calls[0].x.shape == (N, K)
