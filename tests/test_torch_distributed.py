"""The port's dense multi-device solvers (``solve_sharded``,
``solve_sharded_2d``, ``repartition``) against the JAX package's, on
one-rank meshes: ``("data",)`` and the ``("data", "model")`` debug mesh,
through a ``gloo`` group of this process, destroyed after the module.

Both packages get the same blocks: the reference's ``partition_system``
output as numpy. Tolerances are the reference tests' own
(``tests/test_distributed_solver.py``): x at atol 1e-5 (2-D against the
single-host solve at 1e-4), the MSE history at rtol 1e-3. The straggler drop
masks come from a ``torch.Generator`` per rank, not ``jax.random``, so the
straggler run is held at the reference's convergence gates, not to its
trajectory. The multi-rank runs are ``tests/test_torch_mesh_ranks.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import distributed as jdist
from repro.core import partition_system
from repro.sparse import make_problem
from repro_torch.core import distributed
from repro_torch.launch import mesh as tmesh


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small solves of many tiny ops: one intra-op thread (also for the
    spawned ranks, which split the launcher's) keeps them fast when
    parallel test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def meshes():
    assert not dist.is_initialized()
    one = tmesh.make_host_local_mesh(1, device="cpu")
    yield one, tmesh.make_debug_mesh(device="cpu")
    dist.destroy_process_group()


def _jmesh():
    return jax.make_mesh((1,), ("data",))


def _system(n=64, m=256, seed=2, k=None):
    prob = make_problem(n=n, m=m, seed=seed, dtype=np.float32)
    if k is None:
        part = partition_system(prob.A, prob.b, 8)
        return part, prob.x_true
    xs = np.random.default_rng(5).standard_normal((n, k)).astype(np.float32)
    return partition_system(prob.A, prob.A @ xs, 8), xs


def _np(tree):
    return {key: np.asarray(v) for key, v in tree.items()}


@pytest.mark.parametrize("method,k", [("dapc", None), ("apc", None), ("dapc", 4), ("apc", 4)])
def test_solve_sharded_matches_reference(meshes, method, k):
    part, ref = _system(k=k) if method == "dapc" else _system(48, 192, 4, k=k)
    blocks, bvecs = np.asarray(part.blocks), np.asarray(part.bvecs)
    x, hist = distributed.solve_sharded(blocks, bvecs, meshes[0], part.mode, method=method,
                                        num_epochs=80, x_ref=ref)
    jx, jhist = jdist.solve_sharded(part.blocks, part.bvecs, _jmesh(), part.mode, method=method,
                                    num_epochs=80, x_ref=jnp.asarray(ref))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-5)
    jhist = _np(jhist)
    for key in ("mse", "residual_sq"):
        assert hist[key].shape == jhist[key].shape
    np.testing.assert_allclose(hist["mse"].numpy(), jhist["mse"], rtol=1e-3, atol=1e-10)
    assert float(hist["mse"][-1].max()) < 1e-8


def test_solve_sharded_batched_matches_per_column(meshes):
    part, xs = _system(k=4)
    blocks, bvecs = np.asarray(part.blocks), np.asarray(part.bvecs)
    x_b, h_b = distributed.solve_sharded(blocks, bvecs, meshes[0], part.mode, num_epochs=120,
                                         x_ref=xs)
    assert x_b.shape == xs.shape and h_b["mse"].shape == (120, 4)
    assert float(h_b["mse"][-1].max()) < 1e-9
    for i in range(xs.shape[1]):
        x_i, _ = distributed.solve_sharded(blocks, bvecs[:, :, i], meshes[0], part.mode,
                                           num_epochs=120)
        np.testing.assert_allclose(x_b[:, i].numpy(), x_i.numpy(), atol=1e-5)


def test_bf16_delta_matches_reference_and_f32(meshes):
    part, xs = _system(k=4)
    blocks, bvecs = np.asarray(part.blocks), np.asarray(part.bvecs)
    x_c, h_c = distributed.solve_sharded(blocks, bvecs, meshes[0], part.mode, num_epochs=150,
                                         compress="bf16_delta", x_ref=xs)
    assert float(h_c["mse"][-1].max()) < 1e-9
    x_f, _ = distributed.solve_sharded(blocks, bvecs, meshes[0], part.mode, num_epochs=150)
    np.testing.assert_allclose(x_c.numpy(), x_f.numpy(), atol=1e-4)
    jx, _ = jdist.solve_sharded(part.blocks, part.bvecs, _jmesh(), part.mode, num_epochs=150,
                                compress="bf16_delta")
    np.testing.assert_allclose(x_c.numpy(), np.asarray(jx), atol=1e-4)


@pytest.mark.parametrize("k", [None, 4])
def test_straggler_consensus_converges(meshes, k):
    """30% of the block updates dropped per epoch: the η-EMA still
    converges, later than the synchronous run (the reference's gates)."""
    part, ref = _system(seed=6, k=k)
    blocks, bvecs = np.asarray(part.blocks), np.asarray(part.bvecs)
    _, hist = distributed.solve_sharded(blocks, bvecs, meshes[0], part.mode, num_epochs=250,
                                        straggler_prob=0.3, x_ref=ref)
    assert float(hist["mse"][-1].max()) < 1e-7
    _, h_sync = distributed.solve_sharded(blocks, bvecs, meshes[0], part.mode, num_epochs=250,
                                          x_ref=ref)
    assert float(h_sync["mse"][60].max()) <= float(hist["mse"][60].max()) * 1.01


class _Coords:
    """A mesh stand-in: axis names and this rank's coordinate."""

    def __init__(self, names, coord):
        self.mesh_dim_names, self._coord = names, coord

    def get_coordinate(self):
        return self._coord


def test_straggler_masks_decorrelated_across_mesh_axes():
    """Every axis index of ``block_axes`` enters the generator's seed: on a
    (pod, data) block mesh, shards sharing their first index still draw
    different drop patterns (the reference's regression)."""
    axes = ("pod", "data")
    masks = [
        distributed.straggler_masks(0, _Coords(axes, c), axes, 16, 1, 0.3).numpy().ravel()
        for c in [(0, 0), (0, 1), (1, 0), (1, 1)]
    ]
    for i in range(4):
        for j in range(i + 1, 4):
            assert not np.array_equal(masks[i], masks[j]), (i, j)
    again = distributed.straggler_masks(0, _Coords(axes, (0, 1)), axes, 16, 1, 0.3)
    np.testing.assert_array_equal(again.numpy().ravel(), masks[1])  # seeded


@pytest.mark.parametrize("k", [None, 4])
def test_solve_sharded_2d_matches_reference(meshes, k):
    part, xs = _system(k=k)
    blocks_t = np.swapaxes(np.asarray(part.blocks), 1, 2)
    bvecs = np.asarray(part.bvecs)
    x2, h2 = distributed.solve_sharded_2d(blocks_t, bvecs, meshes[1], num_epochs=120, x_ref=xs)
    jx, jh = jdist.solve_sharded_2d(jnp.asarray(blocks_t), part.bvecs,
                                    jax.make_mesh((1, 1), ("data", "model")), num_epochs=120,
                                    x_ref=jnp.asarray(xs))
    np.testing.assert_allclose(x2.numpy(), np.asarray(jx), atol=1e-4)
    assert h2["mse"].shape == np.asarray(jh["mse"]).shape
    assert float(h2["mse"][-1].max()) < 1e-9
    x1, _ = distributed.solve_sharded(np.asarray(part.blocks), bvecs, meshes[0], part.mode,
                                      num_epochs=120)
    np.testing.assert_allclose(x2.numpy(), x1.numpy(), atol=1e-4)
    if k is not None:  # batched: shared TSQR, per-column agreement
        for i in range(k):
            x_i, _ = distributed.solve_sharded_2d(blocks_t, bvecs[:, :, i], meshes[1],
                                                  num_epochs=120)
            np.testing.assert_allclose(x2[:, i].numpy(), x_i.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        distributed.solve_sharded_2d(blocks_t[:, :63], bvecs, _Mesh2(), num_epochs=1)


class _Mesh2:
    """A (1, 2) mesh stand-in, enough for the divisibility check."""

    mesh_dim_names = ("data", "model")
    device_type = "cpu"
    mesh = torch.arange(2).reshape(1, 2)

    def get_coordinate(self):
        return (0, 0)

    def size(self, dim=None):
        return (1, 2)[dim] if dim is not None else 2

    def get_group(self, axis):
        return None


@pytest.mark.parametrize("k", [None, 3])
def test_repartition_matches_reference(k):
    prob = make_problem(n=64, m=512, seed=8, dtype=np.float32)
    rhs = prob.b if k is None else prob.A @ np.random.default_rng(5).standard_normal(
        (64, k)).astype(np.float32)
    part = partition_system(prob.A, rhs, 8)
    want = jdist.repartition(part.blocks, part.bvecs, 4)
    for blocks, bvecs in ((np.asarray(part.blocks), np.asarray(part.bvecs)),
                          (torch.tensor(np.asarray(part.blocks)),
                           torch.tensor(np.asarray(part.bvecs)))):
        got = distributed.repartition(blocks, bvecs, 4)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    with pytest.raises(ValueError, match="not divisible"):
        distributed.repartition(np.asarray(part.blocks), np.asarray(part.bvecs), 3)


def test_repartitioned_system_solves(meshes):
    prob = make_problem(n=64, m=512, seed=8, dtype=np.float32)
    part = partition_system(prob.A, prob.b, 8)
    b2, v2 = distributed.repartition(np.asarray(part.blocks), np.asarray(part.bvecs), 4)
    assert b2.shape == (4, 128, 64) and v2.shape == (4, 128)
    _, hist = distributed.solve_sharded(b2, v2, meshes[0], "tall", num_epochs=5,
                                        x_ref=prob.x_true)
    assert float(hist["mse"][-1]) < 1e-6  # tall blocks: exact block solves
