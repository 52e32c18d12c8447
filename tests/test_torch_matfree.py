"""The port's matrix-free prepared solve against the JAX package's.

Most tests carry the reference's prepared state across —
``MatrixFreePreparedSolver.from_state(reference.to_state())`` — so both
packages solve from the same operator bytes; others prepare independently,
which must give the same layout bit for bit (it is built by the same numpy
code). Solutions agree at 1e-4, early ``residual_sq`` epochs tightly, the
whole history at the float32 paths' mid-convergence agreement, and the
per-epoch inner-CG depths exactly. The reference's kernel path runs as its
own tests run it, Pallas in interpret mode on the CPU; the port's kernel
wrappers take their plain versions here.

Small sizes: the reference's own matfree fixture, n = m = 96 at 95%
sparsity, J = 8 (p = 12, p_pad = 16).
"""
import json
import sys

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.matfree import MatrixFreePreparedSolver as JMatfree
from repro.sparse import make_problem
from repro_torch.core import PreparedSolver, prepare, solve
from repro_torch.core import matfree
from repro_torch.core.matfree import MatrixFreePreparedSolver, prepare_matfree
from repro_torch.sparse import generate_schenk_like
from repro_torch.sparse.matrix import COOMatrix

from test_torch_dapc import _floor, _hist_close
from test_torch_dapc_options import _clear_tol

N, K, J = 96, 3, 8
EPOCHS = 30


@pytest.fixture(scope="module")
def problem():
    prob = make_problem(n=N, m=N, sparsity=0.95, seed=3, dtype=np.float32)
    xs = np.random.default_rng(17).standard_normal((N, K)).astype(np.float32)
    coo = COOMatrix(prob.coo.rows, prob.coo.cols, prob.coo.vals, prob.coo.shape)
    return prob, coo, prob.A @ xs, xs


def _carried(prob, **kw):
    """(reference solver, port solver rebuilt from its state on the CPU)."""
    ref = jcore.prepare(prob.coo, mode="matfree", num_blocks=J, **kw)
    assert isinstance(ref, JMatfree)
    return ref, MatrixFreePreparedSolver.from_state(*ref.to_state(), device="cpu")


def _agree(got, want, b):
    assert got.x.shape == want.x.shape and got.x.dtype == want.x.dtype
    np.testing.assert_allclose(got.x, want.x, atol=1e-4)
    _hist_close(got, want, _floor(b))
    np.testing.assert_array_equal(got.history["inner_iters"], want.history["inner_iters"])
    for key in want.history["initial"]:
        np.testing.assert_allclose(got.history["initial"][key], want.history["initial"][key],
                                   rtol=1e-4, atol=_floor(b))
    assert sorted(got.history) == sorted(want.history)
    assert (got.mode, got.num_blocks, got.num_epochs, got.num_rhs) == (
        want.mode, want.num_blocks, want.num_epochs, want.num_rhs)


CASES = [  # (gram_solver, use_kernels, batched)
    ("direct", False, True), ("direct", False, False), ("pcg", False, True),
    ("pcg", False, False), ("direct", True, True), ("pcg", True, True),
]


@pytest.mark.parametrize("gram_solver,use_kernels,batched", CASES)
def test_carried_solve_matches_reference(problem, gram_solver, use_kernels, batched):
    prob, _, B, xs = problem
    b, x_ref = (B, xs) if batched else (prob.b, prob.x_true)
    ref, port = _carried(prob, gram_solver=gram_solver, use_kernels=use_kernels,
                         gamma=2.0, eta=1.9)
    assert (port.gram_solver, port.use_kernels) == (gram_solver, use_kernels)
    assert port.memory_bytes == ref.memory_bytes
    assert port.dense_memory_bytes == ref.dense_memory_bytes
    got = port.solve(b, num_epochs=EPOCHS, x_ref=x_ref)
    want = ref.solve(b, num_epochs=EPOCHS, x_ref=x_ref)
    _agree(got, want, b)
    _hist_close(got, want, 1e-9, key="mse")
    assert got.x.shape == ((N, K) if batched else (N,))


@pytest.mark.parametrize("gram_solver", ["direct", "pcg"])
def test_own_prepare_matches_reference(problem, gram_solver):
    """An independent port prepare builds the reference's state: layout and
    Gram inverses bit for bit, Jacobi weights to float32 rounding."""
    prob, coo, B, xs = problem
    ref = jcore.prepare(prob.coo, mode="matfree", num_blocks=J, gram_solver=gram_solver,
                        use_kernels=True)
    port = prepare(coo, mode="matfree", num_blocks=J, gram_solver=gram_solver,
                   use_kernels=True, device="cpu")
    assert isinstance(port, MatrixFreePreparedSolver) and port.path == port.mode == "matfree"
    (ra, rm), (pa, pm) = ref.to_state(), port.to_state()
    assert sorted(ra) == sorted(pa)
    rm.pop("setup_seconds"), pm.pop("setup_seconds")
    assert rm == pm
    for key in ra:
        if key == "diag_inv":
            np.testing.assert_allclose(pa[key], ra[key], rtol=1e-6)
        else:
            np.testing.assert_array_equal(pa[key], ra[key], err_msg=key)
    assert port.memory_bytes == ref.memory_bytes
    got, want = port.solve(B, num_epochs=EPOCHS, x_ref=xs), ref.solve(B, num_epochs=EPOCHS, x_ref=xs)
    np.testing.assert_allclose(got.x, want.x, atol=1e-4)
    _hist_close(got, want, _floor(B))


@pytest.mark.parametrize("gram_solver", ["direct", "pcg"])
def test_tol_freeze_and_iterations_to_tol(problem, gram_solver):
    prob, _, B, _ = problem
    ref, port = _carried(prob, gram_solver=gram_solver, gamma=2.0, eta=1.9)
    tol = _clear_tol(ref.solve(B, num_epochs=EPOCHS).history["residual_sq"])
    got = port.solve(B, num_epochs=EPOCHS, tol=tol)
    want = ref.solve(B, num_epochs=EPOCHS, tol=tol)
    _agree(got, want, B)
    np.testing.assert_array_equal(got.iterations_to_tol(tol), want.iterations_to_tol(tol))
    assert got.iterations_to_tol(tol).min() < EPOCHS  # some column froze
    for g, w in zip(got.per_column(tol=tol), want.per_column(tol=tol)):
        assert (g.index, g.iterations, g.converged) == (w.index, w.iterations, w.converged)


@pytest.mark.parametrize("gram_solver", ["direct", "pcg"])
def test_warm_starts(problem, gram_solver):
    prob, _, B, xs = problem
    ref, port = _carried(prob, gram_solver=gram_solver, warm_start=gram_solver == "pcg")
    x0 = (xs + 0.01 * np.random.default_rng(2).standard_normal(xs.shape)).astype(np.float32)
    mask = np.array([True, False, True])
    for warm in ((x0, mask), x0):
        _agree(port.solve(B, num_epochs=EPOCHS, x_ref=xs, x0=warm),
               ref.solve(B, num_epochs=EPOCHS, x_ref=xs, x0=warm), B)
    _agree(port.solve(prob.b, num_epochs=EPOCHS, x0=x0[:, 0]),
           ref.solve(prob.b, num_epochs=EPOCHS, x0=x0[:, 0]), prob.b)


def test_block_history(problem):
    prob, _, B, _ = problem
    ref, port = _carried(prob, gram_solver="pcg")
    got = port.solve(B, num_epochs=EPOCHS, block_history=True)
    want = ref.solve(B, num_epochs=EPOCHS, block_history=True)
    _agree(got, want, B)
    assert got.history["block_residual_sq"].shape == (EPOCHS, J, K)
    _hist_close(got, want, _floor(B), key="block_residual_sq")


def _skewed(m=160, n=160, seed=0):
    rng = np.random.default_rng(seed)
    dense = np.zeros((m, n), np.float32)
    for i in range(m):  # light rows and heavy rows: a skewed system
        cols = rng.choice(n, size=2 if i < 100 else 12, replace=False)
        dense[i, cols] = rng.standard_normal(cols.size)
        dense[i, i] = 4.0 + rng.random()
    return dense


@pytest.mark.parametrize("gram_solver", ["direct", "pcg"])
def test_per_block_dynamics_cost_aware(gram_solver):
    dense = _skewed()
    coo = COOMatrix.from_dense(dense)
    rng = np.random.default_rng(1)
    x_true = rng.standard_normal((160, 2)).astype(np.float32)
    b = dense @ x_true
    kw = dict(mode="matfree", num_blocks=4, partition="cost_aware", dynamics="per_block",
              gram_solver=gram_solver)
    ref = jcore.prepare(dense, **kw)
    port = MatrixFreePreparedSolver.from_state(*ref.to_state(), device="cpu")
    assert port.partition == "cost_aware" and port.dynamics == "per_block"
    np.testing.assert_array_equal(port.plan.assignment, ref.plan.assignment)
    got, want = port.solve(b, num_epochs=EPOCHS, x_ref=x_true), ref.solve(b, num_epochs=EPOCHS, x_ref=x_true)
    _agree(got, want, b)
    for dyn in ("global", "per_block"):
        _agree(port.solve(b, num_epochs=EPOCHS, dynamics=dyn), ref.solve(b, num_epochs=EPOCHS, dynamics=dyn), b)
    # the port's own prepare makes the same plan, layout and weights
    own = prepare(coo, device="cpu", **kw)
    np.testing.assert_array_equal(own.plan.assignment, ref.plan.assignment)
    np.testing.assert_array_equal(own.op.fwd_data.numpy(), np.asarray(ref.op.fwd_data))
    np.testing.assert_allclose(own.block_eta_weights, ref.block_eta_weights, rtol=1e-5)
    for key in ("lam_max", "trace", "rows", "stable_rank"):
        np.testing.assert_allclose(own.block_spectra[key], ref.block_spectra[key], rtol=1e-5)
    np.testing.assert_allclose(own.solve(b, num_epochs=EPOCHS).x, want.x, atol=1e-4)
    with pytest.raises(ValueError, match="per_block"):
        prepare(coo, mode="matfree", num_blocks=4, device="cpu").solve(b, 2, dynamics="per_block")


def test_state_round_trips(problem):
    prob, coo, B, xs = problem
    port = prepare(coo, mode="matfree", num_blocks=J, gram_solver="pcg", device="cpu")
    arrays, meta = port.to_state()
    # the port's state restores in the reference and solves to its answer
    ref = JMatfree.from_state(arrays, meta)
    _agree(port.solve(B, num_epochs=EPOCHS), ref.solve(B, num_epochs=EPOCHS), B)
    # and in the port, bit for bit on the CPU
    again = MatrixFreePreparedSolver.from_state(arrays, meta, device="cpu")
    a, b = again.solve(B, num_epochs=EPOCHS, x_ref=xs), port.solve(B, num_epochs=EPOCHS, x_ref=xs)
    np.testing.assert_array_equal(a.x, b.x)
    for key in ("residual_sq", "inner_iters", "mse"):
        np.testing.assert_array_equal(a.history[key], b.history[key])
    # the dense solver refuses a matrix-free state and names the right class
    with pytest.raises(ValueError, match="MatrixFreePreparedSolver.from_state"):
        PreparedSolver.from_state(arrays, meta, device="cpu")


def test_routing():
    coo = generate_schenk_like(256, sparsity=0.9985, seed=1)
    prep = prepare(coo, mode="auto", num_blocks=8, matfree_threshold_bytes=0, device="cpu")
    assert isinstance(prep, MatrixFreePreparedSolver) and prep.path == "matfree"
    assert isinstance(prepare(coo, mode="auto", num_blocks=8, device="cpu"), PreparedSolver)
    assert prep.memory_bytes * 5 < prepare(coo, mode="dense", num_blocks=8, device="cpu").memory_bytes
    for method in ("dgd", "cgnr"):
        # auto keeps dgd/cgnr on the dense path, which is not ported yet
        with pytest.raises(NotImplementedError, match="baselines"):
            prepare(coo, method=method, mode="auto", num_blocks=8, matfree_threshold_bytes=0,
                    device="cpu")
        with pytest.raises(ValueError, match="consensus"):
            prepare(coo, method=method, mode="matfree", num_blocks=8, device="cpu")
        with pytest.raises(ValueError, match="consensus"):
            prepare_matfree(coo, method=method, device="cpu")
    with pytest.raises(ValueError, match="gram_solver"):
        prepare_matfree(coo, gram_solver="lu", device="cpu")


def test_one_shot_solve_threads_matfree_options(problem):
    prob, coo, B, xs = problem
    kw = dict(mode="matfree", num_blocks=J, num_epochs=EPOCHS, gram_solver="pcg", inner_iters=3,
              x_ref=xs)
    got = solve(coo, B, device="cpu", **kw)
    want = jcore.solve(prob.coo, B, **kw)
    assert got.mode == "matfree"
    assert np.asarray(got.history["inner_iters"]).max() <= 3
    _agree(got, want, B)
    assert got.wall_seconds > 0


def test_launch_solve_matches_reference(monkeypatch, capsys):
    from repro.launch import solve as jlaunch
    from repro_torch.launch import solve as tlaunch

    argv = ["--n", "96", "--m", "96", "--blocks", "8", "--epochs", "25", "--rhs", "3",
            "--mode", "matfree", "--kernels", "--gamma", "2.0", "--eta", "1.9"]
    got = tlaunch.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["solve"] + argv)
    jlaunch.main()
    want = json.loads(capsys.readouterr().out)
    assert got["device"] == "cpu" and got["path"] == "matfree"
    for key in ("method", "mode", "blocks", "epochs", "num_rhs", "path"):
        assert got[key] == want[key]
    for key in ("initial_mse", "final_mse_max", "final_residual_sq_max"):
        assert got[key] == pytest.approx(want[key], rel=2e-2, abs=1e-9)


def test_float64_and_host_syncs(problem):
    """An explicit float64 is honoured; the direct Gram solver reads nothing
    back from the device during a solve, the PCG one reads its stopping
    test once per iteration."""
    prob, coo, B, xs = problem
    B64 = prob.coo.to_dense().astype(np.float64) @ xs.astype(np.float64)
    port = prepare(coo, mode="matfree", num_blocks=J, dtype=torch.float64, device="cpu",
                   gamma=2.0, eta=1.9)
    assert port.op.fwd_data.dtype == port.gram_inv.dtype == torch.float64
    before = matfree.host_syncs
    res = port.solve(B64, num_epochs=EPOCHS, x_ref=xs)
    assert matfree.host_syncs == before
    with jax.enable_x64(True):  # the reference's explicit float64
        ref = jcore.prepare(prob.coo, mode="matfree", num_blocks=J, dtype=np.float64,
                            gamma=2.0, eta=1.9)
        want = ref.solve(B64, num_epochs=EPOCHS, x_ref=xs)
    assert res.x.dtype == want.x.dtype == np.float64
    np.testing.assert_allclose(res.x, want.x, atol=1e-9)
    np.testing.assert_allclose(res.history["residual_sq"], want.history["residual_sq"], rtol=1e-8)
    pcg = prepare(coo, mode="matfree", num_blocks=J, gram_solver="pcg", device="cpu")
    res = pcg.solve(B, num_epochs=5)
    depth = int(np.asarray(res.history["inner_iters"]).max())
    assert matfree.host_syncs - before >= 5 * depth


def test_stubs_of_later_slices(problem):
    prob, coo, _, _ = problem
    port = prepare(coo, mode="matfree", num_blocks=J, device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        port.open_session()
    with pytest.raises(NotImplementedError, match="item 8"):
        prepare_matfree(coo, mesh=object(), device="cpu")
