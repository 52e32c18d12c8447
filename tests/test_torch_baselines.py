"""The port's DGD and CGNR baselines against the JAX package.

The same numpy-seeded system goes through both packages. CGNR squares the
condition number, so float32 rounding grows fast along its trajectory: the
histories are held at 1e-4 over the first 10 epochs (measured: ≤ 6e-5 at
n = 96) and the solutions at the reference's own gate
(``tests/test_core_solvers.py``: mse < 1e-10 and atol 1e-4 at 150 epochs).
DGD's histories agree at 1e-4 over every epoch once both run one step size.

The step size is the hazard: the reference starts its power iteration at
``jax.random.normal(PRNGKey(0))``, which torch cannot draw, so the port
starts at a ``torch.Generator`` vector. Fed the reference's start vector,
the port's iteration agrees to 1e-6; from its own vector, 30 steps leave
λ_max within 1% at n = 96 (measured 0.57%; 2.1% at the paper's Table 1
shape, 3.6% at n = 48, and 11% at the command line's n = 64, m = 256
problem, where the top two eigenvalues of AᵀA lie 13% apart and the port's
start vector is nearly orthogonal to the top one). So carried-state solves
bring the step size across through ``from_state(repro to_state())``, and
the command-line records are compared from one start vector.

Small size: ``tests/test_core_solvers.py``'s wide problem, n = 96,
m = 384, J = 8 (p = 48 < n).
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import cg as jcg
from repro.core import dgd as jdgd
from repro.core import partition_system as jpartition_system
from repro.sparse import make_problem
from repro_torch.core import PreparedSolver, cg, dgd, prepare
from repro_torch.core.partition import partition_system

from test_torch_session import one_torch_thread  # noqa: F401  (autouse)

N, M, J, K = 96, 384, 8, 4
METHODS = ("dgd", "cgnr")


@pytest.fixture(scope="module")
def problem():
    prob = make_problem(n=N, m=M, seed=3, dtype=np.float32)
    xs = np.random.default_rng(5).standard_normal((N, K)).astype(np.float32)
    return prob, prob.A @ xs, xs


@pytest.fixture(scope="module")
def partitions(problem):
    prob, _, _ = problem
    return (jpartition_system(prob.A, prob.b, J),
            partition_system(prob.A, prob.b, J, device="cpu"))


def _reference_start(n, seed=0):
    """The reference's power-iteration start vector, as numpy."""
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (n,), jnp.float32))


def test_power_iteration_matches_reference_from_its_start(partitions):
    jpart, tpart = partitions
    want = float(jdgd.estimate_lipschitz(jpart.blocks))
    got = float(dgd.power_iteration(tpart.blocks, torch.from_numpy(_reference_start(N))))
    assert got == pytest.approx(want, rel=1e-6)


def test_independent_step_size_within_stated_tolerance(problem):
    prob, _, _ = problem
    want = jcore.prepare(prob.A, method="dgd", num_blocks=J).factors[0]
    got = prepare(prob.A, method="dgd", num_blocks=J, device="cpu").factors[0]
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=1e-2)
    # both are 1 / (a lower bound of λ_max): never a step past 1/λ_max
    lam = np.linalg.eigvalsh(prob.A.astype(np.float64).T @ prob.A.astype(np.float64))[-1]
    assert got * lam >= 1 - 1e-5 and want * lam >= 1 - 1e-5
    # the start vector comes from the host generator: the same on any device
    blocks = partition_system(prob.A, prob.b, J, device="cpu").blocks
    assert float(dgd.estimate_lipschitz(blocks)) == float(dgd.estimate_lipschitz(blocks.clone()))


def _hist(h, key):
    return np.asarray(h[key])


def test_dgd_matches_reference(problem, partitions):
    prob, _, _ = problem
    jpart, tpart = partitions
    lr = jcore.prepare(prob.A, method="dgd", num_blocks=J).factors[0]
    xj, hj = jdgd.solve_dgd(jpart, lr=lr, num_epochs=80, x_ref=jnp.asarray(prob.x_true))
    xt, ht = dgd.solve_dgd(tpart, lr=lr, num_epochs=80, x_ref=torch.from_numpy(prob.x_true))
    for key in ("mse", "residual_sq"):
        assert ht[key].shape == (80,)
        np.testing.assert_allclose(_hist(ht, key), _hist(hj, key), rtol=1e-4)
        np.testing.assert_allclose(_hist(ht["initial"], key), _hist(hj["initial"], key), rtol=1e-6)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-4)
    # paper Fig. 2: DGD decays far slower than the consensus methods
    apc = prepare(prob.A, method="apc", num_blocks=J, device="cpu")
    fast = apc.solve(prob.b, num_epochs=80, x_ref=prob.x_true)
    assert float(ht["mse"][-1]) > fast.final_mse * 1e3


def test_cgnr_matches_reference(problem, partitions):
    prob, _, _ = problem
    jpart, tpart = partitions
    xj, hj = jcg.solve_cgnr(jpart, num_epochs=150, x_ref=jnp.asarray(prob.x_true))
    xt, ht = cg.solve_cgnr(tpart, num_epochs=150, x_ref=torch.from_numpy(prob.x_true))
    for key in ("mse", "residual_sq"):
        assert ht[key].shape == (150,)
        np.testing.assert_allclose(_hist(ht, key)[:10], _hist(hj, key)[:10], rtol=1e-4)
        np.testing.assert_allclose(_hist(ht["initial"], key), _hist(hj["initial"], key), rtol=1e-6)
    # the reference's own gate, held by both
    for x, h in ((xt.numpy(), ht), (np.asarray(xj), hj)):
        assert float(h["mse"][-1]) < 1e-10
        np.testing.assert_allclose(x, prob.x_true, atol=1e-4)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-4)


@pytest.mark.parametrize("method", METHODS)
def test_carried_state_solve_matches_reference(problem, method):
    prob, B, xs = problem
    ref = jcore.prepare(prob.A, method=method, num_blocks=J)
    arrays, meta = ref.to_state()
    port = PreparedSolver.from_state(arrays, meta, device="cpu")
    assert port.factors == tuple(ref.factors)  # dgd: the step size, as a float
    # cgnr: every epoch of a 10-epoch solve is early, the history held over 5
    epochs, early = (80, 80) if method == "dgd" else (10, 5)
    want = ref.solve(B, num_epochs=epochs, x_ref=xs)
    got = port.solve(B, num_epochs=epochs, x_ref=xs)
    assert (got.method, got.mode, got.num_rhs, got.gamma, got.eta) == (method, want.mode, K, None, None)
    assert want.gamma is None and want.eta is None
    np.testing.assert_allclose(got.x, want.x, atol=1e-4)
    for key in ("mse", "residual_sq"):
        assert got.history[key].shape == (epochs, K)
        np.testing.assert_allclose(got.history[key][:early], want.history[key][:early], rtol=1e-4)


@pytest.mark.parametrize("method", METHODS)
def test_state_round_trip_inside_the_port(problem, method):
    prob, B, _ = problem
    prep = prepare(prob.A, method=method, num_blocks=J, device="cpu")
    arrays, meta = prep.to_state()
    if method == "dgd":
        assert meta["factors"] == [{"kind": "scalar", "value": prep.factors[0]}]
    else:
        assert meta["factors"] == [] and meta["projector"] is None
    back = PreparedSolver.from_state(arrays, meta, device="cpu")
    a, b = prep.solve(B, num_epochs=40), back.solve(B, num_epochs=40)
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.history["residual_sq"], b.history["residual_sq"])
    # the port's state restores in the reference too
    jback = jcore.PreparedSolver.from_state(arrays, meta)
    np.testing.assert_allclose(jback.solve(B, num_epochs=10).x, prep.solve(B, num_epochs=10).x,
                               atol=1e-4)


@pytest.mark.parametrize("method", METHODS)
def test_batched_matches_per_column(problem, method):
    prob, B, xs = problem
    prep = prepare(prob.A, method=method, num_blocks=J, device="cpu")
    batched = prep.solve(B, num_epochs=120)
    assert batched.x.shape == xs.shape and batched.num_rhs == K
    cols = np.stack([prep.solve(B[:, i], num_epochs=120).x for i in range(K)], axis=1)
    scale = np.abs(cols).max() + 1e-30
    assert float(np.abs(batched.x - cols).max() / scale) <= 1e-5
    assert np.asarray(batched.history["residual_sq"]).shape == (120, K)


@pytest.mark.parametrize("method", METHODS)
def test_warm_start_and_sessions_need_a_consensus_method(problem, method):
    prob, _, _ = problem
    prep = prepare(prob.A, method=method, num_blocks=J, device="cpu")
    with pytest.raises(ValueError, match="consensus"):
        prep.solve(prob.b, num_epochs=5, x0=np.zeros(N, np.float32))
    with pytest.raises(ValueError, match="consensus"):
        prep.open_session()
    with pytest.raises(ValueError, match="matfree"):
        prepare(prob.A, method=method, mode="matfree", device="cpu")


def test_cgnr_tol_has_no_effect(problem):
    """As in the reference, ``solve_cgnr`` accepts ``tol`` and never reads
    it: every solve runs its full epoch count."""
    prob, B, _ = problem
    prep = prepare(prob.A, method="cgnr", num_blocks=J, device="cpu")
    plain = prep.solve(B, num_epochs=30)
    for tol in (1e-3, 1e3):
        got = prep.solve(B, num_epochs=30, tol=tol)
        np.testing.assert_array_equal(got.x, plain.x)
        np.testing.assert_array_equal(got.history["residual_sq"], plain.history["residual_sq"])


def test_one_shot_solve_forwards_lr(problem):
    from repro_torch.core import solve

    prob, B, _ = problem
    lr = jcore.prepare(prob.A, method="dgd", num_blocks=J).factors[0]
    got = solve(prob.A, B, method="dgd", num_blocks=J, num_epochs=20, lr=lr, device="cpu")
    want = jcore.solve(prob.A, B, method="dgd", num_blocks=J, num_epochs=20, lr=lr)
    np.testing.assert_allclose(got.history["residual_sq"], want.history["residual_sq"], rtol=1e-4)


LAUNCH = ["--n", "64", "--m", "256", "--blocks", "8", "--rhs", "4"]


def _records(monkeypatch, capsys, argv):
    from repro.launch import solve as jlaunch
    from repro_torch.launch import solve as tlaunch

    got = tlaunch.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["solve"] + argv)
    jlaunch.main()
    want = json.loads(capsys.readouterr().out)
    assert got["device"] == "cpu" and got["path"] == "dense"
    for key in ("method", "mode", "blocks", "epochs", "num_rhs", "path", "initial_mse"):
        assert got[key] == want[key]
    return got, want


@pytest.mark.parametrize("method,epochs", [("cgnr", 10), ("dgd", 40)])
def test_launch_solve_matches_reference(monkeypatch, capsys, method, epochs):
    """The records agree to 1e-4 when both packages start the power
    iteration from the same vector (cgnr has no power iteration); cgnr is
    held over its first 10 epochs, before κ² amplifies float32 rounding."""
    argv = LAUNCH + ["--method", method, "--epochs", str(epochs)]
    if method == "dgd":
        start = _reference_start(64)
        monkeypatch.setattr(
            dgd, "estimate_lipschitz",
            lambda blocks, iters=30, seed=0: dgd.power_iteration(blocks, torch.from_numpy(start), iters),
        )
    got, want = _records(monkeypatch, capsys, argv)
    for key in ("final_mse_max", "final_residual_sq_max"):
        assert got[key] == pytest.approx(want[key], rel=1e-4)
