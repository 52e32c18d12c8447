"""The port's dense prepared DAPC solve against the JAX package: the solve
options (``tol`` freeze, ``block_history``, ``avg_every``, ``bf16_delta``,
per-block dynamics, masked warm starts), classical APC, hyperparameter
tuning, the one-shot ``solve`` and the ``launch.solve`` command line.

Factors are carried across from the reference (``from_state``), as in
``test_torch_dapc.py``, whose fixture and helpers this file shares. The
options act on the consensus loop, which is the same code whichever
projector it calls, so these solves take the implicit projector: the
kernels path is held against the reference in ``test_torch_dapc.py``.
"""
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import consensus as jconsensus
from repro.core import dapc as jdapc
from repro_torch.core import consensus, dapc, prepare, solve
from repro_torch.sparse.matrix import COOMatrix

# the shared problem fixture and comparison helpers
from test_torch_dapc import EPOCHS, K, M, REGIMES, _agree, _carried, _floor, _hist_close, problem  # noqa: F401


def _clear_tol(trace):
    """A tolerance whose square lies between two epochs of column 0's
    residual and as far as it can from every value of every column (in
    log scale), so that float32 noise flips no crossing. A flat trace (the
    tall regime starts at the solution) gets one above it: every column
    freezes at once."""
    logs = np.log(np.asarray(trace, np.float64))
    cands = (logs[:-1, 0] + logs[1:, 0]) / 2
    margin = [np.abs(logs - c).min() for c in cands]
    if max(margin) < 1e-2:
        return float(np.sqrt(10 * np.max(trace)))
    return float(np.exp(cands[int(np.argmax(margin))] / 2))


@pytest.mark.parametrize("regime", list(REGIMES))
def test_tol_freeze_and_iterations_to_tol(problem, regime):
    prob, B, xs = problem
    ref, port = _carried(prob.A, num_blocks=REGIMES[regime], materialize_p=False)
    tol = _clear_tol(ref.solve(B, num_epochs=EPOCHS).history["residual_sq"])
    got = port.solve(B, num_epochs=EPOCHS, tol=tol)
    want = ref.solve(B, num_epochs=EPOCHS, tol=tol)
    _agree(got, want, B)
    np.testing.assert_array_equal(got.iterations_to_tol(tol), want.iterations_to_tol(tol))
    for g, w in zip(got.per_column(tol=tol), want.per_column(tol=tol)):
        assert (g.index, g.iterations, g.converged) == (w.index, w.iterations, w.converged)
        np.testing.assert_allclose(g.x, w.x, atol=1e-4)


@pytest.mark.parametrize("regime", list(REGIMES))
def test_block_history(problem, regime):
    prob, B, _ = problem
    ref, port = _carried(prob.A, num_blocks=REGIMES[regime], materialize_p=False)
    got = port.solve(B, num_epochs=EPOCHS, block_history=True)
    want = ref.solve(B, num_epochs=EPOCHS, block_history=True)
    _agree(got, want, B)
    assert got.history["block_residual_sq"].shape == (EPOCHS, REGIMES[regime], K)
    _hist_close(got, want, _floor(B), key="block_residual_sq")


@pytest.mark.parametrize("kw", [{"avg_every": 3}, {"compress": "bf16_delta"}])
def test_method_kwargs(problem, kw):
    prob, B, xs = problem
    ref, port = _carried(prob.A, num_blocks=8, materialize_p=False)
    got = port.solve(B, num_epochs=EPOCHS, x_ref=xs, **kw)
    want = ref.solve(B, num_epochs=EPOCHS, x_ref=xs, **kw)
    np.testing.assert_allclose(got.x, want.x, atol=1e-4)
    if "compress" in kw:
        # bf16 rounds at other places in the two frameworks: hold the port
        # to the reference's own gate (tests/test_core_solvers.py)
        plain = ref.solve(B, num_epochs=EPOCHS, x_ref=xs)
        assert np.all(got.final_mse < 5 * plain.final_mse + 1e-12)
    else:
        _hist_close(got, want, _floor(B))


def test_per_block_dynamics_cost_aware(problem):
    rng = np.random.default_rng(0)
    m, n = 160, 40
    dense = np.zeros((m, n), np.float32)
    for i in range(m):  # light rows and heavy rows: a skewed system
        cols = rng.choice(n, size=3 if i < 100 else 20, replace=False)
        dense[i, cols] = rng.standard_normal(cols.size)
    coo = COOMatrix.from_dense(dense)
    x_true = rng.standard_normal(n).astype(np.float32)
    b = dense @ x_true
    ref, port = _carried(dense, num_blocks=4, partition="cost_aware", dynamics="per_block",
                         materialize_p=False)
    np.testing.assert_array_equal(port.plan.assignment, ref.plan.assignment)
    np.testing.assert_array_equal(port.block_eta_weights, ref.block_eta_weights)
    got = port.solve(b, num_epochs=EPOCHS, x_ref=x_true)
    want = ref.solve(b, num_epochs=EPOCHS, x_ref=x_true)
    _agree(got, want, b)
    # the port's own prepare makes the same plan and weights from a COO
    own = prepare(coo, num_blocks=4, mode="dense", partition="cost_aware",
                  dynamics="per_block", device="cpu")
    np.testing.assert_array_equal(own.plan.assignment, ref.plan.assignment)
    np.testing.assert_allclose(own.block_eta_weights, ref.block_eta_weights, rtol=1e-5)
    with pytest.raises(ValueError, match="per_block"):
        prepare(dense, num_blocks=4, device="cpu").solve(b, num_epochs=2, dynamics="per_block")


def test_masked_warm_start(problem):
    prob, B, xs = problem
    ref, port = _carried(prob.A, num_blocks=8, materialize_p=False)
    x0 = (xs + 0.01 * np.random.default_rng(2).standard_normal(xs.shape)).astype(np.float32)
    mask = np.array([True, False, True])
    for warm in ((x0, mask), x0):
        got = port.solve(B, num_epochs=EPOCHS, x_ref=xs, x0=warm)
        want = ref.solve(B, num_epochs=EPOCHS, x_ref=xs, x0=warm)
        _agree(got, want, B)


@pytest.mark.parametrize("regime", list(REGIMES))
def test_apc_carried(problem, regime):
    prob, B, xs = problem
    ref, port = _carried(prob.A, method="apc", num_blocks=REGIMES[regime])
    assert port.projector[0] == "dense" and port.projector[1] is port.factors[1]
    _agree(port.solve(B, num_epochs=EPOCHS, x_ref=xs), ref.solve(B, num_epochs=EPOCHS, x_ref=xs), B)


def test_tune_hyperparams_matches_reference(problem):
    prob, B, _ = problem
    ref, port = _carried(prob.A, num_blocks=8, materialize_p=False)
    Wj, Rj = ref.factors
    Wt, Rt = port.factors
    grid = dict(gammas=[0.5, 1.0, 1.5], etas=[0.5, 0.9, 0.99], probe_epochs=12)
    plan = jcore.PartitionPlan.uniform(M, 8)

    def both(b):
        bv = ref.mixer.apply(b).astype(np.float32)
        x0j = jdapc.initial_from_factors(Wj, Rj, jnp.asarray(bv), "wide")
        x0t = dapc.initial_from_factors(Wt, Rt, torch.from_numpy(bv), "wide")
        return ((x0j, jdapc.make_apply(Wj, False), ref.blocks, jnp.asarray(bv)),
                (x0t, dapc.make_apply(Wt, False), port.blocks, torch.from_numpy(bv)))

    jargs, targs = both(prob.b)  # one RHS: the reference's own use
    jgrid = {**grid, "gammas": jnp.asarray(grid["gammas"]), "etas": jnp.asarray(grid["etas"])}
    assert consensus.tune_hyperparams(*targs, **grid) == pytest.approx(
        jconsensus.tune_hyperparams(*jargs, **jgrid))
    *got, rates_t = consensus.tune_hyperparams(*targs, **grid, plan=plan)
    *want, rates_j = jconsensus.tune_hyperparams(*jargs, **jgrid, plan=plan)
    assert got == pytest.approx(want)
    np.testing.assert_allclose(rates_t.numpy(), np.asarray(rates_j), rtol=1e-3)

    jargs, targs = both(B)  # a batch: per-block candidates, per-column scores
    cand = np.array([[0.8] * 8, np.linspace(0.5, 1.5, 8)], np.float32)
    s_j, h_j = jconsensus.evaluate_candidates(
        *jargs, jnp.asarray(cand), jnp.asarray(cand[::-1]), 10, block_history=True)
    s_t, h_t = consensus.evaluate_candidates(
        *targs, torch.from_numpy(cand), torch.from_numpy(cand[::-1].copy()), 10, block_history=True)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=2e-3)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=2e-3)
    # a batched probe picks the candidate with the least summed residual
    scores, _ = consensus.evaluate_candidates(
        *targs, torch.tensor([0.5, 1.0]), torch.tensor([0.9, 0.9]), 12)
    best = [0.5, 1.0][int(scores.sum(dim=1).argmin())]
    assert consensus.tune_hyperparams(*targs, [0.5, 1.0], [0.9], 12) == pytest.approx((best, 0.9))


def test_one_shot_solve_matches_reference(problem):
    prob, B, xs = problem
    kw = dict(method="dapc", num_blocks=8, num_epochs=EPOCHS, x_ref=xs, materialize_p=False,
              use_kernels=True, tol=1e-3)
    got = solve(prob.A, B, device="cpu", **kw)
    want = jcore.solve(prob.A, B, **kw)
    np.testing.assert_allclose(got.x, want.x, atol=1e-4)
    np.testing.assert_array_equal(got.iterations_to_tol(1e-3), want.iterations_to_tol(1e-3))
    assert got.wall_seconds > 0


def test_launch_solve_matches_reference(monkeypatch, capsys):
    from repro.launch import solve as jlaunch
    from repro_torch.launch import solve as tlaunch

    argv = ["--n", "32", "--m", "128", "--blocks", "8", "--epochs", "25", "--rhs", "3",
            "--implicit-p", "--kernels"]
    got = tlaunch.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["solve"] + argv)
    jlaunch.main()
    want = json.loads(capsys.readouterr().out)
    assert got["device"] == "cpu"
    for key in ("method", "mode", "blocks", "epochs", "num_rhs", "path"):
        assert got[key] == want[key]
    for key in ("initial_mse", "final_mse_max", "final_residual_sq_max"):
        assert got[key] == pytest.approx(want[key], rel=2e-2, abs=1e-9)


@pytest.mark.parametrize("method", ["dapc", "apc"])
def test_partition_level_solvers_match_reference(problem, method):
    """``solve_dapc``/``solve_apc`` on a ``Partition`` (each package runs
    its own setup; the solutions and residuals must agree)."""
    from repro.core import apc as japc
    from repro.core import partition_system as jpartition_system
    from repro_torch.core import apc, partition_system

    prob, B, xs = problem
    jp = jpartition_system(prob.A, B, 8)
    tp = partition_system(prob.A, B, 8, device="cpu")
    if method == "dapc":
        kw = dict(materialize_p=False, use_kernels=True)
        x_j, h_j = jdapc.solve_dapc(jp, 1.0, 0.9, 20, x_ref=jnp.asarray(xs), **kw)
        x_t, h_t = dapc.solve_dapc(tp, 1.0, 0.9, 20, x_ref=torch.from_numpy(xs), **kw)
    else:
        x_j, h_j = japc.solve_apc(jp, 1.0, 0.9, 20, x_ref=jnp.asarray(xs))
        x_t, h_t = apc.solve_apc(tp, 1.0, 0.9, 20, x_ref=torch.from_numpy(xs))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=1e-4)
    np.testing.assert_allclose(h_t["residual_sq"][:5].numpy(), np.asarray(h_j["residual_sq"][:5]),
                               rtol=1e-3, atol=_floor(B))


@pytest.mark.parametrize("case", ["vector", "columns", "batched"])
def test_apply_projection_matches_reference(case):
    """``projections.apply_projection`` (the implicit ``v − Wᵀ(W v)``)
    against the reference's on the same inputs, 1e-5."""
    from repro.core import projections as jprojections
    from repro_torch.core import projections

    rng = np.random.default_rng(3)
    n, p = 24, 10
    if case == "batched":
        W = rng.standard_normal((3, p, n)).astype(np.float32)
        v = rng.standard_normal((3, n, 4)).astype(np.float32)
    else:
        W = np.linalg.qr(rng.standard_normal((n, p)))[0].T.astype(np.float32)
        v = rng.standard_normal((n,) if case == "vector" else (n, 4)).astype(np.float32)
    want = np.asarray(jprojections.apply_projection(jnp.asarray(W), jnp.asarray(v)))
    got = projections.apply_projection(torch.from_numpy(W), torch.from_numpy(v))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_pinv_cuts_off_where_the_reference_does():
    """Classical APC's pseudoinverse drops the singular values
    ``jnp.linalg.pinv`` drops (below 10·max(p, n)·eps of the largest;
    torch's default cutoff is 10x smaller). One singular value lies between
    the two cutoffs: the reference zeroes it, and so must the port."""
    from repro_torch.core import projections

    rng = np.random.default_rng(4)
    n = 32
    u = np.linalg.qr(rng.standard_normal((n, n)))[0]
    v = np.linalg.qr(rng.standard_normal((n, n)))[0]
    s = np.linspace(1.0, 0.5, n)
    s[-1] = 3.0 * n * np.finfo(np.float32).eps  # above torch's cutoff, below jax's
    block = ((u * s) @ v.T).astype(np.float32)[None]
    want = np.asarray(jnp.linalg.pinv(jnp.asarray(block[0])))
    got = projections.pinv(torch.from_numpy(block))[0].numpy()
    assert np.abs(want).max() < 10  # the tiny direction was cut
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
