"""The port's solve watchdog and per-block convergence diagnostics against
the JAX package's.

Both are host numpy over a solve's history. The watchdog's verdicts must be
equal to the reference's on the reference's own synthetic traces
(``tests/test_guard.py``) and on real solves of both packages from one
prepared state, NaN columns included; assessing a result, or recording the
per-block history, must leave the solve bit-identical. The diagnostics
(``per_block_rates``, ``convergence_report``) of ``block_history=True``
solves agree with the reference's within 1e-4, with equal slowest/fastest
blocks and equal partition-plan labels. They are compared while every
block's residual is still far above the float32 floor (10 dense epochs, 40
matrix-free): near the floor the per-block trace of two float32 paths
differs by 1e-3 to 1e-2 (measured at 30–40 dense epochs), and a ratio such
as the imbalance follows it.

Small sizes: dense n = 96, m = 384, J = 8 (``tests/test_obs.py``'s
problem), matrix-free n = 256 at 99% sparsity, J = 8, and a skewed
160 × 120 system under a cost-aware plan, J = 4.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as jcore
from repro.core import guard as jguard
from repro.obs import convergence as jconv
from repro.sparse import generate_schenk_like, make_problem
from repro_torch import obs
from repro_torch.core import PreparedSolver, SolveHealth, Watchdog, prepare
from repro_torch.core import guard as tguard
from repro_torch.core.matfree import MatrixFreePreparedSolver
from repro_torch.obs import convergence as tconv

from test_torch_session import one_torch_thread  # noqa: F401  (autouse)

EPOCHS = 40
DIAG_EPOCHS = {"dense": 10, "sparse": 40}


def _trace(*cols):
    return np.stack([np.asarray(c, np.float64) for c in cols], axis=1)


def _synthetic_cases():
    """(input, tol, watchdog kwargs) of the reference's classification tests."""
    good = np.geomspace(1.0, 1e-6, 20)
    bad = good.copy()
    bad[-3:] = np.nan
    div = np.geomspace(1.0, 1e12, 20)
    div[-1] = np.inf
    stalled = np.concatenate([np.geomspace(1.0, 0.5, 4), np.full(16, 0.5)])
    converging = np.geomspace(1.0, 1e-4, 20)
    frozen = np.concatenate([np.geomspace(1.0, 1e-8, 10), np.full(30, 1e-8)])
    slow = np.geomspace(1.0, 0.97, 9)
    return [
        (_trace(good, bad), None, {}),
        (_trace(good, div), None, {}),
        (_trace(stalled, converging), None, {}),
        (_trace(frozen), 1e-3, {}),
        (_trace(frozen * 1e-4), None, {}),
        (_trace(np.zeros(20)), None, {}),
        (_trace(np.full(5, 1.0)), None, {"stall_window": 8}),
        (_trace(slow), None, {"stall_window": 8, "stall_decay": 0.95}),
        (_trace(slow), None, {"stall_window": 8, "stall_decay": 0.99}),
        (converging, None, {}),  # a raw (E,) trace
        ({"residual_sq": _trace(stalled, good)}, None, {}),  # a history dict
    ]


@pytest.mark.parametrize("case", range(len(_synthetic_cases())))
def test_verdicts_match_reference_on_synthetic_traces(case):
    trace, tol, kw = _synthetic_cases()[case]
    want = jguard.assess(trace, tol=tol, watchdog=jguard.Watchdog(**kw))
    got = tguard.assess(trace, tol=tol, watchdog=Watchdog(**kw))
    assert isinstance(got, SolveHealth)
    assert (got.status, got.checked_epochs) == (want.status, want.checked_epochs)
    assert (got.ok, got.nan_columns, got.stalled_columns, got.sick_columns) == (
        want.ok, want.nan_columns, want.stalled_columns, want.sick_columns)


def test_health_record_and_errors():
    h = SolveHealth(status=("ok", "nan", "stalled"), checked_epochs=10)
    assert h.nan_columns == (1,) and h.stalled_columns == (2,) and h.sick_columns == (1, 2)
    assert h.column_ok(0) and not h.column_ok(2)
    assert (tguard.STATUS_OK, tguard.STATUS_NAN, tguard.STATUS_STALLED) == (
        jguard.STATUS_OK, jguard.STATUS_NAN, jguard.STATUS_STALLED)
    assert Watchdog() == Watchdog(**dataclasses.asdict(jguard.Watchdog()))
    with pytest.raises(ValueError, match="residual"):
        tguard.assess({"mse": np.ones(4)})
    prob = make_problem(n=48, m=192, seed=0, dtype=np.float32)
    res = prepare(prob.A, num_blocks=8, materialize_p=False, device="cpu").solve(prob.b, 5)
    with pytest.raises(ValueError, match="residual"):
        tguard.assess(dataclasses.replace(res, history={"mse": np.ones(5)}))


@pytest.fixture(scope="module")
def dense():
    prob = make_problem(n=96, m=384, seed=3, dtype=np.float32)
    xs = np.random.default_rng(17).standard_normal((96, 4)).astype(np.float32)
    ref = jcore.prepare(prob.A, num_blocks=8, materialize_p=False)
    return ref, PreparedSolver.from_state(*ref.to_state(), device="cpu"), prob.A @ xs


@pytest.fixture(scope="module")
def sparse():
    coo = generate_schenk_like(256, sparsity=0.99, seed=5)
    xs = np.random.default_rng(11).standard_normal((256, 3)).astype(np.float32)
    ref = jcore.prepare(coo, mode="matfree", num_blocks=8, gamma=2.0, eta=1.9)
    port = MatrixFreePreparedSolver.from_state(*ref.to_state(), device="cpu")
    return ref, port, coo.to_dense().astype(np.float32) @ xs


@pytest.mark.parametrize("path", ["dense", "sparse"])
def test_assess_health_matches_reference(request, path):
    """Healthy solves and a NaN planted in one column of b: the same
    verdict per column, and only the NaN column is flagged."""
    ref, port, B = request.getfixturevalue(path)
    for tol in (None, 1e-3):
        want = ref.solve(B, num_epochs=EPOCHS).assess_health(tol=tol)
        got = port.solve(B, num_epochs=EPOCHS).assess_health(tol=tol)
        assert got.ok and got.status == want.status and got.checked_epochs == EPOCHS
    bad = B.copy()
    bad[3, 1] = np.nan
    want = ref.solve(bad, num_epochs=EPOCHS).assess_health()
    res = port.solve(bad, num_epochs=EPOCHS)
    got = res.assess_health()
    assert got.status == want.status
    assert got.nan_columns == (1,) and got.sick_columns == (1,)
    assert np.isnan(res.x[:, 1]).all() and np.isfinite(np.delete(res.x, 1, axis=1)).all()
    # a NaN solution with a finite trace is still a NaN verdict
    clean = port.solve(B, num_epochs=EPOCHS)
    x = clean.x.copy()
    x[:, 0] = np.nan
    assert tguard.assess(dataclasses.replace(clean, x=x)).status[0] == "nan"


@pytest.mark.parametrize("path", ["dense", "sparse"])
def test_guard_and_diagnostics_leave_the_solve_bit_identical(request, path):
    _, port, B = request.getfixturevalue(path)
    first = port.solve(B, num_epochs=EPOCHS)
    first.assess_health(tol=1e-3)
    second = port.solve(B, num_epochs=EPOCHS)
    np.testing.assert_array_equal(first.x, second.x)
    np.testing.assert_array_equal(first.history["residual_sq"], second.history["residual_sq"])
    # the per-block history sums the same residuals in another order: x
    # stays bit-identical, the aggregate history agrees to rounding
    diag = port.solve(B, num_epochs=EPOCHS, block_history=True)
    np.testing.assert_array_equal(first.x, diag.x)
    np.testing.assert_allclose(first.history["residual_sq"], diag.history["residual_sq"], rtol=1e-6)
    assert "block_residual_sq" not in first.history
    with pytest.raises(ValueError, match="block_history=True"):
        obs.block_residual_history(first)


def _report_close(got, want, labels=False):
    for key in ("rates", "imbalance", "final_block_residual_sq"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
    for key in ("num_epochs", "num_blocks"):
        assert got[key] == want[key]
    for key in ("slowest_block", "fastest_block", "block_epochs_to_tol"):
        np.testing.assert_array_equal(got[key], want[key])
    if labels:
        assert got["block_labels"] == want["block_labels"]


@pytest.mark.parametrize("path", ["dense", "sparse"])
def test_convergence_report_matches_reference(request, path):
    ref, port, B = request.getfixturevalue(path)
    epochs = DIAG_EPOCHS[path]
    want = ref.solve(B, num_epochs=epochs, block_history=True)
    got = port.solve(B, num_epochs=epochs, block_history=True)
    trace = obs.block_residual_history(got)
    assert trace.shape == (epochs, 8, B.shape[1])
    np.testing.assert_allclose(trace, jconv.block_residual_history(want), rtol=1e-4)
    np.testing.assert_allclose(trace.sum(axis=1), got.history["residual_sq"], rtol=1e-4)
    np.testing.assert_allclose(obs.per_block_rates(got), jconv.per_block_rates(want), rtol=1e-4)
    _report_close(obs.convergence_report(got, tol=1e-2), jconv.convergence_report(want, tol=1e-2))
    # one RHS: the trailing axis collapses, and comes back as k = 1
    one = port.solve(B[:, 0], num_epochs=EPOCHS, block_history=True)
    assert one.history["block_residual_sq"].shape == (EPOCHS, 8)
    assert obs.block_residual_history(one).shape == (EPOCHS, 8, 1)
    with pytest.raises(ValueError, match="2 epochs"):
        obs.per_block_rates(port.solve(B, num_epochs=1, block_history=True))


def _skewed(m=160, n=120, seed=0):
    rng = np.random.default_rng(seed)
    dense = np.zeros((m, n), np.float32)
    for i in range(m):  # light rows and heavy rows: a skewed system
        cols = rng.choice(n, size=3 if i < 100 else 20, replace=False)
        dense[i, cols] = rng.standard_normal(cols.size)
    return dense, dense @ rng.standard_normal((n, 2)).astype(np.float32)


def test_plan_labels_match_reference():
    dense, B = _skewed()
    ref = jcore.prepare(dense, num_blocks=4, partition="cost_aware", materialize_p=False)
    port = PreparedSolver.from_state(*ref.to_state(), device="cpu")
    assert port.mode == "wide"  # p < n: no block is solved exactly
    want = ref.solve(B, num_epochs=10, block_history=True)
    got = port.solve(B, num_epochs=10, block_history=True)
    w, g = jconv.per_block_rates(want, plan=ref.plan), tconv.per_block_rates(got, plan=port.plan)
    assert g["labels"] == w["labels"] and len(g["labels"]) == 4
    np.testing.assert_allclose(g["rates"], w["rates"], rtol=1e-4)
    _report_close(tconv.convergence_report(got, tol=1e-2, plan=port.plan),
                  jconv.convergence_report(want, tol=1e-2, plan=ref.plan), labels=True)
