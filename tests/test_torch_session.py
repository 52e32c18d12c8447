"""The port's streaming ``Session`` against the JAX package's.

Both packages replay the reference's drifting streams
(``tests/test_session.py``: b_t = A(x_base + 2e-3·sin(0.25 t + i)), six
updates) from the same prepared state — the port's solver is rebuilt with
``from_state(repro to_state())`` — at one shared ``tol``, 3x the
reference's cold residual floor at the epoch cap. Per update, the
``iterations_to_tol`` of every column are equal and the solutions agree to
1e-4; the session's own gates hold in the port: every update below ``tol``,
within 5·tol of a cold solve, and fewer than 0.7x the cold epochs in all.

Where the counts differ: only on a stream's first update, which solves
cold and crosses tol² near the float32 floor, where the two packages'
trajectories have drifted apart. Dense through the kernel wrappers (their
plain versions here, which sum in another order): 53 against 54 epochs.
Matrix-free: 176 against 211 — the accelerated (2.0, 1.9) residual
oscillates near the floor, the trajectories differ by 0.7% at epoch 200,
and the first dip below tol² moves; that count is not compared. Every warm
update (the ones the session exists for) has equal counts.

The predictor is host numpy in both packages and must agree exactly.

Small sizes: dense n = 96, m = 384, J = 8; matrix-free n = 192 at 99.8%
sparsity, J = 8, (γ, η) = (2.0, 1.9).
"""
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import session as jsession
from repro.sparse import generate_schenk_like, make_problem
from repro_torch.core import DriftPredictor, PreparedSolver, Session, prepare
from repro_torch.core import session as tsession
from repro_torch.core.matfree import MatrixFreePreparedSolver

GAMMA, ETA = 2.0, 1.9  # the square-sparse consensus hyperparameters


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The solves here are small and run hundreds of epochs of tiny ops:
    one intra-op thread keeps them fast when parallel test workers share
    the cores (with a thread per core each, they took 15x as long)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _drift_rhs(A, x_base, num_updates, amp=2e-3):
    n = x_base.shape[0]
    phase = np.arange(n) if x_base.ndim == 1 else np.arange(n)[:, None]
    return [(A @ (x_base + amp * np.sin(0.25 * t + phase))).astype(np.float32)
            for t in range(num_updates)]


def _floor_tol(prep, b, cap):
    """3x the cold residual floor, the largest column's."""
    res = prep.solve(b, num_epochs=cap)
    return float(np.sqrt(np.max(np.asarray(res.history["residual_sq"])[-1]))) * 3.0


def _with_kernels(meta):
    """A state's meta with the kernel wrappers switched on (their plain
    versions on the CPU)."""
    meta = {**meta, "use_kernels": True}
    if meta.get("projector") is not None:
        meta["projector"] = {**meta["projector"], "kind": "kernels"}
    return meta


def _parity_trace(ref, port, A, cap, seed, cold_slack=0):
    """Replay one stream through both packages' sessions; returns the
    port's session and the per-update iteration counts. ``cold_slack``
    bounds the count difference of the first (cold) update; None skips it."""
    rng = np.random.default_rng(seed)
    bs = _drift_rhs(A, rng.standard_normal(A.shape[1]).astype(np.float32), num_updates=6)
    tol = _floor_tol(ref, bs[0], cap)
    jsess = ref.open_session(num_epochs=cap, tol=tol)
    tsess = port.open_session(num_epochs=cap, tol=tol)
    assert isinstance(tsess, Session)
    cold_epochs, counts, first = 0, [], None
    for t, b in enumerate(bs):
        want, got = jsess.update(b), tsess.update(b)
        cold = port.solve(b, num_epochs=cap, tol=tol)
        cold_epochs += int(cold.iterations_to_tol(tol).sum())
        g, w = got.iterations_to_tol(tol), want.iterations_to_tol(tol)
        if t > 0:
            np.testing.assert_array_equal(g, w)
        else:
            first = int(g.sum()) - int(w.sum())
            if cold_slack is not None:
                assert abs(first) <= cold_slack, (g, w)
        np.testing.assert_allclose(got.x, want.x, atol=1e-4)
        assert float(np.sqrt(np.max(got.final_residual))) <= tol
        assert float(np.abs(A @ got.x - b).max()) <= tol
        np.testing.assert_allclose(got.x, cold.x, atol=5 * tol)
        counts.append(got.iterations_to_tol(tol))
    assert tsess.num_updates == jsess.num_updates == len(bs)
    assert tsess.total_epochs - first == jsess.total_epochs
    assert tsess.total_epochs < 0.7 * cold_epochs, (tsess.total_epochs, cold_epochs)
    np.testing.assert_array_equal(tsess.last_x, got.x)
    return tsess, counts


@pytest.fixture(scope="module")
def dense():
    prob = make_problem(n=96, m=384, seed=3, dtype=np.float32)
    return prob, jcore.prepare(prob.A, num_blocks=8, materialize_p=False)


@pytest.fixture(scope="module")
def sparse():
    coo = generate_schenk_like(192, sparsity=0.998, seed=5)
    ref = jcore.prepare(coo, mode="matfree", num_blocks=8, gamma=GAMMA, eta=ETA)
    return coo.to_dense().astype(np.float32), ref


@pytest.mark.parametrize("kernels", [False, True])
def test_dense_session_matches_reference(dense, kernels):
    prob, ref = dense
    arrays, meta = ref.to_state()
    port = PreparedSolver.from_state(arrays, _with_kernels(meta) if kernels else meta, device="cpu")
    assert port.projector[0] == ("kernels" if kernels else "implicit")
    _, counts = _parity_trace(ref, port, prob.A, cap=300, seed=0, cold_slack=int(kernels))
    assert counts[-1][0] < counts[0][0]  # the warm start paid off


def test_matfree_session_matches_reference(sparse):
    """The kernels-on matrix-free session is held against kernels off on
    the card (``tests/test_torch_cuda.py``)."""
    A, ref = sparse
    port = MatrixFreePreparedSolver.from_state(*ref.to_state(), device="cpu")
    assert port.gamma == GAMMA and port.gram_solver == "direct"
    _parity_trace(ref, port, A, cap=400, seed=1, cold_slack=None)


def test_batched_streams_match_reference_and_track_independently(dense):
    """A (m, k) session is k independent streams in one batch: per-column
    iterations equal the reference's batched session, and each column
    stays within 5·tol of a solo session over the same trace."""
    prob, ref = dense
    port = PreparedSolver.from_state(*ref.to_state(), device="cpu")
    rng = np.random.default_rng(9)
    xb = rng.standard_normal((96, 3)).astype(np.float32)
    traces = _drift_rhs(prob.A, xb, num_updates=4)
    tol = _floor_tol(ref, traces[0][:, 0], 300)
    jbatched = ref.open_session(num_epochs=300, tol=tol)
    batched = port.open_session(num_epochs=300, tol=tol)
    solo = [port.open_session(num_epochs=300, tol=tol) for _ in range(3)]
    for B in traces:
        want, got = jbatched.update(B), batched.update(B)
        np.testing.assert_array_equal(got.iterations_to_tol(tol), want.iterations_to_tol(tol))
        np.testing.assert_allclose(got.x, want.x, atol=1e-4)
        for j in range(3):
            rs = solo[j].update(B[:, j])
            assert float(np.abs(got.x[:, j] - rs.x).max()) <= 5 * tol
    assert batched.total_epochs == jbatched.total_epochs
    assert batched.total_epochs <= sum(s.total_epochs for s in solo) * 1.2


def test_session_options_forward_to_the_solver(dense):
    prob, ref = dense
    port = PreparedSolver.from_state(*ref.to_state(), device="cpu")
    b = prob.b
    sess = port.open_session(num_epochs=50, predict="none", gamma=1.1, eta=0.8,
                             solve_kwargs={"block_history": True})
    res = sess.update(b, num_epochs=20)
    assert (res.num_epochs, res.gamma, res.eta) == (20, 1.1, 0.8)
    assert res.history["block_residual_sq"].shape == (20, 8)
    assert sess.total_epochs == 20  # no tol: every epoch counts
    cold = port.solve(b, num_epochs=20, gamma=1.1, eta=0.8)
    np.testing.assert_array_equal(res.x, cold.x)  # predict="none": a cold solve
    sess.update(b)
    sess.reset()
    assert sess._predictor.predict(b) is None


def test_open_session_rejects_non_consensus():
    prob = make_problem(n=96, m=384, seed=3, dtype=np.float32)
    for method in ("dgd", "cgnr"):
        prep = prepare(prob.A, method=method, num_blocks=8, device="cpu")
        with pytest.raises(ValueError, match="consensus"):
            prep.open_session()
        with pytest.raises(ValueError, match="consensus"):
            Session(prep)


# -- the predictor: host numpy, equal to the reference's exactly -------------


def test_constants_match_reference():
    assert tsession.PREDICT_MODES == jsession.PREDICT_MODES
    assert tsession.SESSION_METHODS == jsession.SESSION_METHODS
    assert tsession.ALPHA_MAX == jsession.ALPHA_MAX


def _extrapolation_cases():
    rng = np.random.default_rng(0)
    for dtype in (np.float32, np.float64):
        x, dx, db_prev = (rng.standard_normal((16, 6)).astype(dtype) for _ in range(3))
        scale = np.array([1.0, -1.0, 10.0, -10.0, 0.3, 0.0], dtype)
        db = db_prev * scale  # α = 1, −1, clamped +4, clamped −4, 0.3, 0
        db[:, 5] = rng.standard_normal(16)  # an uncorrelated jump
        db_prev[:, 4] = 0.0  # a vanishing previous step: α = 0
        yield x, dx, db, db_prev
        yield x[:, 0], dx[:, 0], db[:, 0], db_prev[:, 0]  # one column
        orth = np.zeros_like(db)
        orth[0], db_prev2 = 1.0, np.zeros_like(db)
        db_prev2[1] = 1.0
        yield x, dx, orth, db_prev2  # orthogonal steps: α = 0


def test_extrapolate_prediction_matches_reference():
    for x, dx, db, db_prev in _extrapolation_cases():
        want = jsession.extrapolate_prediction(x, dx, db, db_prev)
        got = tsession.extrapolate_prediction(x, dx, db, db_prev)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    x = np.array([[1.0], [2.0]])
    dx = np.array([[0.5], [0.5]])
    db = np.array([[1.0], [0.0]])
    np.testing.assert_allclose(tsession.extrapolate_prediction(x, dx, db, db), x + dx)
    np.testing.assert_allclose(tsession.extrapolate_prediction(x, dx, -db, db), x - dx)
    np.testing.assert_allclose(tsession.extrapolate_prediction(x, dx, 9 * db, db), x + 4 * dx)


@pytest.mark.parametrize("mode", ["auto", "extrapolate", "warm", "none"])
def test_drift_predictor_matches_reference(mode):
    """The same observe/predict sequence, with width changes and a reset,
    gives the same predictions bit for bit — and the same error where the
    incoming b's width differs from the last one's and the predictor
    extrapolates (both raise; ``observe`` then restarts the history)."""
    rng = np.random.default_rng(3)
    ref, port = jsession.DriftPredictor(mode), DriftPredictor(mode)
    steps = [(rng.standard_normal((12, 4)), rng.standard_normal((8, 4))) for _ in range(4)]
    steps += [(rng.standard_normal((12, 2)), rng.standard_normal((8, 2))) for _ in range(3)]
    steps += [(rng.standard_normal(12), rng.standard_normal(8)) for _ in range(3)]
    for i, (b, x) in enumerate(steps):
        try:
            want = ref.predict(b)
        except ValueError:
            with pytest.raises(ValueError, match="broadcast"):
                port.predict(b)
        else:
            got = port.predict(b)
            if want is None:
                assert got is None
            else:
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
        ref.observe(b, x)
        port.observe(b, x)
        assert port.has_history == ref.has_history
        if i == 5:
            ref.reset()
            port.reset()
    with pytest.raises(ValueError, match="predict"):
        DriftPredictor("sometimes")
