"""The port's dense prepared DAPC solve against the JAX package, end to end.

Most tests carry the reference's factors across — ``repro`` prepares,
``PreparedSolver.from_state(reference.to_state())`` rebuilds the solver in
the port — because QR column signs differ between LAPACK and XLA. Both
packages then solve the same right-hand sides from the same factor bytes,
and solutions, ``residual_sq`` histories and ``iterations_to_tol`` must
agree. The reference's kernel paths run as its own tests run them: Pallas
in interpret mode on the CPU. Tests that prepare independently compare
``P = I − WᵀW``, ``x0s`` and solutions, never ``W`` itself.

Small sizes: n = 48, J = 2 (tall, p = 96) and J = 8 (wide, p = 24).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import dapc as jdapc
from repro.core.prepared import PreparedSolver as JPreparedSolver
from repro.sparse import make_problem
from repro_torch.core import dapc, prepare, projections
from repro_torch.core.prepared import PreparedSolver

N, M, K = 48, 192, 3
EPOCHS = 30
REGIMES = {"tall": 2, "wide": 8}


@pytest.fixture(scope="module")
def problem():
    prob = make_problem(n=N, m=M, seed=4, dtype=np.float32)
    xs = np.random.default_rng(1).standard_normal((N, K)).astype(np.float32)
    return prob, prob.A @ xs, xs


def _carried(A, **kw):
    """(reference solver, port solver rebuilt from its state on the CPU)."""
    ref = jcore.prepare(A, **kw)
    arrays, meta = ref.to_state()
    return ref, PreparedSolver.from_state(arrays, meta, device="cpu")


def _hist_close(got, want, floor, key="residual_sq", early=5):
    """Early epochs tightly; the whole history at the float32 paths' ~2e-4
    mid-convergence agreement. ``floor`` is the absolute level below which
    values are float32 noise (the tall regime starts there)."""
    g, w = np.asarray(got.history[key]), np.asarray(want.history[key])
    assert g.shape == w.shape
    np.testing.assert_allclose(g[:early], w[:early], rtol=1e-3, atol=floor)
    np.testing.assert_allclose(g, w, rtol=2e-2, atol=10 * floor)


def _floor(b):
    """Residual noise floor: 1e-9 of the largest column's ||b||²."""
    return 1e-9 * float(np.max(np.sum(np.asarray(b, np.float64) ** 2, axis=0)))


def _agree(got, want, b, atol=1e-4):
    assert got.x.shape == want.x.shape and got.x.dtype == want.x.dtype
    np.testing.assert_allclose(got.x, want.x, atol=atol)
    _hist_close(got, want, _floor(b))
    for key in want.history["initial"]:
        np.testing.assert_allclose(got.history["initial"][key], want.history["initial"][key],
                                   rtol=1e-4, atol=_floor(b))
    assert (got.mode, got.num_blocks, got.num_epochs, got.num_rhs) == (
        want.mode, want.num_blocks, want.num_epochs, want.num_rhs)


PROFILES = [  # (use_kernels, materialize_p, batched); the kernels path with one RHS too
    (False, True, True), (False, False, True), (True, False, True), (True, False, False),
]


@pytest.mark.parametrize("regime", list(REGIMES))
@pytest.mark.parametrize("use_kernels,materialize_p,batched", PROFILES)
def test_carried_solve_matches_reference(problem, regime, use_kernels, materialize_p, batched):
    prob, B, xs = problem
    b, x_ref = (B, xs) if batched else (prob.b, prob.x_true)
    ref, port = _carried(prob.A, num_blocks=REGIMES[regime], materialize_p=materialize_p,
                         use_kernels=use_kernels)
    assert port.mode == ref.mode == regime
    kind = "dense" if materialize_p else ("kernels" if use_kernels else "implicit")
    assert port.projector[0] == kind
    if not materialize_p:  # the projector aliases W: one tensor, as in the reference
        assert port.projector[1] is port.factors[0]
    assert port.memory_bytes == ref.memory_bytes
    got = port.solve(b, num_epochs=EPOCHS, x_ref=x_ref)
    want = ref.solve(b, num_epochs=EPOCHS, x_ref=x_ref)
    _agree(got, want, b)
    _hist_close(got, want, 1e-9, key="mse")
    assert got.x.shape == ((N, K) if batched else (N,))


def test_port_state_restores_in_the_reference(problem):
    prob, B, _ = problem
    port = prepare(prob.A, num_blocks=8, materialize_p=False, use_kernels=True, device="cpu")
    arrays, meta = port.to_state()
    assert meta["projector"] == {"kind": "kernels", "factor": 0}
    ref = JPreparedSolver.from_state(arrays, meta)
    again = PreparedSolver.from_state(arrays, meta, device="cpu")
    _agree(port.solve(B, num_epochs=EPOCHS), ref.solve(B, num_epochs=EPOCHS), B)
    np.testing.assert_array_equal(again.solve(B, num_epochs=EPOCHS).x, port.solve(B, num_epochs=EPOCHS).x)


@pytest.mark.parametrize("regime", list(REGIMES))
def test_own_qr_matches_reference(problem, regime):
    """Independent prepares: P, x0s and solutions agree; W may differ in
    column signs."""
    prob, B, xs = problem
    J = REGIMES[regime]
    ref = jcore.prepare(prob.A, num_blocks=J, materialize_p=False, use_kernels=True)
    port = prepare(prob.A, num_blocks=J, materialize_p=False, use_kernels=True, device="cpu")
    assert port.blocks.dtype == torch.float32  # float64-free default, as x64-off
    np.testing.assert_array_equal(port.blocks.numpy(), np.asarray(ref.blocks))
    Wj, Rj = ref.factors
    Wt, Rt = port.factors
    assert Wt.is_contiguous() and Rt.is_contiguous()
    P_ref = np.asarray(jnp.eye(N) - jnp.einsum("jpn,jpm->jnm", Wj, Wj))
    np.testing.assert_allclose(projections.materialize(Wt).numpy(), P_ref, atol=1e-5)
    bvecs = ref.mixer.apply(B).astype(np.float32)
    x0_ref = jdapc.initial_from_factors(Wj, Rj, jnp.asarray(bvecs), regime, True)
    for kernels in (True, False):
        x0 = dapc.initial_from_factors(Wt, Rt, torch.from_numpy(bvecs), regime, kernels)
        np.testing.assert_allclose(x0.numpy(), np.asarray(x0_ref), atol=1e-4)
    got, want = port.solve(B, num_epochs=EPOCHS, x_ref=xs), ref.solve(B, num_epochs=EPOCHS, x_ref=xs)
    np.testing.assert_allclose(got.x, want.x, atol=1e-4)
    _hist_close(got, want, _floor(B))


def test_float64_is_honoured(problem):
    prob, B, xs = problem
    port = prepare(prob.A.astype(np.float64), num_blocks=8, dtype=torch.float64, device="cpu")
    assert port.blocks.dtype == port.factors[0].dtype == torch.float64
    res = port.solve(B.astype(np.float64), num_epochs=120, x_ref=xs)
    assert res.x.dtype == np.float64 and np.all(res.final_mse < 1e-12)
