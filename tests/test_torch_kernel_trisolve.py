"""The port's batched triangular solve (``repro_torch.kernels.trisolve``) on
the CPU, where it takes its plain version, against the JAX package's Pallas
kernel (interpret mode) and its ``trisolve_ref`` oracle.

The port takes R (J, n, n) and y (J, n, k) in one call; the reference solves
one (n,) column, so it is vmapped over J and k here exactly as
``repro.core.dapc._trisolve`` vmaps it. ``trisolve_blocked_plain`` spells out
the CUDA kernel's 64-row blocking and is held to the same references on
ragged n. The CUDA kernel itself is held against the plain versions on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.trisolve import ops as jops
from repro.kernels.trisolve.ref import trisolve_ref as jref
from repro_torch.kernels.trisolve import ops
from repro_torch.kernels.trisolve.ref import trisolve_blocked_plain, trisolve_ref


def _mk(J, n, k, seed, dtype=np.float32):
    """Well-conditioned upper triangles, as tests/test_kernel_trisolve.py
    builds them, and a (J, n, k) right-hand side."""
    rng = np.random.default_rng(seed)
    r = np.triu(rng.standard_normal((J, n, n)))
    di = np.arange(n)
    r[:, di, di] = np.sign(r[:, di, di] + 0.5) * (3.0 + np.abs(r[:, di, di]))
    y = rng.standard_normal((J, n, k))
    return r.astype(dtype), y.astype(dtype)


def _relclose(got, want, rtol):
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, atol=rtol * scale, rtol=rtol)


def _jax_batched(fn, r, y, lower):
    """fn(r (n,n), col (n,)) vmapped over the k columns, then over J."""
    per_block = lambda rr, yy: jax.vmap(  # noqa: E731
        lambda col: fn(rr, col, lower=lower), in_axes=1, out_axes=1
    )(yy)
    return np.asarray(jax.vmap(per_block)(jnp.asarray(r), jnp.asarray(y)))


CASES = [(1, 1, 1), (2, 8, 3), (3, 65, 2), (2, 130, 4)]  # (J, n, k); 65, 130 ragged


@pytest.mark.parametrize("J,n,k", CASES)
@pytest.mark.parametrize("case", ["upper", "lower", "lower_on_transpose"])
def test_plain_matches_reference(J, n, k, case):
    r, y = _mk(J, n, k, seed=J * 1000 + n)
    lower = case != "upper"
    transpose = case == "lower_on_transpose"
    op_r = np.ascontiguousarray(np.swapaxes(r, 1, 2)) if lower else r
    # the port reads op(R) = Rᵀ through the flag, the reference gets Rᵀ itself
    r_in = r if transpose else op_r
    got = ops.trisolve(torch.from_numpy(r_in), torch.from_numpy(y), lower=lower, transpose=transpose)
    assert got.shape == (J, n, k) and got.dtype == torch.float32
    _relclose(got, _jax_batched(jops.trisolve, op_r, y, lower), 1e-4)
    _relclose(got, _jax_batched(jref, op_r, y, lower), 1e-4)


def _cases(J, n, k, case, seed, dtype=np.float32):
    """(R as the port reads it, op(R) as the reference takes it, y, lower,
    transpose) for one of upper / lower / lower_on_transpose."""
    r, y = _mk(J, n, k, seed=seed, dtype=dtype)
    lower = case != "upper"
    transpose = case == "lower_on_transpose"
    op_r = np.ascontiguousarray(np.swapaxes(r, 1, 2)) if lower else r
    return (r if transpose else op_r), op_r, y, lower, transpose


@pytest.mark.parametrize("k", [1, 8, 9, 33])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 129, 777])
@pytest.mark.parametrize("case", ["upper", "lower", "lower_on_transpose"])
def test_blocked_plain_matches_reference(n, k, case):
    """The kernel's row-block decomposition, ragged n included (64-row
    blocks: 63, 64 and 65 straddle one edge, 777 ends on a 9-row block)."""
    r_in, op_r, y, lower, transpose = _cases(2, n, k, case, seed=n + 7 * k)
    got = trisolve_blocked_plain(torch.from_numpy(r_in), torch.from_numpy(y), lower, transpose)
    assert got.shape == (2, n, k) and got.dtype == torch.float32
    want = trisolve_ref(torch.from_numpy(r_in), torch.from_numpy(y), lower, transpose)
    _relclose(got, want, 1e-4)
    _relclose(got, _jax_batched(jops.trisolve, op_r, y, lower), 1e-4)


@pytest.mark.parametrize("case", ["upper", "lower", "lower_on_transpose"])
def test_blocked_plain_f64_with_x64(case):
    r_in, op_r, y, lower, transpose = _cases(2, 129, 9, case, seed=11, dtype=np.float64)
    got = trisolve_blocked_plain(torch.from_numpy(r_in), torch.from_numpy(y), lower, transpose)
    assert got.dtype == torch.float64
    with jax.enable_x64(True):
        want = _jax_batched(jref, op_r, y, lower)
    assert want.dtype == np.float64
    _relclose(got, want, 1e-9)


def test_solves_the_system():
    r, y = _mk(2, 96, 5, seed=42)
    x = ops.trisolve(torch.from_numpy(r), torch.from_numpy(y))
    scale = max(float(x.abs().max()), 1.0)
    np.testing.assert_allclose((torch.from_numpy(r) @ x).numpy(), y, atol=2e-4 * scale)


@pytest.mark.parametrize("transpose", [False, True])
def test_f64_matches_reference_with_x64(transpose):
    r, y = _mk(2, 96, 3, seed=7, dtype=np.float64)
    op_r = np.swapaxes(r, 1, 2) if transpose else r
    got = ops.trisolve(torch.from_numpy(r), torch.from_numpy(y), lower=transpose, transpose=transpose)
    assert got.dtype == torch.float64
    with jax.enable_x64(True):
        want = _jax_batched(jref, op_r, y, transpose)
    assert want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, atol=1e-9)


def test_wrapper_checks_and_counter():
    r, y = _mk(2, 10, 3, seed=0)
    r, y = torch.from_numpy(r), torch.from_numpy(y)
    before = ops.launches
    ops.trisolve(r, y)
    assert ops.launches == before  # the plain version launches nothing
    with pytest.raises(ValueError, match="takes R"):
        ops.trisolve(r[0], y[0])
    with pytest.raises(ValueError, match="does not match"):
        ops.trisolve(r, y[:, :5])
    # a tensor that is neither on the CPU nor on the card has no kernel
    with pytest.raises(ValueError, match="no kernel"):
        ops.trisolve(r.to("meta"), y.to("meta"))
    # plain version == torch.linalg.solve_triangular (the library yardstick)
    want = torch.linalg.solve_triangular(r.mT, y, upper=False)
    torch.testing.assert_close(trisolve_ref(r, y, lower=True, transpose=True), want)
