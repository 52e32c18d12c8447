"""The port's fused consensus update (``repro_torch.kernels.project``) on the
CPU, where it takes its plain version, against the JAX package's Pallas
kernel (interpret mode) and its ``consensus_update_ref`` oracle, forward and
backward.

The port takes W (J, p, n) and x, x̄ (J, n, k) in one call; the reference
updates one (n,) column of one block, so it is vmapped over the k columns
and the J blocks here, as ``repro.core.dapc.make_apply`` vmaps it.
Tolerances are those of ``tests/test_kernel_project.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.project import ops as jops
from repro.kernels.project.ref import consensus_update_ref as jref
from repro_torch.kernels.project import ops
from repro_torch.kernels.project.ref import consensus_update_ref, project_ref


def _mk(J, p, n, k, seed):
    """W with orthonormal rows per block (a QR factor, as prepare() makes
    it) and float32 x, x̄ (J, n, k)."""
    rng = np.random.default_rng(seed)
    w = np.stack([np.linalg.qr(rng.standard_normal((n, p)))[0].T for _ in range(J)])
    x = rng.standard_normal((J, n, k))
    xbar = rng.standard_normal((J, n, k))
    return (np.ascontiguousarray(a, np.float32) for a in (w, x, xbar))


def _jax_batched(fn, w, x, xbar, gamma):
    """fn(w (p,n), x (n,), x̄ (n,), γ) vmapped over k, then over J."""
    def per_block(ww, xx, xb):
        return jax.vmap(lambda a, b: fn(ww, a, b, gamma), in_axes=1, out_axes=1)(xx, xb)

    return jax.vmap(per_block)(w, x, xbar)


SHAPES = [(1, 1, 8, 1), (2, 7, 33, 3), (3, 24, 130, 2), (2, 64, 200, 4)]  # (J, p, n, k)


@pytest.mark.parametrize("J,p,n,k", SHAPES)
@pytest.mark.parametrize("gamma", [1.0, 0.35])
def test_consensus_update_f32(J, p, n, k, gamma):
    w, x, xbar = _mk(J, p, n, k, seed=p * 1000 + n)
    got = ops.consensus_update(*map(torch.from_numpy, (w, x, xbar)), gamma)
    assert got.shape == (J, n, k) and got.dtype == torch.float32
    jw, jx, jxb = map(jnp.asarray, (w, x, xbar))
    for fn in (jops.consensus_update, jref):
        want = np.asarray(_jax_batched(fn, jw, jx, jxb, gamma))
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


def test_per_block_gamma_is_each_block_with_its_own_gamma():
    J, p, n, k = 3, 16, 96, 2
    w, x, xbar = _mk(J, p, n, k, seed=9)
    gammas = np.array([0.5, 1.0, 1.5], np.float32)
    got = ops.consensus_update(*map(torch.from_numpy, (w, x, xbar)), torch.from_numpy(gammas))
    for j in range(J):
        want = _jax_batched(jops.consensus_update, *(jnp.asarray(a[j:j + 1]) for a in (w, x, xbar)),
                            float(gammas[j]))
        np.testing.assert_allclose(got[j:j + 1].numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("p,n", [(16, 128), (24, 300)])
def test_consensus_update_bf16(p, n):
    w, x, xbar = _mk(2, p, n, 2, seed=n)
    tw, tx, txb = (torch.from_numpy(a).to(torch.bfloat16) for a in (w, x, xbar))
    got = ops.consensus_update(tw, tx, txb, 0.9)
    assert got.dtype == torch.bfloat16
    jw, jx, jxb = (jnp.asarray(a, jnp.bfloat16) for a in (w, x, xbar))
    want = np.asarray(_jax_batched(jops.consensus_update, jw, jx, jxb, 0.9), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.05, rtol=0.05)


def test_project_is_the_reference_project():
    w, _, v = _mk(2, 12, 100, 3, seed=5)
    got = ops.project(torch.from_numpy(w), torch.from_numpy(v))
    want = _jax_batched(lambda ww, _, b, g: jops.project(ww, b), jnp.asarray(w),
                        jnp.asarray(v), jnp.asarray(v), 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(got, project_ref(torch.from_numpy(w), torch.from_numpy(v)))
    # P annihilates the row space of W
    row = torch.from_numpy(w).mT @ torch.randn(2, 12, 1, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(ops.project(torch.from_numpy(w), row), torch.zeros_like(row),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("gamma", [1.0, 0.7])
def test_backward_matches_jax_grad(gamma):
    J, p, n, k = 2, 8, 64, 3
    w, x, xbar = _mk(J, p, n, k, seed=2)

    def loss(ww, xx, xb):
        return jnp.sum(_jax_batched(jops.consensus_update, ww, xx, xb, gamma) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (w, x, xbar)))
    tw, tx, txb = (torch.from_numpy(a).requires_grad_() for a in (w, x, xbar))
    (ops.consensus_update(tw, tx, txb, gamma) ** 2).sum().backward()
    for got, ref in zip((tw.grad, tx.grad, txb.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_project_backward_matches_jax_grad():
    w, _, v = _mk(2, 8, 64, 2, seed=3)

    def loss(ww, vv):
        out = _jax_batched(lambda a, _, b, g: jops.project(a, b), ww, vv, vv, 1.0)
        return jnp.sum(out ** 3)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(v))
    tw, tv = (torch.from_numpy(a).requires_grad_() for a in (w, v))
    (ops.project(tw, tv) ** 3).sum().backward()
    for got, ref in zip((tw.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_wrapper_checks_and_counter():
    w, x, xbar = map(torch.from_numpy, _mk(2, 4, 16, 3, seed=0))
    before = ops.launches
    ops.consensus_update(w, x, xbar)
    assert ops.launches == before  # the plain version launches nothing
    with pytest.raises(ValueError, match="takes W"):
        ops.consensus_update(w[0], x, xbar)
    with pytest.raises(ValueError, match="does not match"):
        ops.consensus_update(w, x[:, :8], xbar[:, :8])
    with pytest.raises(ValueError, match="differs"):
        ops.consensus_update(w, x[..., :1], xbar)
    with pytest.raises(ValueError, match="no kernel"):
        ops.consensus_update(w.to("meta"), x.to("meta"), xbar.to("meta"))
    # the plain version with a per-block γ is each block with its own γ
    g = torch.tensor([0.25, 2.0])
    got = consensus_update_ref(w, x, xbar, g)
    for j in range(2):
        torch.testing.assert_close(got[j], consensus_update_ref(w[j:j + 1], x[j:j + 1],
                                                                xbar[j:j + 1], float(g[j]))[0])
