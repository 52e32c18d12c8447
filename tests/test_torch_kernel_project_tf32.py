"""The arithmetic of the port's tensor-core consensus update
(``csrc/project.cu``), modelled in plain PyTorch on the CPU, where the kernel
cannot run.

The kernel splits each f32 operand as a = hi + lo: hi is a rounded to TF32
(10 mantissa bits, to nearest, ties away from zero, as ``cvt.rna.tf32.f32``;
the kernel adds half a TF32 unit to a's bits and the tensor core truncates),
lo = a − hi truncated to TF32 by the tensor core. Each product is
a_lo·b_hi + a_hi·b_lo + a_hi·b_hi (3xTF32), accumulated in f32. A bf16 W is
exact in TF32, so its lo part is 0 and two products suffice. The model below
does the same with integer bit operations and f32 matmuls of the parts (a
product of two TF32 values is exact in f32), and is held against the JAX
package's Pallas kernel (interpret mode) and against float64. One TF32
product alone is not accurate enough, which is why the kernel splits.

Also pins the kernel's split-K plan (``ops.split_plan``), a function of the
shapes only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.project import ops as jops
from repro_torch.kernels.project import ops

# ---- the model ---------------------------------------------------------------


def tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as cvt.rna does: add half a unit of the 13
    dropped bits to the magnitude's bit pattern, then clear them."""
    bits = a.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def truncate(a: torch.Tensor) -> torch.Tensor:
    """float32 truncated to TF32, as the tensor core reads an operand: the
    13 low bits dropped."""
    return (a.to(torch.float32).contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(a: torch.Tensor):
    hi = tf32(a)
    return hi, truncate(a.to(torch.float32) - hi)


def mm(a: torch.Tensor, b: torch.Tensor, products: int = 3) -> torch.Tensor:
    """a @ b as the kernel's tensor cores form it: 1 (plain TF32), 2 (a's lo
    part dropped: a bf16 A) or 3 (3xTF32) TF32 products, summed in f32."""
    ah, al = split(a)
    bh, bl = split(b)
    if products == 1:
        return ah @ bh
    out = ah @ bl + ah @ bh
    return al @ bh + out if products == 3 else out


def model_update(w, x, xbar, gamma, products=3):
    """Both passes: u = W v, out = x + γ(v − Wᵀu), with v = x̄ − x formed in
    the storage type for pass 1 and in f32 for the update, as the kernel
    does. x None means 0; γ a scalar or a (J,) tensor."""
    v1 = (xbar if x is None else xbar - x).to(torch.float32)
    wf = w.to(torch.float32)
    u = mm(wf, v1, products)
    wtu = mm(wf.mT, u, products)
    xf = torch.zeros_like(v1) if x is None else x.to(torch.float32)
    g = gamma.reshape(-1, 1, 1) if isinstance(gamma, torch.Tensor) else gamma
    return (xf + g * (xbar.to(torch.float32) - xf - wtu)).to(xbar.dtype)


def _tol(v, out):
    """chip_smoke.py's tolerance for the f32 kernel, scaled by the input:
    P v cancels most of v on tall blocks."""
    return 2e-5 + 1e-4 * max(float(np.abs(v).max()), float(np.abs(out).max()))


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


# ---- TF32 rounding -------------------------------------------------------------


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32's unit in the last place at 1
    vals = torch.tensor([one + ulp / 2, one + ulp / 2 - 2.0 ** -23, one + ulp * 1.5,
                         -(one + ulp / 2), 3.0, 0.0, -0.0, 2.0 ** -130], dtype=torch.float32)
    want = torch.tensor([one + ulp, one, one + 2 * ulp, -(one + ulp), 3.0, 0.0, -0.0,
                         2.0 ** -130], dtype=torch.float32)
    assert torch.equal(tf32(vals), want)
    assert torch.signbit(tf32(torch.tensor([-0.0]))).item()


def test_split_parts():
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(10000, generator=gen) * torch.exp(torch.randn(10000, generator=gen) * 5)
    hi, lo = split(a)
    for part in (hi, lo):  # both parts are TF32: the 13 low bits are clear
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert bool(((hi - a).abs() <= a.abs() * 2.0 ** -11).all())
    # hi + lo carries all but the last few of a's 24 bits
    assert bool(((hi.double() + lo.double() - a.double()).abs() <= a.abs().double() * 2.0 ** -21).all())
    # a bf16 value is exact in TF32: its lo part is 0
    b = a.to(torch.bfloat16).to(torch.float32)
    assert torch.equal(tf32(b), b) and torch.equal(split(b)[1], torch.zeros_like(b))


# ---- the model against the JAX package ---------------------------------------------

SHAPES = [(1, 1, 8, 1), (2, 7, 33, 3), (3, 24, 130, 2), (2, 64, 200, 4)]  # (J, p, n, k)


@pytest.mark.parametrize("J,p,n,k", SHAPES)
@pytest.mark.parametrize("gamma", [1.0, 0.35])
def test_model_matches_jax_consensus_update(J, p, n, k, gamma):
    w, x, xbar = _mk(J, p, n, k, seed=p * 1000 + n)
    got = model_update(*map(torch.from_numpy, (w, x, xbar)), gamma).numpy()
    want = np.asarray(_jax_batched(jops.consensus_update, *map(jnp.asarray, (w, x, xbar)), gamma))
    assert np.abs(got - want).max() <= _tol(xbar - x, want)


@pytest.mark.parametrize("J,p,n,k", SHAPES)
def test_model_matches_jax_project(J, p, n, k):
    w, _, v = _mk(J, p, n, k, seed=n + k)
    got = model_update(torch.from_numpy(w), None, torch.from_numpy(v), 1.0).numpy()
    want = np.asarray(_jax_batched(lambda ww, _, b, g: jops.project(ww, b), jnp.asarray(w),
                                   jnp.asarray(v), jnp.asarray(v), 1.0))
    assert np.abs(got - want).max() <= _tol(v, want)


def test_model_per_block_gamma():
    J, p, n, k = 3, 16, 96, 2
    w, x, xbar = _mk(J, p, n, k, seed=9)
    gammas = np.array([0.5, 1.0, 1.5], np.float32)
    got = model_update(*map(torch.from_numpy, (w, x, xbar)), torch.from_numpy(gammas)).numpy()
    for j in range(J):
        want = np.asarray(_jax_batched(jops.consensus_update,
                                       *(jnp.asarray(a[j:j + 1]) for a in (w, x, xbar)),
                                       float(gammas[j])))
        assert np.abs(got[j:j + 1] - want).max() <= _tol(xbar[j] - x[j], want)


@pytest.mark.parametrize("p,n", [(16, 128), (24, 300)])
def test_model_bf16_two_products(p, n):
    """A bf16 W drops a_lo·b_hi, which is 0: two products give the bits of
    three, and both agree with the JAX package's bf16 kernel."""
    w, x, xbar = _mk(2, p, n, 2, seed=n)
    tw, tx, txb = (torch.from_numpy(a).to(torch.bfloat16) for a in (w, x, xbar))
    two = model_update(tw, tx, txb, 0.9, products=2)
    assert torch.equal(two, model_update(tw, tx, txb, 0.9, products=3))
    assert two.dtype == torch.bfloat16
    jw, jx, jxb = (jnp.asarray(a, jnp.bfloat16) for a in (w, x, xbar))
    want = np.asarray(_jax_batched(jops.consensus_update, jw, jx, jxb, 0.9), np.float32)
    np.testing.assert_allclose(two.float().numpy(), want, atol=0.05, rtol=0.05)


# ---- why the kernel splits: float64 at a mid shape --------------------------------


@pytest.fixture(scope="module")
def mid():
    """W (2, 600, 1163) with orthonormal rows, x̄ (2, 1163, 32), and the
    projection in float64."""
    w, _, xbar = _mk(2, 600, 1163, 32, seed=21)
    w64, v64 = w.astype(np.float64), xbar.astype(np.float64)
    exact = v64 - np.swapaxes(w64, 1, 2) @ (w64 @ v64)
    return torch.from_numpy(w), torch.from_numpy(xbar), exact


def _err(w, xbar, exact, products):
    return float(np.abs(model_update(w, None, xbar, 1.0, products).double().numpy() - exact).max())


def test_3xtf32_meets_f32_tolerance_at_mid_shape(mid):
    w, xbar, exact = mid
    tol = _tol(xbar.numpy(), exact)
    err3 = _err(w, xbar, exact, 3)
    assert err3 <= tol
    plain = float(np.abs(model_update_plain(w, xbar) - exact).max())
    assert err3 <= 10 * plain + 1e-7  # as accurate as plain f32, to rounding


def test_1xtf32_is_10x_worse_at_mid_shape(mid):
    w, xbar, exact = mid
    err1, err3 = _err(w, xbar, exact, 1), _err(w, xbar, exact, 3)
    assert err1 >= 10 * err3


def model_update_plain(w, xbar):
    """(I − WᵀW) x̄ in plain f32 products, for comparison."""
    return (xbar - w.mT @ (w @ xbar)).double().numpy()


# ---- the split-K plan ---------------------------------------------------------------------


def _ranges(length, splits):
    """The kernel's chunk_range: split s covers DEPTH-deep steps
    [s·per, min(steps, s·per + per))."""
    steps = -(-length // ops.DEPTH)
    per = -(-steps // splits)
    return [(s * per, min(steps, s * per + per)) for s in range(splits)]


@pytest.mark.parametrize("J,p,n,k,want", [
    (2, 4654, 2327, 32, (32, 1, 4, 8)),  # Table 1 tall: 146 x 4 and 74 x 8 blocks
    (8, 1164, 2327, 32, (32, 1, 4, 2)),  # Table 1 wide: 152 x 4 and 296 x 2 blocks
    (8, 2048, 4096, 64, (64, 1, 2, 1)),  # the dense scale run: 256 x 2 and 512 blocks
    (2, 300, 129, 1, (32, 1, 1, 2)),  # the card tests' shapes, named by their ids
    (3, 100, 1001, 33, (64, 1, 8, 1)),
    (2, 500, 257, 64, (64, 1, 2, 4)),
    (2, 70, 2049, 65, (64, 2, 13, 1)),
    (2, 1500, 700, 32, (32, 1, 5, 10)),
    (1, 130, 4097, 31, (32, 1, 26, 1)),
    (3, 64, 256, 32, (32, 1, 2, 1)),
    (1, 1, 8, 1, (32, 1, 1, 1)),
])
def test_split_plan(J, p, n, k, want):
    plan = ops.split_plan(J, p, n, k)
    assert (plan.kt, plan.kgroups, plan.splits1, plan.splits2) == want
    ptiles, ntiles = -(-p // ops.TILE), -(-n // ops.TILE)
    for tiles, depth, splits in ((ptiles, n, plan.splits1), (ntiles, p, plan.splits2)):
        ranges = _ranges(depth, splits)
        assert all(lo < hi for lo, hi in ranges)  # no block reduces nothing
        assert ranges[-1][1] == -(-depth // ops.DEPTH)  # and together they cover all
        per = ranges[0][1] - ranges[0][0]
        assert splits == 1 or per >= ops.MIN_STEPS
        # a pass that splits reaches its target (TARGET_BLOCKS blocks of 32
        # columns), unless one more split would leave a block fewer than
        # MIN_STEPS steps
        blocks = J * tiles * plan.kgroups * splits
        target = ops.TARGET_BLOCKS * 32 // plan.kt
        assert splits == 1 or blocks >= target or per < 2 * ops.MIN_STEPS
    tile = ops.TILE * plan.kt
    assert plan.u_floats == J * ptiles * ops.TILE * plan.kgroups * plan.kt
    assert plan.part1_floats == (J * ptiles * plan.kgroups * plan.splits1 * tile
                                 if plan.splits1 > 1 else 0)
    assert plan.part2_floats == (J * ntiles * plan.kgroups * plan.splits2 * tile
                                 if plan.splits2 > 1 else 0)
