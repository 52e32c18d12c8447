"""The residual kernel (``csrc/residual.cu``, ``kernels/residual``): the
consensus loop's ‖A x̄ − b‖² in one call: a split of x̄, then the residual.

On the CPU the wrapper takes its plain version, which
``core.consensus.block_residual_sq`` calls: the two agree bit for bit, and
the dense solver routes its loop's residuals through the wrapper when it
runs its kernels. The tests marked ``gpu`` hold the kernel on the card
against a float64 residual at the benchmark cells' shapes, the library's
product where the plan keeps it (k ≤ 8, and float64), and kernels-on
solves' x̄ against the same solves on ATen's residual; they skip without
CUDA (``python -m pytest -m gpu tests/test_torch_kernel_residual.py``
on a machine with an H100).

This file imports no jax: the machine with the card has none.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import consensus, prepare
from repro_torch.core.consensus import block_residual_sq
from repro_torch.kernels.residual import ops
from repro_torch.kernels.residual.ref import residual_sq_ref


def _operands(J, p, n, k, seed, device="cpu", offset=1e-2):
    """A (J, p, n), b = A x (J, p[, k]) and x̄ = x + offset·noise: a residual
    that cancels most of A x̄, as the loop's does. k None: one RHS."""
    gen = torch.Generator().manual_seed(seed)
    shape = (n,) if k is None else (n, k)
    a = torch.randn(J, p, n, generator=gen)
    x = torch.randn(shape, generator=gen)
    b = (a.double() @ x.double()).float()
    xbar = x + offset * torch.randn(shape, generator=gen)
    return a.to(device), b.to(device), xbar.to(device)


# -- the CPU path ---------------------------------------------------------------


@pytest.mark.parametrize("per_block", [False, True])
@pytest.mark.parametrize("J,p,n,k", [(3, 37, 50, None), (3, 37, 50, 1), (4, 64, 33, 32),
                                     (2, 129, 70, 32), (8, 5, 12, 7)])
def test_cpu_wrapper_is_block_residual_sq_bit_for_bit(J, p, n, k, per_block):
    """At k = 1 (one RHS and a batch of one), k = 32 and ragged p."""
    a, b, xbar = _operands(J, p, n, k, seed=J * p + n)
    got = ops.residual_sq(a, b, xbar, per_block=per_block)
    want = block_residual_sq(a, b, xbar, per_block=per_block)
    for g, w in zip(got, want) if per_block else [(got, want)]:
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)
    if per_block:
        assert got[1].shape == ((J,) if k is None else (J, k))


def test_cpu_loop_history_is_unchanged_by_the_wrapper():
    """``run_consensus`` with the wrapper as ``residual_fn`` gives the default
    loop's x̄ and every history row bit for bit, per-block rows included."""
    J, p, n, k = 4, 20, 48, 3
    a, b, _ = _operands(J, p, n, k, seed=5)
    gen = torch.Generator().manual_seed(6)
    x0s = torch.randn(J, n, k, generator=gen)
    w = torch.linalg.qr(a.mT)[0].mT.contiguous()

    def apply(v):
        return v - w.mT @ (w @ v)

    runs = [consensus.run_consensus(x0s, apply, 1.0, 0.9, 12, blocks=a, bvecs=b,
                                    block_history=True, tol=1e-1, **fn)
            for fn in ({}, {"residual_fn": ops.residual_sq})]
    (x1, h1), (x2, h2) = runs
    assert torch.equal(x1, x2)
    assert set(h1) == set(h2) == {"residual_sq", "block_residual_sq", "initial"}
    for key in ("residual_sq", "block_residual_sq"):
        assert torch.equal(h1[key], h2[key])
        assert torch.equal(h1["initial"][key], h2["initial"][key])


@pytest.mark.parametrize("use_kernels", [False, True])
def test_dense_solver_routes_its_residual_through_the_wrapper(monkeypatch, use_kernels):
    """The prepared dense solver calls the wrapper once for x̄(0) and once an
    epoch when it runs its kernels, and never without them."""
    from repro_torch.sparse import make_problem

    prob = make_problem(n=48, m=192, seed=2, dtype=np.float32)
    prep = prepare(prob.A, num_blocks=4, materialize_p=False, use_kernels=use_kernels,
                   device="cpu")
    calls = []

    def counted(*args, **kw):
        calls.append(kw.get("per_block", False))
        return block_residual_sq(*args, **kw)

    monkeypatch.setattr(ops, "residual_sq", counted)
    B = prob.A @ np.random.default_rng(1).standard_normal((48, 3)).astype(np.float32)
    prep.solve(B, num_epochs=7)
    prep.solve(B, num_epochs=5, block_history=True)
    assert calls == ([False] * 8 + [True] * 6 if use_kernels else [])


@pytest.mark.parametrize("args,err", [
    (((3, 4, 5), (3, 4, 2), (6, 2)), ValueError),  # x̄ rows differ from A's columns
    (((3, 4, 5), (3, 5, 2), (5, 2)), ValueError),  # b rows differ from A's
    (((3, 4, 5), (3, 4, 3), (5, 2)), ValueError),  # b and x̄ columns differ
    (((3, 4, 5), (3, 4, 2, 1), (5, 2)), ValueError),  # b neither (J, p) nor (J, p, k)
    (((4, 5), (4,), (5,)), ValueError),  # A not (J, p, n)
])
def test_shape_errors_raise(args, err):
    with pytest.raises(err):
        ops.residual_sq(*(torch.zeros(s) for s in args))


@pytest.mark.parametrize("k", [1, 8])
def test_cpu_wrapper_broadcasts_one_b_against_a_batch(k):
    """An unbatched b (J, p) against x̄ (n, k) is that b in every column,
    as ``block_residual_sq`` reads it."""
    a, b, xbar = _operands(3, 37, 50, k, seed=7)
    b1 = b[..., 0].contiguous()
    for per_block in (False, True):
        got = ops.residual_sq(a, b1, xbar, per_block=per_block)
        want = block_residual_sq(a, b1, xbar, per_block=per_block)
        for g, w in zip(got, want) if per_block else [(got, want)]:
            assert torch.equal(g, w)
    want = block_residual_sq(a, b1[..., None].expand(3, 37, k).contiguous(), xbar)
    assert torch.equal(ops.residual_sq(a, b1, xbar), want)


def test_plan_is_a_function_of_the_shapes():
    """The cells' shapes each get a config of the kernel; up to ``PLAIN_K``
    columns (a single RHS), and in float64, the library's product."""
    for J, p, n, k in [(8, 2282, 4563, 32), (8, 1164, 2327, 256), (8, 128, 256, 64),
                       (2, 10, 20, 300), (2, 10, 20, 9)]:
        cfg = ops.plan(J, p, n, k)
        assert 0 <= cfg < len(ops.CONFIGS) and cfg == ops.plan(J, p, n, k)
        assert ops.plan(J, p, n, k, torch.float64) is None
    assert [ops.plan(8, 2282, 4563, k) for k in (32, 33, 256)] == [0, 1, 1]
    for k in range(1, ops.PLAIN_K + 1):
        assert ops.plan(8, 2282, 4563, k) is None


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _f64_residual(a, b, xbar):
    return residual_sq_ref(a.double(), b.double(), xbar.double(), per_block=True)


# The residual of these operands is ~1e-2 of A x̄, so each of its entries
# keeps ~2e-4 of the float32 product's relative error; the sums of squares
# keep that, and the kernel's 3xTF32 products are float32-accurate: 1e-4.
RTOL = 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("J,p,n,k", [(8, 2282, 4563, 32), (8, 1164, 2327, 256)])
def test_cells_shapes_against_float64(cuda, J, p, n, k):
    """The benchmark cells' shapes (s5, t1): within RTOL of float64, no
    further from it than cuBLAS's float32 product plus ATen's sums at their
    own error, and the same bits on a second call."""
    a, b, xbar = _operands(J, p, n, k, seed=11, device=cuda)
    want_total, want_block = _f64_residual(a, b, xbar)
    total, block = ops.residual_sq(a, b, xbar, per_block=True)
    torch.testing.assert_close(total.double(), want_total, rtol=RTOL, atol=0)
    torch.testing.assert_close(block.double(), want_block, rtol=RTOL, atol=0)
    lib = block_residual_sq(a, b, xbar).double()
    lib_err = float(((lib - want_total).abs() / want_total).max())
    got_err = float(((total.double() - want_total).abs() / want_total).max())
    print(f"J={J} p={p} n={n} k={k}: kernel {got_err:.3e}, cuBLAS + ATen {lib_err:.3e}")
    again = ops.residual_sq(a, b, xbar, per_block=True)
    assert torch.equal(again[0], total) and torch.equal(again[1], block)


@pytest.mark.gpu
@pytest.mark.parametrize("config", range(len(ops.CONFIGS)))
@pytest.mark.parametrize("J,p,n,k", [(3, 200, 300, 32), (2, 77, 129, 5), (2, 130, 64, 70)])
def test_every_config_against_float64(cuda, config, J, p, n, k):
    """Each tile the plan can pick, on ragged p, n and k (A's rows 16-byte
    aligned at n = 64 only)."""
    a, b, xbar = _operands(J, p, n, k, seed=config, device=cuda)
    total, block = ops._launch(a, b, xbar, config)
    want_total, want_block = _f64_residual(a, b, xbar)
    torch.testing.assert_close(total.double(), want_total, rtol=RTOL, atol=0)
    torch.testing.assert_close(block.double(), want_block, rtol=RTOL, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("J,p,n,k", [(8, 2282, 4563, 32), (8, 1164, 2327, 256)])
def test_f64_at_the_cells_shapes(cuda, J, p, n, k):
    """Float64 operands keep the library's product (``residual_sq_ref`` on
    the card) bit for bit, and launch nothing."""
    a, b, xbar = (t.double() for t in _operands(J, p, n, k, seed=12, device=cuda))
    before = ops.launches
    total, block = ops.residual_sq(a, b, xbar, per_block=True)
    assert ops.launches == before and total.dtype == block.dtype == torch.float64
    want_total, want_block = residual_sq_ref(a, b, xbar, per_block=True)
    assert torch.equal(total, want_total) and torch.equal(block, want_block)
    assert torch.equal(ops.residual_sq(a, b, xbar), residual_sq_ref(a, b, xbar))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [None, 1, 8])
def test_single_rhs_and_per_block_shapes(cuda, k):
    """Up to PLAIN_K columns the wrapper returns the library's product
    (``residual_sq_ref`` on the card) bit for bit and launches nothing."""
    a, b, xbar = _operands(3, 50, 40, k, seed=2, device=cuda)
    before = ops.launches
    total, block = ops.residual_sq(a, b, xbar, per_block=True)
    assert ops.launches == before
    want_total, want_block = residual_sq_ref(a, b, xbar, per_block=True)
    assert total.shape == want_total.shape and block.shape == want_block.shape
    assert torch.equal(total, want_total) and torch.equal(block, want_block)
    assert torch.equal(ops.residual_sq(a, b, xbar), residual_sq_ref(a, b, xbar))


@pytest.mark.gpu
def test_one_b_against_a_batch_on_card(cuda):
    """An unbatched b (J, p) against x̄ (n, k) is that b in every column."""
    a, b, xbar = _operands(3, 200, 300, 32, seed=9, device=cuda)
    b1 = b[..., 0].contiguous()
    total, block = ops.residual_sq(a, b1, xbar, per_block=True)
    want = ops.residual_sq(a, b1[..., None].expand(3, 200, 32).contiguous(), xbar,
                           per_block=True)
    assert torch.equal(total, want[0]) and torch.equal(block, want[1])


@pytest.mark.gpu
def test_launches_count_and_repeat(cuda):
    a, b, xbar = _operands(8, 300, 500, 32, seed=3, device=cuda)
    before = ops.launches
    first = ops.residual_sq(a, b, xbar)
    for _ in range(9):
        assert torch.equal(ops.residual_sq(a, b, xbar), first)
    assert ops.launches == before + 10


@pytest.mark.gpu
def test_bad_operands_raise_on_card(cuda):
    a, b, xbar = _operands(2, 30, 40, 12, seed=4, device=cuda)
    with pytest.raises(TypeError):
        ops.residual_sq(a.double(), b, xbar)
    with pytest.raises(TypeError):
        ops.residual_sq(a, b, xbar.double())
    with pytest.raises(TypeError):  # no kernel takes bfloat16
        ops.residual_sq(a.bfloat16(), b.bfloat16(), xbar.bfloat16())
    with pytest.raises(ValueError):  # not contiguous
        ops.residual_sq(a, b, xbar.t().contiguous().t())
    with pytest.raises(ValueError):  # not contiguous
        ops.residual_sq(a.mT.contiguous().mT, b, xbar)
    with pytest.raises(ValueError):  # on another device
        ops.residual_sq(a, b, xbar.cpu())
    with pytest.raises(ValueError):  # shapes
        ops.residual_sq(a, b[:, :20], xbar)


@pytest.mark.gpu
def test_graph_replay(cuda):
    """A CUDA-graph capture of the call, replayed twice, gives the eager
    bits: the tickets are zero again after every launch."""
    a, b, xbar = _operands(4, 300, 257, 32, seed=6, device=cuda)
    eager = ops.residual_sq(a, b, xbar, per_block=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.residual_sq(a, b, xbar)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.residual_sq(a, b, xbar, per_block=True)
    for _ in range(2):
        out[0].zero_()
        out[1].zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])


@pytest.mark.gpu
def test_s5_solve_xbar_equals_the_aten_residual_solve(cuda, monkeypatch):
    """A closed, no-tol kernels-on solve at the s5 shape (A 18252 × 4563, J =
    8 wide blocks of p = 2282, k = 32, 80 epochs): x̄ equal to the same solve
    on ATen's residual, since without tol x̄ does not read the residual; the
    histories within RTOL; one launch for x̄(0) and one an epoch."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((18252, 4563)).astype(np.float32)
    B = (A @ rng.standard_normal((4563, 32))).astype(np.float32)
    prep = prepare(A, num_blocks=8, mode="wide", materialize_p=False, use_kernels=True,
                   device=cuda)
    assert prep.blocks.shape == (8, 2282, 4563)
    before = ops.launches
    got = prep.solve(B, num_epochs=80)
    assert ops.launches == before + 81
    monkeypatch.setattr(ops, "residual_sq", block_residual_sq)
    want = prep.solve(B, num_epochs=80)
    assert np.array_equal(got.x, want.x)
    # near the float32 floor (about 1e-8 of ‖b‖², where x̄ has converged)
    # both residuals are float32 rounding: compare there absolutely
    hist, ref = got.history["residual_sq"], want.history["residual_sq"]
    np.testing.assert_allclose(hist, ref, rtol=RTOL, atol=1e-8 * float(ref[0].max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,k", [(torch.float64, 32), (torch.float32, 1)])
def test_other_solves_xbar_equals_the_aten_residual_solve(cuda, monkeypatch, dtype, k):
    """A float64 and a single-RHS kernels-on solve keep the library's
    product: no launch, x̄ and the history equal to the same solve on
    ATen's residual."""
    from repro_torch.sparse import make_problem

    prob = make_problem(n=512, m=2048, seed=4, dtype=np.float32)
    prep = prepare(prob.A, num_blocks=8, mode="wide", materialize_p=False, use_kernels=True,
                   dtype=dtype, device=cuda)
    B = prob.A @ np.random.default_rng(2).standard_normal((512, k))
    B = B[:, 0] if k == 1 else B
    before = ops.launches
    got = prep.solve(B, num_epochs=40)
    assert ops.launches == before
    monkeypatch.setattr(ops, "residual_sq", block_residual_sq)
    want = prep.solve(B, num_epochs=40)
    assert np.array_equal(got.x, want.x)
    assert np.array_equal(got.history["residual_sq"], want.history["residual_sq"])
