"""The matrix-free epoch's fused pass on the packed forms
(``spmm_fused_packed``, and ``PartitionedBSR.fused_project`` on an operator
that carries them) on the CPU, where the wrapper takes its plain version
(``ref.spmm_fused_packed_plain``). It is held against the JAX package's
kernel-path ``fused_project`` (the Pallas ``spmm_fused`` kernel in interpret
mode plus its scatter), against ``(matvec, rmatvec)`` on the same operator,
and inside a small matrix-free solve. The CUDA kernel itself is held against
the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.sparse import bsr as jbsr
from repro.sparse import make_problem
from repro.sparse.matrix import COOMatrix as JCOO
from repro_torch.core.matfree import MatrixFreePreparedSolver
from repro_torch.kernels.spmm import ops
from repro_torch.kernels.spmm.ref import spmm_fused_packed_plain, spmm_packed_plain
from repro_torch.sparse import PartitionedBSR, generate_schenk_like
from repro_torch.sparse.matrix import COOMatrix

N, J = 123, 4  # n % bn != 0: the transpose has padded rows
TILES = [(8, 8), (16, 8)]


@functools.lru_cache(maxsize=None)
def _operators(balance, bshape):
    """(reference, port with packed forms) of one Schenk-like matrix."""
    coo = generate_schenk_like(N, sparsity=0.95, seed=11)
    kw = dict(with_transpose=True, with_gram=True, balance=balance)
    ref = jbsr.PartitionedBSR.from_coo(JCOO(coo.rows, coo.cols, coo.vals, coo.shape), J,
                                       bshape, **kw)
    port = PartitionedBSR.from_coo(coo, J, bshape, device="cpu", **kw).with_packed()
    return ref, port


def _inputs(op, k, per_block, seed):
    rng = np.random.default_rng(seed)
    shape = (J, N, k) if per_block else (N, k)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.standard_normal((J, op.p_pad, k)).astype(np.float32)
    return x, y


def _close(got, want):
    """The tolerance of ``tests/test_torch_bsr.py``: atol = rtol = 1e-4."""
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def _tiles(op, x, y):
    """The wrapper's operands as ``fused_project`` makes them."""
    bp = op.block_shape[0]
    return op._col_tiles(x), op._to_internal(y).reshape(J, op.p_pad // bp, bp, -1)


@pytest.fixture
def staged_off(monkeypatch):
    """Counts calls of the plain version; the staged ELL wrapper raises."""
    calls = []

    def plain(*args):
        calls.append(1)
        return spmm_fused_packed_plain(*args)

    def staged(*args):
        raise AssertionError("the staged ELL pass ran on an operator with packed forms")

    monkeypatch.setattr(ops, "spmm_fused_packed_plain", plain)
    monkeypatch.setattr(ops, "spmm_fused", staged)
    return calls


@pytest.mark.parametrize("per_block", [False, True], ids=["x_broadcast", "x_per_block"])
@pytest.mark.parametrize("k", [1, 5, 32])
@pytest.mark.parametrize("bshape", TILES)
@pytest.mark.parametrize("balance", [False, True])
def test_fused_project_matches_reference(staged_off, balance, bshape, k, per_block):
    ref, port = _operators(balance, bshape)
    x, y = _inputs(port, k, per_block, seed=k + 2 * per_block)
    t = torch.from_numpy
    before = dict(ops.launches)
    f, g = port.fused_project(t(x), t(y), use_kernels=True)
    assert len(staged_off) == 1 and ops.launches == before  # the plain version, no launch
    assert f.shape == (J, port.p_pad, k) and g.shape == (J, N, k) and f.dtype == torch.float32
    jf, jg = ref.fused_project(jnp.asarray(x), jnp.asarray(y), use_kernels=True)
    _close(f, jf)
    _close(g, jg)
    # each half is the packed product the kernel path's matvec / rmatvec take
    torch.testing.assert_close(f, port.matvec(t(x), use_kernels=True), atol=0, rtol=0)
    torch.testing.assert_close(g, port.rmatvec(t(y), use_kernels=True), atol=0, rtol=0)


@pytest.mark.parametrize("bshape", TILES)
def test_wrapper_halves_and_padded_rows(bshape):
    """The wrapper's two outputs are the two packed products; the transpose's
    padded rows (n = 123 on a grid of 8) come out exactly zero."""
    _, port = _operators(True, bshape)
    x, y = _inputs(port, 3, False, seed=7)
    xb, yb = _tiles(port, torch.from_numpy(x), torch.from_numpy(y))
    fwd, tra = ops.spmm_fused_packed(port.fwd_packed, port.tra_packed, xb, yb)
    n_pad = -(-N // 8) * 8
    assert fwd.shape == (J, port.p_pad, 3) and tra.shape == (J, n_pad, 3)
    torch.testing.assert_close(fwd, spmm_packed_plain(port.fwd_packed, xb), atol=0, rtol=0)
    torch.testing.assert_close(tra, spmm_packed_plain(port.tra_packed, yb), atol=0, rtol=0)
    assert torch.count_nonzero(tra[:, N:]) == 0 and torch.count_nonzero(tra[:, :N]) > 0


def test_empty_matrix_gives_zeros():
    empty = COOMatrix(np.empty(0, np.int32), np.empty(0, np.int32), np.empty(0, np.float32),
                      (16, 16))
    op = PartitionedBSR.from_coo(empty, 2, with_transpose=True, device="cpu").with_packed()
    f, g = op.fused_project(torch.ones(16, 2), torch.ones(2, op.p_pad, 2), use_kernels=True)
    assert f.shape == (2, 8, 2) and g.shape == (2, 16, 2)
    assert torch.count_nonzero(f) == 0 and torch.count_nonzero(g) == 0


def test_wrapper_checks_shapes_types_and_devices():
    _, port = _operators(True, (8, 8))
    x, y = _inputs(port, 4, False, seed=1)
    xb, yb = _tiles(port, torch.from_numpy(x), torch.from_numpy(y))
    fwd, tra = port.fwd_packed, port.tra_packed
    run = ops.spmm_fused_packed
    with pytest.raises(ValueError, match="x"):
        run(fwd, tra, xb.reshape(J, -1, 4, 4), yb)  # x's tile width is not bn
    with pytest.raises(ValueError, match="y"):
        run(fwd, tra, xb, yb.reshape(J, -1, 4, 4))
    with pytest.raises(ValueError, match="x"):
        run(fwd, tra, xb[:2], yb)  # x for 2 blocks, the forms have 4
    with pytest.raises(ValueError, match="differ in J or k"):
        run(fwd, tra, xb, yb[..., :3])
    _, other = _operators(True, (16, 8))
    other2 = PartitionedBSR.from_coo(generate_schenk_like(N, sparsity=0.95, seed=11), 2,
                                     (8, 8), with_transpose=True, device="cpu").with_packed()
    with pytest.raises(ValueError, match="differ in J or k"):
        run(fwd, other2.tra_packed, xb, yb[:2])
    with pytest.raises(TypeError, match="x is torch.float64"):
        run(fwd, tra, xb.double(), yb)
    with pytest.raises(TypeError, match="y is torch.float64"):
        run(fwd, tra, xb, yb.double())
    tra64 = dataclasses.replace(tra, val=tra.val.double())
    with pytest.raises(TypeError, match="transposed form"):
        run(fwd, tra64, xb, yb)
    # no kernel off the card: an operand elsewhere, or everything on another device
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        run(fwd, tra, xb.to("meta"), yb)
    meta = {f: getattr(fwd, f).to("meta") for f in ("row_ptr", "col", "val")}
    meta_t = {f: getattr(tra, f).to("meta") for f in ("row_ptr", "col", "val")}
    with pytest.raises(ValueError, match="no kernel for device meta"):
        run(dataclasses.replace(fwd, **meta), dataclasses.replace(tra, **meta_t),
            xb.to("meta"), yb.to("meta"))
    assert other.tra_packed.bn == 16  # (16, 8) tiles: the transpose reads y in 16-row tiles
    with pytest.raises(ValueError, match="y"):
        run(fwd, other.tra_packed, xb, yb)


@pytest.mark.parametrize("gram_solver", ["direct", "pcg"])
def test_small_solve_matches_reference(monkeypatch, gram_solver):
    """A matrix-free solve (n = 256, J = 8, 40 epochs) whose epochs run the
    fused packed pass, as they do on the card, against the JAX package's
    kernel-path solve, the state carried across by ``from_state``."""
    prob = make_problem(n=256, m=256, sparsity=0.98, seed=2, dtype=np.float32)
    B = prob.A @ np.random.default_rng(1).standard_normal((256, 4)).astype(np.float32)
    ref = jcore.prepare(prob.coo, mode="matfree", num_blocks=8, gram_solver=gram_solver,
                        use_kernels=True, gamma=2.0, eta=1.9)
    port = MatrixFreePreparedSolver.from_state(*ref.to_state(), device="cpu")
    packed = dataclasses.replace(port, op=port.op.with_packed())
    calls = []
    real = ops.spmm_fused_packed

    def counted(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(ops, "spmm_fused_packed", counted)
    got, want = packed.solve(B, num_epochs=40), ref.solve(B, num_epochs=40)
    assert len(calls) == 40  # one fused pass per epoch
    np.testing.assert_allclose(got.x, want.x, atol=1e-4)
    # the direct solver takes one inner step per epoch; on this problem the
    # PCG stopping test sits at its threshold in some epochs, where another
    # order of float sums moves the depth by one (the staged ELL pass, whose
    # order is the reference's up to the scatter, does the same here)
    depth = np.abs(got.history["inner_iters"] - want.history["inner_iters"])
    assert depth.max() <= (0 if gram_solver == "direct" else 1)
