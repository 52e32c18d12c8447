"""The blocked-ELL SpMM plain versions (the products the matrix-free operator
takes without kernels, or without packed forms on the CPU) against the JAX
package's Pallas kernels in interpret mode and against the densifying
oracles, on operands built from the same numpy data; and the checks the
packed kernels' wrappers make. The CUDA kernels themselves are held against
the plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spmm import ops as jops
from repro.kernels.spmm import ref as jref
from repro.sparse import bsr as jbsr
from repro.sparse.matrix import COOMatrix as JCOO
from repro_torch.kernels.spmm import ops
from repro_torch.kernels.spmm.ref import (
    blocked_ell_to_dense,
    spmm_fused_plain,
    spmm_fused_ref,
    spmm_plain,
    spmm_ref,
)
from repro_torch.sparse import PartitionedBSR, generate_schenk_like
from repro_torch.sparse.bsr import _pad_cols, _scatter_contrib
from repro_torch.sparse.matrix import COOMatrix

TILES = [(8, 8), (4, 16), (8, 128), (16, 8)]


def _operands(coo, J, bshape, k, seed):
    """Forward shards, the (J, C, bn, k) x tile view and y (J, R, bp, k),
    as torch and as jax arrays of the same bytes."""
    op = PartitionedBSR.from_coo(coo, J, bshape, device="cpu")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((J, coo.shape[1], k)).astype(np.float32))
    xb = _pad_cols(x, coo.shape[1], bshape[1]).contiguous()
    R = op.fwd_indices.shape[1]
    y = torch.from_numpy(rng.standard_normal((J, R, bshape[0], k)).astype(np.float32))
    t = (op.fwd_indices, op.fwd_data, xb, y)
    return t, tuple(jnp.asarray(a.numpy()) for a in t)


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("bshape", TILES)
@pytest.mark.parametrize("k", [1, 5])
def test_spmm_plain_matches_pallas_and_oracles(bshape, k):
    coo = generate_schenk_like(96, sparsity=0.95, seed=1)
    (idx, data, xb, _), (jidx, jdata, jxb, _) = _operands(coo, 4, bshape, k, seed=2)
    got = spmm_plain(idx, data, xb)
    assert got.shape == (4, idx.shape[1] * bshape[0], k) and got.dtype == torch.float32
    _close(got, jops.spmm(jidx, jdata, jxb, interpret=True))
    _close(got, jref.spmm_ref(jidx, jdata, jxb))
    _close(spmm_ref(idx, data, xb), jref.spmm_ref(jidx, jdata, jxb))


@pytest.mark.parametrize("bshape", TILES)
def test_spmm_fused_plain_matches_pallas_and_oracles(bshape):
    coo = generate_schenk_like(96, sparsity=0.95, seed=3)
    (idx, data, xb, y), (jidx, jdata, jxb, jy) = _operands(coo, 4, bshape, 3, seed=9)
    fwd, contrib = spmm_fused_plain(idx, data, xb, y)
    J, R, S = idx.shape
    assert contrib.shape == (J, R, S, bshape[1], 3)
    jfwd, jcontrib = jops.spmm_fused(jidx, jdata, jxb, jy, interpret=True)
    _close(fwd, jfwd)
    _close(contrib, jcontrib)  # the staged per-slot form, slot by slot
    # the forward half is the plain forward product, bit for bit
    torch.testing.assert_close(fwd, spmm_plain(idx, data, xb), atol=0, rtol=0)
    want_fwd, want_tra = jref.spmm_fused_ref(jidx, jdata, jxb, jy)
    C = xb.shape[1]
    _close(fwd, want_fwd)
    _close(_scatter_contrib(idx, contrib, C), want_tra)
    tf, tt = spmm_fused_ref(idx, data, xb, y)
    _close(tf, want_fwd)
    _close(tt, want_tra)


def test_transposed_and_gram_shards():
    """The transposed (bn, bp) and Gram (bp, bp) shards go through the same
    product; both against the Pallas kernel on the same bytes."""
    coo = generate_schenk_like(80, sparsity=0.93, seed=4)
    op = PartitionedBSR.from_coo(coo, 4, (8, 16), with_transpose=True, with_gram=True, device="cpu")
    rng = np.random.default_rng(5)
    y = torch.from_numpy(rng.standard_normal((4, op.p_pad, 2)).astype(np.float32))
    for idx, data, bw in ((op.tra_indices, op.tra_data, 8), (op.gram_indices, op.gram_data, 8)):
        yb = _pad_cols(y, op.p_pad, bw).contiguous()
        _close(spmm_plain(idx, data, yb),
               jops.spmm(*(jnp.asarray(a.numpy()) for a in (idx, data, yb)), interpret=True))


def test_padding_slots_and_empty_matrix_are_inert():
    empty = COOMatrix(np.empty(0, np.int32), np.empty(0, np.int32), np.empty(0, np.float32), (16, 16))
    (idx, data, xb, y), _ = _operands(empty, 2, (8, 8), 2, seed=1)
    fwd, contrib = spmm_fused_plain(idx, data, xb, y)
    for t in (spmm_plain(idx, data, xb), fwd, contrib):
        assert torch.count_nonzero(t) == 0
    # one real tile in column block 0 next to padding slots that also point
    # at block 0: index 0 is data, not padding, and is never skipped
    one = COOMatrix(np.array([0, 9]), np.array([3, 12]), np.array([2.0, 5.0], np.float32), (16, 16))
    (idx, data, xb, _), _ = _operands(one, 1, (8, 8), 1, seed=2)
    assert idx.shape[-1] == 1 and int(idx[0, 1, 0]) == 1
    out = spmm_plain(idx, data, xb)
    assert out[0, 0, 0] == 2.0 * xb[0, 0, 3, 0] and out[0, 9, 0] == 5.0 * xb[0, 1, 4, 0]


def test_broadcast_x_needs_no_copy():
    """An (n, k) operand expanded over J with a zero stride gives the same
    product as J materialized copies."""
    coo = generate_schenk_like(64, sparsity=0.93, seed=6)
    op = PartitionedBSR.from_coo(coo, 4, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((64, 3)).astype(np.float32))
    xb = _pad_cols(x, 64, 8)
    wide = xb[None].expand(4, *xb.shape)
    assert wide.stride(0) == 0
    torch.testing.assert_close(spmm_plain(op.fwd_indices, op.fwd_data, wide),
                               spmm_plain(op.fwd_indices, op.fwd_data, wide.contiguous()),
                               atol=0, rtol=0)


def test_blocked_ell_to_dense_matches_reference():
    coo = generate_schenk_like(40, sparsity=0.9, seed=5)
    be = jbsr.BlockEll.from_coo(JCOO(coo.rows, coo.cols, coo.vals, coo.shape), (8, 8))
    got = blocked_ell_to_dense(torch.from_numpy(np.array(be.indices)),
                               torch.from_numpy(np.array(be.data)), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.blocked_ell_to_dense(be.indices, be.data, 5)))
    np.testing.assert_allclose(got.numpy()[:40, :40], coo.to_dense(), atol=1e-5)


def test_wrapper_checks_and_cpu_launches_nothing():
    """The packed wrappers check their operands, take the plain version on a
    CPU tensor (no launch counted) and have no kernel for another device."""
    coo = generate_schenk_like(32, sparsity=0.9, seed=2)
    op = PartitionedBSR.from_coo(coo, 2, with_transpose=True, device="cpu").with_packed()
    rng = np.random.default_rng(3)
    xb = op._col_tiles(torch.from_numpy(rng.standard_normal((32, 2)).astype(np.float32)))
    yb = torch.from_numpy(rng.standard_normal((2, op.p_pad // 8, 8, 2)).astype(np.float32))
    before = dict(ops.launches)
    ops.spmm_packed(op.fwd_packed, xb)
    ops.spmm_fused_packed(op.fwd_packed, op.tra_packed, xb, yb)
    assert ops.launches == before  # the plain path counts no launch
    with pytest.raises(ValueError, match="x"):
        ops.spmm_packed(op.fwd_packed, xb.reshape(2, -1, 4, 2))  # tile width is not bn
    with pytest.raises(ValueError, match="y"):
        ops.spmm_fused_packed(op.fwd_packed, op.tra_packed, xb, yb.reshape(2, -1, 4, 2))
    with pytest.raises(ValueError, match="x"):
        ops.spmm_packed(op.fwd_packed, xb[:1])
    # a tensor that is on neither the CPU nor a card never reaches the plain path
    fwd = op.fwd_packed
    meta = dataclasses.replace(fwd, **{f: getattr(fwd, f).to("meta") for f in ("row_ptr", "col", "val")})
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.spmm_packed(meta, xb.to("meta"))


def test_pad_cols_matches_reference():
    """The reference's vmapped pad (``bsr._pad_cols``) and the port's
    batched pad give the same tile view."""
    x = np.random.default_rng(0).standard_normal((3, 21, 2)).astype(np.float32)
    want = jax.vmap(lambda v: jbsr._pad_cols(v, 21, 8))(jnp.asarray(x))
    np.testing.assert_array_equal(_pad_cols(torch.from_numpy(x), 21, 8).numpy(), np.asarray(want))
