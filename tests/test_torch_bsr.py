"""The port's blocked-ELL operator (``repro_torch.sparse.bsr``) against the
JAX package's: the host-built layout must be equal bit for bit (ELL indices
and tiles, transposed and Gram shards, balance permutations, cost-aware
plans), and every product must agree at 1e-4 on the same numpy inputs.
The port's products run their plain PyTorch versions here, on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.partition import PartitionPlan as JPlan
from repro.sparse import bsr as jbsr
from repro.sparse import generate_schenk_like as jgen
from repro.sparse.matrix import COOMatrix as JCOO
from repro_torch.core.partition import PartitionPlan as TPlan
from repro_torch.sparse import BlockEll, PartitionedBSR, generate_schenk_like
from repro_torch.sparse import bsr as tbsr
from repro_torch.sparse.matrix import COOMatrix


def _pair(coo, J, bshape=(8, 8), plan=None, **kw):
    """(reference operator, port operator) from the same COO."""
    jcoo = JCOO(coo.rows, coo.cols, coo.vals, coo.shape)
    ref = jbsr.PartitionedBSR.from_coo(jcoo, J, bshape, plan=plan[0] if plan else None, **kw)
    port = PartitionedBSR.from_coo(coo, J, bshape, plan=plan[1] if plan else None, device="cpu", **kw)
    return ref, port


def _assert_layout_equal(ref, port):
    ra, rm = ref.to_arrays()
    pa, pm = port.to_arrays()
    assert rm == pm
    assert sorted(ra) == sorted(pa)
    for key in ra:
        assert pa[key].dtype == np.asarray(ra[key]).dtype, key
        np.testing.assert_array_equal(pa[key], np.asarray(ra[key]), err_msg=key)


def _skewed_coo(m=120, n=48, seed=0):
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(m):
        nnz = 3 if i < int(m * 0.65) else 16
        rows.append(np.full(nnz, i))
        cols.append(rng.choice(n, size=nnz, replace=False))
        vals.append(rng.standard_normal(nnz))
    return COOMatrix(np.concatenate(rows), np.concatenate(cols),
                     np.concatenate(vals).astype(np.float32), (m, n))


@pytest.mark.parametrize("J,bshape", [(1, (8, 8)), (3, (8, 8)), (8, (8, 8)), (4, (4, 16)), (4, (16, 8))])
@pytest.mark.parametrize("balance", [False, True])
def test_layout_equal(J, bshape, balance):
    coo = generate_schenk_like(96, sparsity=0.95, seed=J)
    ref, port = _pair(coo, J, bshape, with_transpose=True, with_gram=True, balance=balance)
    _assert_layout_equal(ref, port)
    assert port.fwd_indices.dtype == torch.int32 and port.fwd_data.dtype == torch.float32
    assert port.nbytes == ref.nbytes and port.dense_bytes == ref.dense_bytes
    assert port.slot_occupancy() == pytest.approx(ref.slot_occupancy())


def test_layout_equal_cost_aware_plan_and_duplicates():
    coo = _skewed_coo()
    jplan = JPlan.cost_aware(JCOO(coo.rows, coo.cols, coo.vals, coo.shape), 4)
    tplan = TPlan.cost_aware(coo, 4)
    np.testing.assert_array_equal(jplan.assignment, tplan.assignment)
    ref, port = _pair(coo, 4, plan=(jplan, tplan), with_transpose=True, with_gram=True, balance=True)
    assert port.planned
    _assert_layout_equal(ref, port)
    # duplicate coordinates resolve last-wins in both packages
    dup = COOMatrix(np.array([0, 0, 3, 9, 9]), np.array([1, 1, 2, 5, 5]),
                    np.array([1.0, 2.0, 3.0, 4.0, -5.0], np.float32), (12, 12))
    _assert_layout_equal(*_pair(dup, 2, with_transpose=True, with_gram=True, balance=True))


def test_layout_equal_empty_matrix():
    empty = COOMatrix(np.empty(0, np.int32), np.empty(0, np.int32), np.empty(0, np.float32), (16, 16))
    _assert_layout_equal(*_pair(empty, 2, with_transpose=True, with_gram=True))


def test_balance_helpers_equal():
    coo = generate_schenk_like(256, sparsity=0.985, seed=2)
    rows, cols = coo.rows.astype(np.int64), coo.cols.astype(np.int64)
    sel = rows < 64
    np.testing.assert_array_equal(
        tbsr._balance_perm(rows[sel], cols[sel] // 8, 64, 8),
        jbsr._balance_perm(rows[sel], cols[sel] // 8, 64, 8),
    )
    for a, b in zip(tbsr._gram_coo(rows[sel], cols[sel], coo.vals[sel]),
                    jbsr._gram_coo(rows[sel], cols[sel], coo.vals[sel])):
        np.testing.assert_array_equal(a, b)


def _inputs(op, k, seed):
    rng = np.random.default_rng(seed)
    n = op.shape[1]
    x = rng.standard_normal((n, k)).astype(np.float32)
    xs = rng.standard_normal((op.num_blocks, n, k)).astype(np.float32)
    y = rng.standard_normal((op.num_blocks, op.p_pad, k)).astype(np.float32)
    return x, xs, y


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("balance", [False, True])
@pytest.mark.parametrize("with_transpose", [False, True])
def test_products_match_reference(balance, with_transpose):
    coo = generate_schenk_like(100, sparsity=0.95, seed=5)
    ref, port = _pair(coo, 4, with_transpose=with_transpose, with_gram=True, balance=balance)
    x, xs, y = _inputs(port, 3, seed=1)
    t = torch.from_numpy
    _close(port.matvec(t(x)), ref.matvec(jnp.asarray(x)))
    _close(port.matvec(t(xs)), ref.matvec(jnp.asarray(xs)))
    _close(port.rmatvec(t(y)), ref.rmatvec(jnp.asarray(y)))
    f, g = port.fused_project(t(x), t(y))
    jf, jg = ref.fused_project(jnp.asarray(x), jnp.asarray(y))
    _close(f, jf)
    _close(g, jg)
    _close(port.gram_mv(t(y)), ref.gram_mv(jnp.asarray(y)))
    _close(port.gram_diag(), ref.gram_diag())
    _close(port.jacobi_weights(), ref.jacobi_weights())
    # the kernel wrappers take their plain versions on the CPU: same numbers
    if with_transpose:
        torch.testing.assert_close(port.rmatvec(t(y), use_kernels=True), port.rmatvec(t(y)))
    fk, gk = port.fused_project(t(x), t(y), use_kernels=True)
    torch.testing.assert_close(fk, f)
    torch.testing.assert_close(gk, g)


def test_gram_mv_without_gram_shards():
    coo = generate_schenk_like(64, sparsity=0.93, seed=3)
    ref, port = _pair(coo, 4)
    _, _, y = _inputs(port, 2, seed=4)
    _close(port.gram_mv(torch.from_numpy(y)), ref.gram_mv(jnp.asarray(y)))
    with pytest.raises(ValueError, match="with_transpose"):
        port.rmatvec(torch.from_numpy(y), use_kernels=True)


def test_balanced_products_equal_unbalanced():
    """The balance permutation is invisible from outside. On the CPU the
    row-space products (forward, Gram, Gram diagonal) equal the unbalanced
    operator's bit for bit: each output row sums its own tiles in column
    order in both layouts. The transposed products scatter-add rows of
    other bins in another order, so they agree to the reference's 1e-6
    (``tests/test_sparse_bsr.py``), relative to the largest entry, not bit
    for bit."""
    coo = generate_schenk_like(120, sparsity=0.93, seed=6)
    plain = PartitionedBSR.from_coo(coo, 2, with_gram=True, device="cpu")
    bal = PartitionedBSR.from_coo(coo, 2, with_gram=True, balance=True, device="cpu")
    assert bal.ext_pos is not None
    x, _, y = (torch.from_numpy(a) for a in _inputs(plain, 3, seed=7))
    exact = torch.testing.assert_close
    for name, a, b in (
        ("matvec", plain.matvec(x), bal.matvec(x)),
        ("gram_diag", plain.gram_diag(), bal.gram_diag()),
        ("gram_mv", plain.gram_mv(y), bal.gram_mv(y)),
        ("fused forward", plain.fused_project(x, y)[0], bal.fused_project(x, y)[0]),
    ):
        exact(a, b, atol=0, rtol=0, msg=name)
    for name, a, b in (
        ("rmatvec", plain.rmatvec(y), bal.rmatvec(y)),
        ("fused transpose", plain.fused_project(x, y)[1], bal.fused_project(x, y)[1]),
    ):
        exact(a, b, atol=1e-6 * float(a.abs().max()), rtol=1e-6, msg=name)


def test_block_rhs_and_arrays_round_trip():
    coo = generate_schenk_like(50, sparsity=0.9, seed=6)
    ref, port = _pair(coo, 4, with_gram=True, balance=True)  # p = 13 -> p_pad = 16
    b = np.random.default_rng(0).standard_normal((50, 2)).astype(np.float32)
    np.testing.assert_array_equal(port.block_rhs(b).numpy(), np.asarray(ref.block_rhs(b)))
    np.testing.assert_array_equal(port.block_rhs(b[:, 0]).numpy(), np.asarray(ref.block_rhs(b[:, 0])))
    with pytest.raises(ValueError, match="rows"):
        port.block_rhs(b[:10])
    # the reference's arrays rebuild in the port, and the port's in the reference
    arrays, meta = ref.to_arrays()
    _assert_layout_equal(ref, PartitionedBSR.from_arrays(arrays, meta, device="cpu"))
    arrays, meta = port.to_arrays()
    _assert_layout_equal(jbsr.PartitionedBSR.from_arrays(arrays, meta), port)


def test_block_ell_matches_reference():
    coo = generate_schenk_like(40, sparsity=0.9, seed=5)
    jcoo = jgen(40, sparsity=0.9, seed=5)
    ref = jbsr.BlockEll.from_coo(jcoo, (8, 8))
    port = BlockEll.from_coo(coo, (8, 8), device="cpu")
    np.testing.assert_array_equal(port.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_array_equal(port.data.numpy(), np.asarray(ref.data))
    assert (port.slots, port.num_block_rows, port.nbytes, port.dense_bytes) == (
        ref.slots, ref.num_block_rows, ref.nbytes, ref.dense_bytes)
    np.testing.assert_array_equal(port.to_dense(), ref.to_dense())
    sl, jsl = port.slice_row_blocks(8, 24), ref.slice_row_blocks(8, 24)
    assert sl.shape == jsl.shape
    np.testing.assert_array_equal(sl.to_dense(), jsl.to_dense())
    with pytest.raises(ValueError, match="multiples"):
        port.slice_row_blocks(3, 8)
    x = np.random.default_rng(1).standard_normal((40, 3)).astype(np.float32)
    _close(port.matmul(torch.from_numpy(x)), ref.matmul(jnp.asarray(x)))


def test_mesh_placement_not_ported():
    port = PartitionedBSR.from_coo(generate_schenk_like(32, sparsity=0.9, seed=1), 2, device="cpu")
    for call in (lambda: port.shard_spec(("data",)), lambda: port.place(None, ("data",))):
        with pytest.raises(NotImplementedError, match="item 8"):
            call()
