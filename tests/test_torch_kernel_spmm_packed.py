"""The packed-nonzero SpMM (``repro_torch.kernels.spmm.pack`` and
``spmm_packed``) on the CPU, where the wrapper takes its plain version
(``ref.spmm_packed_plain``), against the blocked-ELL plain version and the
JAX package's Pallas ``spmm`` (interpret mode), on the forward, transposed
and Gram shards of balanced and cost-aware operators. The CUDA kernel itself
is held against these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.partition import PartitionPlan as JPlan
from repro.kernels.spmm import ops as jops
from repro.sparse import bsr as jbsr
from repro.sparse import make_problem
from repro.sparse.matrix import COOMatrix as JCOO
from repro_torch.core.matfree import MatrixFreePreparedSolver
from repro_torch.core.partition import PartitionPlan as TPlan
from repro_torch.kernels.spmm import ops
from repro_torch.kernels.spmm.pack import Packed, pack
from repro_torch.kernels.spmm.ref import blocked_ell_to_dense, spmm_packed_plain, spmm_plain
from repro_torch.sparse import PartitionedBSR, generate_schenk_like
from repro_torch.sparse.matrix import COOMatrix

KINDS = ["fwd", "tra", "gram"]
PLANS = ["balanced", "cost_aware"]
TILES = [(8, 8), (16, 8)]


def _operators(plan, bshape, dtype=np.float32):
    """(reference, port) operators of one Schenk-like matrix, every shard
    kind stored: balanced uniform rows, or a cost-aware plan."""
    coo = generate_schenk_like(120, sparsity=0.95, seed=7)
    jcoo = JCOO(coo.rows, coo.cols, coo.vals, coo.shape)
    kw = dict(dtype=dtype, with_transpose=True, with_gram=True)
    if plan == "balanced":
        ref = jbsr.PartitionedBSR.from_coo(jcoo, 4, bshape, balance=True, **kw)
        port = PartitionedBSR.from_coo(coo, 4, bshape, balance=True, device="cpu", **kw)
    else:
        ref = jbsr.PartitionedBSR.from_coo(jcoo, 4, bshape, plan=JPlan.cost_aware(jcoo, 4), **kw)
        port = PartitionedBSR.from_coo(coo, 4, bshape, plan=TPlan.cost_aware(coo, 4),
                                       device="cpu", **kw)
    return ref, port


def _shard(op, kind):
    return getattr(op, f"{kind}_indices"), getattr(op, f"{kind}_data")


def _x(indices, data, k, seed, dtype=torch.float32):
    """A (J, C, bn, k) operand covering every column block the shard names."""
    J, bn = data.shape[0], data.shape[-1]
    C = int(indices.max()) + 1
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((J, C, bn, k)), dtype=dtype)


def _close(got, want, rtol):
    """Within rtol·max(1, max|want|), the scale of the product."""
    want = np.asarray(want, dtype=np.float64)
    tol = rtol * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want, atol=tol, rtol=0)


def _packed_dense(packed: Packed, num_cols: int) -> np.ndarray:
    """The packed entries scattered back to (J*block_rows, num_cols)."""
    counts = (packed.row_ptr[1:] - packed.row_ptr[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(counts.numel()), counts)
    out = np.zeros((counts.numel(), num_cols), packed.val.numpy().dtype)
    out[rows.numpy(), packed.col.numpy()] = packed.val.numpy()
    return out


@pytest.mark.parametrize("bshape", TILES)
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("kind", KINDS)
def test_pack_round_trips(kind, plan, bshape):
    """The packed form densifies to the blocked-ELL shard, in CSR order."""
    _, port = _operators(plan, bshape)
    idx, data = _shard(port, kind)
    packed = pack(idx, data)
    J, R, S, bp, bn = data.shape
    C = int(idx.max()) + 1
    assert packed.row_ptr.dtype == packed.col.dtype == torch.int32
    assert packed.row_ptr.shape == (J * R * bp + 1,) and packed.nnz == int(torch.count_nonzero(data))
    assert (packed.num_blocks, packed.block_rows, packed.bn) == (J, R * bp, bn)
    assert bool((packed.val != 0).all())
    got = _packed_dense(packed, C * bn).reshape(J, R * bp, C * bn)
    for j in range(J):
        np.testing.assert_array_equal(got[j], blocked_ell_to_dense(idx[j], data[j], C).numpy())
    # within a row the entries keep the ELL product's (slot, tile column) order
    slot_of_col = torch.full((J, R, C), S, dtype=torch.long)
    for s in range(S - 1, -1, -1):
        slot_of_col.scatter_(2, idx[:, :, s : s + 1].long(), s)
    counts = (packed.row_ptr[1:] - packed.row_ptr[:-1]).long()
    row = torch.repeat_interleave(torch.arange(J * R * bp), counts)
    j, r = row // (R * bp), (row % (R * bp)) // bp
    key = (row * S + slot_of_col[j, r, packed.col.long() // bn]) * bn + packed.col.long() % bn
    assert bool((key[1:] > key[:-1]).all())


@pytest.mark.parametrize("bshape", TILES)
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("kind", KINDS)
def test_packed_plain_matches_ell_plain_and_pallas(kind, plan, bshape):
    ref, port = _operators(plan, bshape)
    idx, data = _shard(port, kind)
    xb = _x(idx, data, 5, seed=len(kind))
    got = ops.spmm_packed(pack(idx, data), xb)  # CPU tensors: the plain version
    assert got.shape == (data.shape[0], data.shape[1] * data.shape[3], 5)
    torch.testing.assert_close(got, spmm_packed_plain(pack(idx, data), xb), atol=0, rtol=0)
    _close(got, spmm_plain(idx, data, xb), 1e-6)
    jidx, jdata = _shard(ref, kind)
    _close(got, jops.spmm(jidx, jdata, jnp.asarray(xb.numpy()), interpret=True), 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 5, 32, 40])
def test_packed_plain_widths_and_dtypes(k, dtype):
    ref, port = _operators("balanced", (8, 8), np.dtype(str(dtype).split(".")[1]))
    for kind in KINDS:
        idx, data = _shard(port, kind)
        xb = _x(idx, data, k, seed=k, dtype=dtype)
        got = ops.spmm_packed(pack(idx, data), xb)
        assert got.dtype == dtype
        _close(got, spmm_plain(idx, data, xb), 1e-6 if dtype == torch.float32 else 1e-12)
        # the Pallas kernel takes float32 tiles, so it is held at float32's 1e-4
        jidx, jdata = _shard(ref, kind)
        want = jops.spmm(jidx, jnp.asarray(np.asarray(jdata, np.float32)),
                         jnp.asarray(xb.float().numpy()), interpret=True)
        _close(got, want, 1e-4)


def test_all_zero_matrix_packs_to_nothing():
    empty = COOMatrix(np.empty(0, np.int32), np.empty(0, np.int32), np.empty(0, np.float32), (16, 16))
    op = PartitionedBSR.from_coo(empty, 2, with_transpose=True, with_gram=True, device="cpu")
    assert op.fwd_indices.shape[-1] == 1  # one zero padding slot
    packed = op.with_packed()
    for kind in KINDS:
        p = getattr(packed, f"{kind}_packed")
        assert p.nnz == 0 and int(p.row_ptr.abs().sum()) == 0
    xb = _x(op.fwd_indices, op.fwd_data, 3, seed=1)
    out = ops.spmm_packed(packed.fwd_packed, xb)
    assert out.shape == (2, 8, 3) and torch.count_nonzero(out) == 0
    jref = jops.spmm(jnp.asarray(op.fwd_indices.numpy()), jnp.asarray(op.fwd_data.numpy()),
                     jnp.asarray(xb.numpy()), interpret=True)
    _close(out, jref, 1e-4)


def test_explicit_zeros_are_dropped():
    """COO zeros are stored in the ELL tiles but not packed; the product is
    unchanged."""
    zeros = COOMatrix(np.array([0, 1, 9, 12]), np.array([3, 4, 12, 0]),
                      np.array([2.0, 0.0, 5.0, 0.0], np.float32), (16, 16))
    op = PartitionedBSR.from_coo(zeros, 1, device="cpu")
    packed = pack(op.fwd_indices, op.fwd_data)
    assert packed.nnz == 2
    assert packed.row_ptr.tolist() == [0, 1] + [1] * 8 + [2] * 7
    assert packed.col.tolist() == [3, 12] and packed.val.tolist() == [2.0, 5.0]
    xb = _x(op.fwd_indices, op.fwd_data, 4, seed=2)
    got = ops.spmm_packed(packed, xb)
    _close(got, spmm_plain(op.fwd_indices, op.fwd_data, xb), 1e-6)
    jidx, jdata = (jnp.asarray(t.numpy()) for t in (op.fwd_indices, op.fwd_data))
    _close(got, jops.spmm(jidx, jdata, jnp.asarray(xb.numpy()), interpret=True), 1e-4)


@pytest.mark.parametrize("plan", PLANS)
def test_operator_packed_forms(plan):
    """``with_packed`` builds all three forms, ``nbytes`` counts them,
    ``from_arrays(packed=True)`` rebuilds them and ``to_arrays`` is the
    reference's format, unchanged."""
    ref, port = _operators(plan, (8, 8))
    packed = port.with_packed()
    forms = [getattr(packed, f"{kind}_packed") for kind in KINDS]
    assert all(isinstance(p, Packed) for p in forms)
    assert port.fwd_packed is None  # derived on request, not by from_coo
    assert packed.nbytes == port.nbytes + sum(p.nbytes for p in forms)
    (pa, pm), (ra, rm) = packed.to_arrays(), ref.to_arrays()
    assert pm == rm and sorted(pa) == sorted(ra)
    for key in ra:
        np.testing.assert_array_equal(pa[key], np.asarray(ra[key]), err_msg=key)
    again = PartitionedBSR.from_arrays(pa, pm, device="cpu", packed=True)
    assert again.nbytes == packed.nbytes
    for kind in KINDS:
        a, b = getattr(again, f"{kind}_packed"), getattr(packed, f"{kind}_packed")
        for field in ("row_ptr", "col", "val"):
            torch.testing.assert_close(getattr(a, field), getattr(b, field), atol=0, rtol=0)
    assert PartitionedBSR.from_arrays(pa, pm, device="cpu").fwd_packed is None
    # the kernel path's products run on the packed forms: same numbers
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((120, 3)), dtype=torch.float32)
    y = torch.as_tensor(rng.standard_normal((4, port.p_pad, 3)), dtype=torch.float32)
    for got, want in (
        (packed.matvec(x, use_kernels=True), port.matvec(x)),
        (packed.rmatvec(y, use_kernels=True), port.rmatvec(y)),
        (packed.gram_mv(y, use_kernels=True), port.gram_mv(y)),
    ):
        _close(got, want, 1e-6)
    _close(packed.matvec(x, use_kernels=True), ref.matvec(jnp.asarray(x.numpy())), 1e-4)


@pytest.mark.parametrize("gram_solver", ["direct", "pcg"])
def test_solve_on_packed_operator_matches_reference(gram_solver):
    """A matrix-free solve whose kernel products run on the packed forms (as
    they do on the card) against the JAX package's kernel-path solve."""
    prob = make_problem(n=96, m=96, sparsity=0.95, seed=3, dtype=np.float32)
    B = prob.A @ np.random.default_rng(17).standard_normal((96, 3)).astype(np.float32)
    ref = jcore.prepare(prob.coo, mode="matfree", num_blocks=8, gram_solver=gram_solver,
                        use_kernels=True, gamma=2.0, eta=1.9)
    port = MatrixFreePreparedSolver.from_state(*ref.to_state(), device="cpu")
    assert port.op.fwd_packed is None  # on the CPU the solver keeps the ELL path
    packed = dataclasses.replace(port, op=port.op.with_packed())
    assert packed.memory_bytes > port.memory_bytes == ref.memory_bytes
    got, want = packed.solve(B, num_epochs=30), ref.solve(B, num_epochs=30)
    np.testing.assert_allclose(got.x, want.x, atol=1e-4)
    np.testing.assert_array_equal(got.history["inner_iters"], want.history["inner_iters"])
