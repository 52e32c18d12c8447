"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``gpu`` and skips without CUDA; run them on a
machine with an H100 with ``python -m pytest -m gpu tests/test_torch_cuda.py``.

This file imports no jax: the machine with the card has none.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.project import ops as project_ops
from repro_torch.kernels.project.ref import consensus_update_ref, project_ref
from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.kernels.spmm.ref import spmm_fused_plain, spmm_plain
from repro_torch.kernels.trisolve import ops as trisolve_ops
from repro_torch.kernels.trisolve.ref import trisolve_ref
from repro_torch.sparse import PartitionedBSR, generate_schenk_like
from repro_torch.sparse.bsr import _pad_cols

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tri(J, n, k, dtype, seed, lower=False):
    rng = np.random.default_rng(seed)
    r = np.triu(rng.standard_normal((J, n, n)))
    di = np.arange(n)
    r[:, di, di] = np.sign(r[:, di, di] + 0.5) * (3.0 + np.abs(r[:, di, di]))
    if lower:
        r = np.ascontiguousarray(np.swapaxes(r, 1, 2))
    y = rng.standard_normal((J, n, k))
    return torch.as_tensor(r, dtype=dtype), torch.as_tensor(y, dtype=dtype)


def _relclose(got, want, rtol):
    scale = max(float(want.abs().max()), 1.0)
    torch.testing.assert_close(got, want, atol=rtol * scale, rtol=rtol)


@pytest.mark.parametrize("n,k", [(1, 1), (63, 3), (64, 8), (65, 9), (130, 32), (300, 5)])
@pytest.mark.parametrize("case", ["upper", "lower", "lower_transposed"])
def test_trisolve_f32(cuda, n, k, case):
    lower = case != "upper"
    transpose = case == "lower_transposed"
    r, y = _tri(3, n, k, torch.float32, seed=n * 10 + k, lower=case == "lower")
    want = trisolve_ref(r, y, lower=lower, transpose=transpose)
    got = trisolve_ops.trisolve(r.to(cuda), y.to(cuda), lower=lower, transpose=transpose)
    _relclose(got.cpu(), want, 1e-4)


@pytest.mark.parametrize("transpose", [False, True])
def test_trisolve_f64(cuda, transpose):
    r, y = _tri(2, 200, 7, torch.float64, seed=3)
    want = trisolve_ref(r, y, lower=transpose, transpose=transpose)
    got = trisolve_ops.trisolve(r.to(cuda), y.to(cuda), lower=transpose, transpose=transpose)
    torch.testing.assert_close(got.cpu(), want, atol=1e-9, rtol=1e-9)


def _proj_inputs(J, p, n, k, w_dtype, x_dtype, seed):
    rng = np.random.default_rng(seed)
    ws = [np.linalg.qr(rng.standard_normal((n, p)))[0].T for _ in range(J)]
    w = torch.as_tensor(np.stack(ws), dtype=torch.float32).contiguous().to(w_dtype)
    x = torch.as_tensor(rng.standard_normal((J, n, k)), dtype=torch.float32).to(x_dtype)
    xbar = torch.as_tensor(rng.standard_normal((J, n, k)), dtype=torch.float32).to(x_dtype)
    return w, x, xbar


@pytest.mark.parametrize("J,p,n,k", [(1, 1, 8, 1), (2, 7, 33, 3), (3, 40, 129, 33), (4, 65, 300, 32)])
@pytest.mark.parametrize("gamma", [1.0, 0.35, "per_block"])
def test_consensus_update_f32(cuda, J, p, n, k, gamma):
    w, x, xbar = _proj_inputs(J, p, n, k, torch.float32, torch.float32, seed=p + n)
    if gamma == "per_block":
        gamma = torch.linspace(0.5, 1.5, J)
    want = consensus_update_ref(w, x, xbar, gamma)
    g_dev = gamma.to(cuda) if isinstance(gamma, torch.Tensor) else gamma
    got = project_ops.consensus_update(w.to(cuda), x.to(cuda), xbar.to(cuda), g_dev)
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("w_dtype,x_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float64, torch.float64), (torch.float32, torch.float64),
])
def test_consensus_update_dtypes(cuda, w_dtype, x_dtype):
    w, x, xbar = _proj_inputs(2, 24, 300, 5, w_dtype, x_dtype, seed=11)
    want = consensus_update_ref(w, x, xbar, 0.9)
    got = project_ops.consensus_update(w.to(cuda), x.to(cuda), xbar.to(cuda), 0.9)
    assert got.dtype == x_dtype
    tol = 0.05 if torch.bfloat16 in (w_dtype, x_dtype) else 2e-5
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=tol, rtol=tol)


def test_project_is_x0_gamma1(cuda):
    w, _, v = _proj_inputs(3, 16, 256, 4, torch.float32, torch.float32, seed=5)
    got = project_ops.project(w.to(cuda), v.to(cuda))
    torch.testing.assert_close(got.cpu(), project_ref(w, v), atol=2e-5, rtol=1e-4)


def test_backward_matches_cpu(cuda):
    w, x, xbar = _proj_inputs(2, 8, 64, 3, torch.float32, torch.float32, seed=2)
    grads = []
    for dev in ("cpu", cuda):
        ww, xx, xb = (t.detach().to(dev).requires_grad_() for t in (w, x, xbar))
        (project_ops.consensus_update(ww, xx, xb, 0.7) ** 2).sum().backward()
        grads.append([t.grad.cpu() for t in (ww, xx, xb)])
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


def test_launch_counters_and_checks(cuda):
    r, y = _tri(1, 10, 2, torch.float32, seed=0)
    before = trisolve_ops.launches
    trisolve_ops.trisolve(r.to(cuda), y.to(cuda))
    assert trisolve_ops.launches == before + 1
    trisolve_ops.trisolve(r, y)  # the CPU path launches nothing
    assert trisolve_ops.launches == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        trisolve_ops.trisolve(r.to(cuda).mT, y.to(cuda))
    with pytest.raises(TypeError):
        trisolve_ops.trisolve(r.to(cuda).half(), y.to(cuda).half())
    with pytest.raises(ValueError, match="expected"):
        trisolve_ops.trisolve(r.to(cuda), y)
    w, x, xbar = _proj_inputs(1, 4, 16, 2, torch.float32, torch.float32, seed=0)
    before = project_ops.launches
    project_ops.consensus_update(w.to(cuda), x.to(cuda), xbar.to(cuda))
    assert project_ops.launches == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        project_ops.consensus_update(w.to(cuda), x.to(cuda).mT.contiguous().mT, xbar.to(cuda))


@pytest.mark.parametrize("num_blocks", [2, 8])
def test_slice_kernels_match_plain_on_card(cuda, num_blocks):
    from repro_torch.core import prepare
    from repro_torch.sparse import make_problem

    prob = make_problem(n=96, m=384, seed=4, dtype=np.float32)
    rng = np.random.default_rng(1)
    B = prob.A @ rng.standard_normal((96, 6)).astype(np.float32)
    res = {}
    for kernels in (True, False):
        prep = prepare(prob.A, num_blocks=num_blocks, materialize_p=False,
                       use_kernels=kernels, device=cuda)
        res[kernels] = prep.solve(B, num_epochs=30)
    np.testing.assert_allclose(res[True].x, res[False].x, atol=1e-4)


# -- the blocked-ELL SpMM kernels ---------------------------------------------


def _ell_operands(bshape, k, seed, dtype=torch.float32, n=200, J=3):
    """Forward shards of a Schenk-like matrix, x as the (J, C, bn, k) tile
    view and y (J, R, bp, k), on the CPU in ``dtype``."""
    coo = generate_schenk_like(n, sparsity=0.95, seed=seed)
    op = PartitionedBSR.from_coo(coo, J, bshape, dtype=np.dtype(str(dtype).split(".")[1]),
                                 device="cpu")
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((J, n, k)), dtype=dtype)
    xb = _pad_cols(x, n, bshape[1]).contiguous()
    R = op.fwd_indices.shape[1]
    y = torch.as_tensor(rng.standard_normal((J, R, bshape[0], k)), dtype=dtype)
    return op.fwd_indices, op.fwd_data, xb, y


def _spmm_close(got, want, rtol):
    """atol rtol + rtol·max|want|, the reference's tolerance scaled to the
    data (tests/test_kernel_spmm.py)."""
    tol = rtol + rtol * float(want.abs().max())
    torch.testing.assert_close(got, want, atol=tol, rtol=0)


SPMM_TILES = [(8, 8), (4, 16), (8, 128), (16, 8), (128, 128), (3, 5)]


@pytest.mark.parametrize("bshape", SPMM_TILES)
@pytest.mark.parametrize("k", [1, 32, 37])
def test_spmm_f32(cuda, bshape, k):
    idx, data, xb, y = _ell_operands(bshape, k, seed=k + bshape[0])
    dev = [t.to(cuda) for t in (idx, data, xb, y)]
    _spmm_close(spmm_ops.spmm(*dev[:3]).cpu(), spmm_plain(idx, data, xb), 1e-4)
    fwd, contrib = spmm_ops.spmm_fused(*dev)
    want_fwd, want_contrib = spmm_fused_plain(idx, data, xb, y)
    _spmm_close(fwd.cpu(), want_fwd, 1e-4)
    _spmm_close(contrib.cpu(), want_contrib, 1e-4)


@pytest.mark.parametrize("bshape", [(8, 8), (128, 128)])
def test_spmm_f64(cuda, bshape):
    idx, data, xb, y = _ell_operands(bshape, 5, seed=3, dtype=torch.float64)
    dev = [t.to(cuda) for t in (idx, data, xb, y)]
    out = spmm_ops.spmm(*dev[:3])
    assert out.dtype == torch.float64
    _spmm_close(out.cpu(), spmm_plain(idx, data, xb), 1e-12)
    fwd, contrib = spmm_ops.spmm_fused(*dev)
    want_fwd, want_contrib = spmm_fused_plain(idx, data, xb, y)
    _spmm_close(fwd.cpu(), want_fwd, 1e-12)
    _spmm_close(contrib.cpu(), want_contrib, 1e-12)


def test_spmm_broadcast_x_and_checks(cuda):
    idx, data, xb, y = (t.to(cuda) for t in _ell_operands((8, 8), 4, seed=1))
    wide = xb[:1].expand_as(xb)  # one operand for every block, stride 0
    torch.testing.assert_close(spmm_ops.spmm(idx, data, wide),
                               spmm_ops.spmm(idx, data, wide.contiguous()), atol=0, rtol=0)
    before = dict(spmm_ops.launches)
    spmm_ops.spmm(idx, data, xb)
    spmm_ops.spmm_fused(idx, data, xb, y)
    assert spmm_ops.launches == {"spmm": before["spmm"] + 1, "spmm_fused": before["spmm_fused"] + 1}
    spmm_ops.spmm(idx.cpu(), data.cpu(), xb.cpu())  # the CPU path launches nothing
    assert spmm_ops.launches["spmm"] == before["spmm"] + 1
    with pytest.raises(TypeError, match="int32"):
        spmm_ops.spmm(idx.long(), data, xb)
    with pytest.raises(TypeError):
        spmm_ops.spmm(idx, data.half(), xb.half())
    with pytest.raises(TypeError):
        spmm_ops.spmm(idx, data, xb.double())
    with pytest.raises(ValueError, match="contiguous"):
        spmm_ops.spmm(idx, data.transpose(-1, -2).contiguous().transpose(-1, -2), xb)
    with pytest.raises(ValueError, match="expected"):
        spmm_ops.spmm(idx, data, xb.cpu())


@pytest.mark.parametrize("gram_solver", ["direct", "pcg"])
def test_matfree_kernels_match_plain_on_card(cuda, gram_solver):
    from repro_torch.core import prepare
    from repro_torch.sparse import make_problem

    prob = make_problem(n=256, m=256, sparsity=0.98, seed=2, dtype=np.float32)
    B = prob.A @ np.random.default_rng(1).standard_normal((256, 6)).astype(np.float32)
    res = {}
    for kernels in (True, False):
        before = dict(spmm_ops.launches)
        prep = prepare(prob.coo, mode="matfree", num_blocks=8, gram_solver=gram_solver,
                       use_kernels=kernels, gamma=2.0, eta=1.9, device=cuda)
        res[kernels] = prep.solve(B, num_epochs=40)
        launched = {key: spmm_ops.launches[key] - before[key] for key in before}
        assert (launched["spmm"] > 0 and launched["spmm_fused"] == 40) == kernels, launched
    scale = float(np.abs(res[False].x).max())
    np.testing.assert_allclose(res[True].x, res[False].x, atol=2.5e-4 * scale)
    np.testing.assert_array_equal(res[True].history["inner_iters"].shape, (40, 6))
