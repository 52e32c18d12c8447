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
from repro_torch.kernels.spmm.pack import pack
from repro_torch.kernels.spmm.ref import (
    spmm_fused_packed_plain,
    spmm_fused_plain,
    spmm_packed_plain,
    spmm_plain,
)
from repro_torch.kernels.trisolve import ops as trisolve_ops
from repro_torch.kernels.trisolve.ref import trisolve_ref
from repro_torch.sparse import PartitionedBSR, generate_schenk_like
from repro_torch.sparse.bsr import _pad_cols
from repro_torch.sparse.matrix import COOMatrix

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def port_model(arch):
    """The port's reduced model of ``arch`` on the CPU from its own init
    (seed 0); a cross block's gate is opened to 0.5 (it initialises at 0,
    which would silence the patches)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import blocks, transformer

    cfg = reduced_config(get_config(arch))
    model = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, blocks.CrossBlock) and module.gated:
                module.gate.fill_(0.5)
    return cfg, model


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["upper", "lower_transposed"])
def test_trisolve_k1_ragged(cuda, dtype, case):
    transpose = case == "lower_transposed"
    r, y = _tri(2, 777, 1, dtype, seed=5)
    want = trisolve_ref(r, y, lower=transpose, transpose=transpose)
    got = trisolve_ops.trisolve(r.to(cuda), y.to(cuda), lower=transpose, transpose=transpose)
    rtol = 1e-4 if dtype == torch.float32 else 1e-9
    _relclose(got.cpu(), want, rtol)


@pytest.mark.parametrize("n", [4096, 4097])
@pytest.mark.parametrize("case", ["upper", "lower_transposed"])
def test_trisolve_stress_repeatable(cuda, n, case):
    """A large grid (8 x 65 row blocks x 8 k-tiles) launched 20 times: the
    ticket/flag order must never change a bit of the result."""
    J, k = 8, 64
    transpose = case == "lower_transposed"
    gen = torch.Generator(device=cuda).manual_seed(n)
    r = torch.randn(J, n, n, generator=gen, device=cuda).triu_() / n**0.5
    d = torch.randn(J, n, generator=gen, device=cuda)
    r.diagonal(dim1=1, dim2=2).copy_(torch.sign(d + 0.5) * (3.0 + d.abs()))
    y = torch.randn(J, n, k, generator=gen, device=cuda)
    first = trisolve_ops.trisolve(r, y, lower=transpose, transpose=transpose)
    for _ in range(19):
        again = trisolve_ops.trisolve(r, y, lower=transpose, transpose=transpose)
        assert torch.equal(again, first)
    _relclose(first, trisolve_ref(r, y, lower=transpose, transpose=transpose), 1e-4)


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


# -- the 3xTF32 split-K consensus update at awkward shapes -----------------------


def _factor(J, p, n, seed, dtype=torch.float32):
    """W as prepare() makes it: orthonormal rows for a wide block (p <= n),
    orthonormal columns (the QR factor Q, (p, n)) for a tall one."""
    rng = np.random.default_rng(seed)
    if p <= n:
        ws = [np.linalg.qr(rng.standard_normal((n, p)))[0].T for _ in range(J)]
    else:
        ws = [np.linalg.qr(rng.standard_normal((p, n)))[0] for _ in range(J)]
    return torch.as_tensor(np.stack(ws), dtype=torch.float32).contiguous().to(dtype)


def _cu_tol(v, want, bf16):
    """chip_smoke.py's tolerance: P v cancels most of v on tall blocks, so
    float32 rounding follows |v|, not the small result."""
    scale = max(float(v.float().abs().max()), float(want.float().abs().max()))
    return 0.05 + 0.05 * scale if bf16 else 2e-5 + 1e-4 * scale


# (J, p, n, k): odd and even n, p off the 64-row tile, tall (p > n) and wide,
# k in {1, 31, 32, 33, 64, 65}; the split plan of each is named in the id
CU_SHAPES = [
    pytest.param(2, 300, 129, 1, id="tall-n129-k1-s1x1-s2x2"),
    pytest.param(2, 300, 129, 31, id="tall-n129-k31-s1x1-s2x2"),
    pytest.param(3, 100, 1001, 32, id="wide-n1001-k32-s1x8-s2x1"),
    pytest.param(3, 100, 1001, 33, id="wide-n1001-k33-s1x8-s2x1"),
    pytest.param(2, 500, 257, 64, id="tall-n257-k64-s1x2-s2x4"),
    pytest.param(2, 70, 2049, 65, id="wide-n2049-k65-2groups-s1x13"),
    pytest.param(2, 1500, 700, 32, id="tall-n700-aligned-s1x5-s2x10"),
    pytest.param(1, 130, 4097, 31, id="wide-n4097-k31-s1x26"),
    pytest.param(3, 64, 256, 32, id="wide-n256-aligned-s1x2-s2x1"),
]


@pytest.mark.parametrize("J,p,n,k", CU_SHAPES)
@pytest.mark.parametrize("form", ["x_block_gamma", "project"])
def test_consensus_update_shapes(cuda, J, p, n, k, form):
    rng = np.random.default_rng(p * 7 + n + k)
    w = _factor(J, p, n, seed=n + k)
    xbar = torch.as_tensor(rng.standard_normal((J, n, k)), dtype=torch.float32)
    if form == "project":
        x, gamma, v = None, 1.0, xbar
        want = project_ref(w, xbar)
        got = project_ops.project(w.to(cuda), xbar.to(cuda))
    else:
        x = torch.as_tensor(rng.standard_normal((J, n, k)), dtype=torch.float32)
        gamma, v = torch.linspace(0.5, 1.5, J), xbar - x
        want = consensus_update_ref(w, x, xbar, gamma)
        got = project_ops.consensus_update(w.to(cuda), x.to(cuda), xbar.to(cuda), gamma.to(cuda))
    assert got.shape == (J, n, k) and got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, atol=_cu_tol(v, want, False), rtol=0)


@pytest.mark.parametrize("w_dtype,x_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float64, torch.float64),
    (torch.float32, torch.float64), (torch.float64, torch.float32),
    (torch.float32, torch.bfloat16),
])
@pytest.mark.parametrize("J,p,n,k", [(2, 300, 129, 33), (3, 100, 1001, 32)])
@pytest.mark.parametrize("with_x", [True, False])
def test_consensus_update_dtype_shapes(cuda, w_dtype, x_dtype, J, p, n, k, with_x):
    rng = np.random.default_rng(n + k)
    w = _factor(J, p, n, seed=n, dtype=w_dtype)
    xbar = torch.as_tensor(rng.standard_normal((J, n, k)), dtype=torch.float32).to(x_dtype)
    x = (torch.as_tensor(rng.standard_normal((J, n, k)), dtype=torch.float32).to(x_dtype)
         if with_x else torch.zeros_like(xbar))
    gamma = torch.linspace(0.5, 1.5, J)
    want = consensus_update_ref(w, x, xbar, gamma)
    got = project_ops.consensus_update(w.to(cuda), x.to(cuda) if with_x else None,
                                       xbar.to(cuda), gamma.to(cuda))
    assert got.dtype == x_dtype
    bf16 = torch.bfloat16 in (w_dtype, x_dtype)
    tol = _cu_tol(xbar.float() - x.float(), want, bf16)
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=tol, rtol=0)


def test_consensus_update_repeatable(cuda):
    """The main path's wide shape launched 20 times: the split-K partials are
    summed in one order whichever block finishes a tile, so no bit moves."""
    J, p, n, k = 8, 1164, 2327, 32
    gen = torch.Generator(device=cuda).manual_seed(3)
    w = torch.linalg.qr(torch.randn(J, n, p, generator=gen, device=cuda))[0].mT.contiguous()
    xbar = torch.randn(J, n, k, generator=gen, device=cuda)
    first = project_ops.project(w, xbar)
    for _ in range(19):
        assert torch.equal(project_ops.project(w, xbar), first)
    want = project_ref(w, xbar)
    torch.testing.assert_close(first, want, atol=_cu_tol(xbar, want, False), rtol=0)


@pytest.mark.parametrize("J,p,n,k", [(2, 1500, 700, 32), (2, 300, 129, 33)])
def test_consensus_update_graph_replay(cuda, J, p, n, k):
    """A CUDA-graph capture of the call, replayed twice, gives the eager bits:
    the scratch comes from the graph's pool and the tickets are zero again
    after every launch."""
    w = _factor(J, p, n, seed=1).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(J, n, k, generator=gen, device=cuda)
    xbar = torch.randn(J, n, k, generator=gen, device=cuda)
    gamma = torch.linspace(0.5, 1.5, J, device=cuda)
    eager = project_ops.consensus_update(w, x, xbar, gamma)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        project_ops.consensus_update(w, x, xbar, gamma)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = project_ops.consensus_update(w, x, xbar, gamma)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


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
    assert spmm_ops.launches == {"spmm": before["spmm"] + 1, "spmm_fused": before["spmm_fused"] + 1,
                                 "spmm_fused_packed": before["spmm_fused_packed"]}
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


def _shards(bshape, dtype, n=200, J=3, seed=0):
    """(name, indices, data) of the forward, transposed and Gram shards of a
    balanced Schenk-like operator, on the CPU."""
    coo = generate_schenk_like(n, sparsity=0.95, seed=seed)
    op = PartitionedBSR.from_coo(coo, J, bshape, dtype=np.dtype(str(dtype).split(".")[1]),
                                 with_transpose=True, with_gram=True, balance=True, device="cpu")
    return op, [("fwd", op.fwd_indices, op.fwd_data), ("tra", op.tra_indices, op.tra_data),
                ("gram", op.gram_indices, op.gram_data)]


@pytest.mark.parametrize("bshape", [(8, 8), (16, 8)])
@pytest.mark.parametrize("k", [1, 5, 32, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spmm_packed_on_all_shards(cuda, bshape, k, dtype):
    """The packed kernel against its plain versions, bit-identical across two
    launches and, on finite inputs, to the ELL fused kernel's forward output
    (the same products added in the same order)."""
    _, shards = _shards(bshape, dtype, seed=k)
    rng = np.random.default_rng(k)
    rtol = 1e-4 if dtype == torch.float32 else 1e-12
    for name, idx, data in shards:
        J, R, S, bp, bn = data.shape
        C = int(idx.max()) + 1
        xb = torch.as_tensor(rng.standard_normal((J, C, bn, k)), dtype=dtype)
        y = torch.as_tensor(rng.standard_normal((J, R, bp, k)), dtype=dtype)
        packed = pack(idx.to(cuda), data.to(cuda))
        got = spmm_ops.spmm_packed(packed, xb.to(cuda))
        assert got.dtype == dtype and got.shape == (J, R * bp, k), name
        _spmm_close(got.cpu(), spmm_plain(idx, data, xb), rtol)
        _spmm_close(got.cpu(), spmm_packed_plain(pack(idx, data), xb), rtol)
        assert torch.equal(spmm_ops.spmm_packed(packed, xb.to(cuda)), got), name
        ell, _ = spmm_ops.spmm_fused(idx.to(cuda), data.to(cuda), xb.to(cuda), y.to(cuda))
        assert torch.equal(got, ell), name


def test_spmm_packed_broadcast_empty_and_explicit_zeros(cuda):
    op, _ = _shards((8, 8), torch.float32, seed=3)
    packed = op.with_packed().fwd_packed
    dev_packed = pack(op.fwd_indices.to(cuda), op.fwd_data.to(cuda))
    x = torch.randn(op.shape[1], 6)
    xb = op._col_tiles(x)
    wide = _pad_cols(x.to(cuda), op.shape[1], 8)[None].expand(op.num_blocks, -1, -1, -1)
    assert wide.stride(0) == 0  # one (n, k) operand for every block
    got = spmm_ops.spmm_packed(dev_packed, wide)
    assert torch.equal(got, spmm_ops.spmm_packed(dev_packed, wide.contiguous()))
    _spmm_close(got.cpu(), spmm_packed_plain(packed, xb), 1e-4)
    # an all-zero matrix (one padding slot, no nonzeros) and COO zeros
    empty = COOMatrix(np.empty(0, np.int32), np.empty(0, np.int32), np.empty(0, np.float32), (16, 16))
    eop = PartitionedBSR.from_coo(empty, 2, device=cuda).with_packed()
    assert eop.fwd_packed.nnz == 0
    assert torch.count_nonzero(eop.matvec(torch.ones(16, 3, device=cuda), use_kernels=True)) == 0
    zeros = COOMatrix(np.array([0, 1, 9]), np.array([3, 4, 12]),
                      np.array([2.0, 0.0, 5.0], np.float32), (16, 16))
    zop = PartitionedBSR.from_coo(zeros, 1, device=cuda).with_packed()
    assert zop.fwd_packed.nnz == 2
    xz = torch.randn(16, 2, device=cuda)
    torch.testing.assert_close(zop.matvec(xz, use_kernels=True), zop.matvec(xz), atol=0, rtol=0)


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
        if kernels:  # one fused packed pass per epoch; the staged ELL kernel is off the path
            assert launched["spmm"] > 0 and launched["spmm_fused_packed"] == 40, launched
            assert launched["spmm_fused"] == 0, launched
        else:
            assert not any(launched.values()), launched
        # the kernel path carries the packed forms, and a restore rebuilds them
        packs = (prep.op.fwd_packed, prep.op.tra_packed, prep.op.gram_packed)
        assert all((p is not None) == kernels for p in packs)
        again = type(prep).from_state(*prep.to_state(), device=cuda)
        assert again.memory_bytes == prep.memory_bytes
    scale = float(np.abs(res[False].x).max())
    np.testing.assert_allclose(res[True].x, res[False].x, atol=2.5e-4 * scale)
    np.testing.assert_array_equal(res[True].history["inner_iters"].shape, (40, 6))


# -- the fused packed pass of the matrix-free epoch ----------------------------


def _fused_operands(bshape, k, dtype, cuda, n=200, J=3, seed=0):
    """A balanced Schenk-like operator on the CPU and its packed forms on the
    card, x (n, k) broadcast as the column tile view and y (J, Rp, bp, k)."""
    op, _ = _shards(bshape, dtype, n=n, J=J, seed=seed)
    fwd = pack(op.fwd_indices.to(cuda), op.fwd_data.to(cuda))
    tra = pack(op.tra_indices.to(cuda), op.tra_data.to(cuda))
    rng = np.random.default_rng(seed + k)
    x = torch.as_tensor(rng.standard_normal((n, k)), dtype=dtype)
    y = torch.as_tensor(rng.standard_normal((J, op.p_pad, k)), dtype=dtype)
    yb = y.reshape(J, -1, bshape[0], k)
    return op, fwd, tra, x, op._col_tiles(x), yb


@pytest.mark.parametrize("bshape", [(8, 8), (16, 8)])
@pytest.mark.parametrize("k", [1, 5, 32, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spmm_fused_packed_on_card(cuda, bshape, k, dtype):
    """The fused packed kernel against its plain version on the forward and
    transposed shards, bit-identical to the two spmm_packed launches; the
    operator's fused_project launches it (and nothing staged)."""
    op, fwd, tra, x, xb, yb = _fused_operands(bshape, k, dtype, cuda, seed=k)
    wide = xb[:1].to(cuda).expand_as(xb)  # x broadcast over the blocks, as the solver passes it
    got_f, got_t = spmm_ops.spmm_fused_packed(fwd, tra, wide, yb.to(cuda))
    assert got_f.dtype == got_t.dtype == dtype
    assert got_f.shape == (3, op.p_pad, k) and got_t.shape == (3, tra.block_rows, k)
    cpu = op.with_packed()
    want_f, want_t = spmm_fused_packed_plain(cpu.fwd_packed, cpu.tra_packed, xb, yb)
    rtol = 1e-4 if dtype == torch.float32 else 1e-12
    _spmm_close(got_f.cpu(), want_f, rtol)
    _spmm_close(got_t.cpu(), want_t, rtol)
    assert torch.count_nonzero(got_t[:, op.shape[1]:]) == 0  # the padded transpose rows
    assert torch.equal(got_f, spmm_ops.spmm_packed(fwd, wide))
    assert torch.equal(got_t, spmm_ops.spmm_packed(tra, yb.to(cuda)))
    dev_op = PartitionedBSR.from_coo(generate_schenk_like(200, sparsity=0.95, seed=k), 3, bshape,
                                     dtype=np.dtype(str(dtype).split(".")[1]),
                                     with_transpose=True, balance=True, device=cuda).with_packed()
    before = dict(spmm_ops.launches)
    f, g = dev_op.fused_project(x.to(cuda), yb.reshape(3, -1, k).to(cuda), use_kernels=True)
    assert spmm_ops.launches["spmm_fused_packed"] == before["spmm_fused_packed"] + 1
    assert spmm_ops.launches["spmm_fused"] == before["spmm_fused"]
    assert torch.equal(f, dev_op.matvec(x.to(cuda), use_kernels=True))
    assert torch.equal(g, dev_op.rmatvec(yb.reshape(3, -1, k).to(cuda), use_kernels=True))


@pytest.mark.parametrize("bshape", [(8, 8), (16, 8)])
def test_spmm_fused_packed_repeatable_and_graph_replay(cuda, bshape):
    """At the paper's n = 2327, J = 8, k = 32: 20 launches give the same bits,
    and so does a replayed CUDA graph of the call (the kernel allocates
    nothing and uses no atomics)."""
    _, fwd, tra, _, xb, yb = _fused_operands(bshape, 32, torch.float32, cuda, n=2327, J=8)
    xb, yb = xb[:1].to(cuda).expand_as(xb), yb.to(cuda)
    first = spmm_ops.spmm_fused_packed(fwd, tra, xb, yb)
    for _ in range(19):
        again = spmm_ops.spmm_fused_packed(fwd, tra, xb, yb)
        assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        spmm_ops.spmm_fused_packed(fwd, tra, xb, yb)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = spmm_ops.spmm_fused_packed(fwd, tra, xb, yb)
    for _ in range(2):
        out[0].zero_()
        out[1].zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], first[0]) and torch.equal(out[1], first[1])


def test_spmm_fused_packed_checks_on_card(cuda):
    op, fwd, tra, _, xb, yb = _fused_operands((8, 8), 4, torch.float32, cuda)
    xb, yb = xb.to(cuda), yb.to(cuda)
    with pytest.raises(ValueError, match="expected"):
        spmm_ops.spmm_fused_packed(fwd, tra, xb, yb.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        spmm_ops.spmm_fused_packed(fwd, tra, xb, yb.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(TypeError):
        spmm_ops.spmm_fused_packed(fwd, tra, xb, yb.double())
    before = dict(spmm_ops.launches)
    cpu = op.with_packed()
    spmm_ops.spmm_fused_packed(cpu.fwd_packed, cpu.tra_packed, xb.cpu(), yb.cpu())  # no launch
    assert spmm_ops.launches == before


# -- sessions, the watchdog and the baselines on the card ---------------------


def _drift_stream(A, num_updates, k=4, seed=0):
    """b_t = A(x_base + 2e-3·sin(0.25 t + i)), k streams as columns."""
    n = A.shape[1]
    x_base = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    phase = np.arange(n)[:, None]
    return [(A @ (x_base + 2e-3 * np.sin(0.25 * t + phase))).astype(np.float32)
            for t in range(num_updates)]


def _session_on_and_off(prep, A, cap, dense):
    """One stream through a kernels-on session and through a kernels-off
    session on the solver restored from its state: per-update solutions
    agree at the kernels' solve gates (1e-4·max(1, max|x|) dense,
    2.5e-4·max|x| matrix-free), every update meets tol, and the warm
    updates take fewer epochs than the cold first one."""
    bs = _drift_stream(A, 5)
    cold = prep.solve(bs[0], num_epochs=cap)
    tol = 3.0 * float(np.sqrt(np.max(cold.history["residual_sq"][-1])))
    arrays, meta = prep.to_state()
    meta = {**meta, "use_kernels": False}
    if meta.get("projector") is not None:
        meta["projector"] = {**meta["projector"], "kind": "implicit"}
    plain = type(prep).from_state(arrays, meta, device=prep.device)
    on = prep.open_session(num_epochs=cap, tol=tol)
    off = plain.open_session(num_epochs=cap, tol=tol)
    counts = []
    for b in bs:
        got, want = on.update(b), off.update(b)
        top = float(np.abs(want.x).max())
        atol = 1e-4 * max(1.0, top) if dense else 2.5e-4 * top
        np.testing.assert_allclose(got.x, want.x, atol=atol)
        assert float(np.sqrt(np.max(got.final_residual))) <= tol
        assert got.assess_health(tol).ok
        counts.append(int(got.iterations_to_tol(tol).sum()))
    assert max(counts[1:]) < counts[0], counts
    return counts


def test_dense_session_kernels_match_plain_on_card(cuda):
    from repro_torch.core import prepare
    from repro_torch.sparse import make_problem

    prob = make_problem(n=256, m=1024, seed=3, dtype=np.float32)
    prep = prepare(prob.A, num_blocks=8, materialize_p=False, use_kernels=True, device=cuda)
    assert prep.projector[0] == "kernels"
    before = (trisolve_ops.launches, project_ops.launches)
    _session_on_and_off(prep, prob.A, 200, dense=True)
    assert trisolve_ops.launches > before[0] and project_ops.launches > before[1]


def test_matfree_session_kernels_match_plain_on_card(cuda):
    from repro_torch.core import prepare
    from repro_torch.sparse import make_problem

    prob = make_problem(n=256, m=256, sparsity=0.98, seed=2, dtype=np.float32)
    prep = prepare(prob.coo, mode="matfree", num_blocks=8, use_kernels=True, gamma=2.0,
                   eta=1.9, device=cuda)
    before = dict(spmm_ops.launches)
    _session_on_and_off(prep, prob.A, 200, dense=False)
    assert spmm_ops.launches["spmm_fused_packed"] - before["spmm_fused_packed"] == 6 * 200
    assert spmm_ops.launches["spmm_fused"] == before["spmm_fused"]


@pytest.mark.parametrize("method", ["dgd", "cgnr"])
def test_baselines_on_card_match_cpu(cuda, method):
    """One carried state on the card and on the CPU: the same step size,
    and solutions within 1e-4·max(1, max|x|) (cgnr over its early epochs)."""
    from repro_torch.core import PreparedSolver, prepare
    from repro_torch.sparse import make_problem

    prob = make_problem(n=256, m=1024, seed=3, dtype=np.float32)
    B = prob.A @ np.random.default_rng(1).standard_normal((256, 8)).astype(np.float32)
    card = prepare(prob.A, method=method, num_blocks=8, device=cuda)
    cpu = PreparedSolver.from_state(*card.to_state(), device="cpu")
    assert card.factors == cpu.factors
    if method == "dgd":  # one start vector from the host generator on both devices
        own = prepare(prob.A, method="dgd", num_blocks=8, device="cpu").factors[0]
        assert card.factors[0] == pytest.approx(own, rel=1e-5)
    epochs = 80 if method == "dgd" else 10
    got, want = card.solve(B, num_epochs=epochs), cpu.solve(B, num_epochs=epochs)
    np.testing.assert_allclose(got.x, want.x, atol=1e-4 * max(1.0, float(np.abs(want.x).max())))
    np.testing.assert_allclose(got.history["residual_sq"][:5], want.history["residual_sq"][:5],
                               rtol=1e-4)
    assert got.gamma is None and got.assess_health().ok


# -- serving on the card -------------------------------------------------------


@pytest.mark.parametrize("path", ["dense", "matfree"])
def test_served_poisson_replay_through_the_kernels(cuda, path):
    """A small Poisson replay through the port's SolveServer on the card,
    kernels on: every request answered by its own b, within the kernels'
    solve gate of a direct solve of the same columns at the served width
    and within one epoch of it; the served batches launch the path's hand
    kernels (one trisolve and one consensus update per epoch dense, one
    fused packed pass per epoch and no staged pass matrix-free)."""
    import asyncio

    from repro_torch.serving import SolveServer, replay_trace
    from repro_torch.sparse import make_problem

    cap, width, count = 200, 16, 64
    if path == "dense":
        prob = make_problem(n=256, m=1024, seed=3, dtype=np.float32)
        system, kw = prob.A, dict(num_blocks=8, materialize_p=False, mode="dense")
    else:
        prob = make_problem(n=256, m=256, sparsity=0.98, seed=2, dtype=np.float32)
        system, kw = prob.coo, dict(mode="matfree", num_blocks=8, gamma=2.0, eta=1.9)
    kw = dict(kw, use_kernels=True, device="cuda")
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((256, count)).astype(np.float32)
    rhs = (prob.A @ xs).astype(np.float32)
    gaps = rng.exponential(1.0 / 2000.0, size=count)
    gaps[0] = 0.0

    async def serve():
        async with SolveServer(max_batch=width, max_wait_ms=5.0, num_epochs=cap,
                               prepare_kwargs=kw) as server:
            fp = server.register(system)
            prep = server.pool.get(fp)
            cold = prep.solve(rhs[:, :width], num_epochs=cap)
            server.tol = tol = 3.0 * float(np.sqrt(np.max(cold.history["residual_sq"][-1])))
            before = {"trisolve": trisolve_ops.launches, "project": project_ops.launches,
                      **spmm_ops.launches}
            results = await replay_trace(server, fp, rhs, gaps)
            after = {"trisolve": trisolve_ops.launches, "project": project_ops.launches,
                     **spmm_ops.launches}
            return prep, tol, results, {k: after[k] - before[k] for k in after}, server.stats()

    prep, tol, results, launches, stats = asyncio.run(asyncio.wait_for(serve(), 300))
    nb = stats["batches"]
    assert stats["requests"] == count and len(results) == count
    for i in range(0, count, width):
        direct = prep.solve(rhs[:, i:i + width], num_epochs=cap, tol=tol)
        its = direct.iterations_to_tol(tol)
        for j in range(width):
            got, want = results[i + j], direct.x[:, j]
            top = float(np.abs(want).max())
            atol = 1e-4 * max(1.0, top) if path == "dense" else 2.5e-4 * top
            np.testing.assert_allclose(got.x, want, atol=atol)
            assert abs(got.iterations - int(its[j])) <= 1 and got.converged
    if path == "dense":
        assert launches["trisolve"] == nb and launches["project"] == cap * nb, launches
    else:
        assert launches["spmm_fused_packed"] == cap * nb and launches["spmm"] >= nb, launches
        assert launches["spmm_fused"] == 0, launches


@pytest.mark.parametrize("arch", ["granite-3-2b", "granite-3-8b", "gemma-7b", "qwen1.5-32b"])
def test_reduced_dense_forward_on_card_matches_cpu(cuda, arch):
    """The model stack's serving path on the card against the port's CPU
    path from the same weights: prefill logits at 1e-4·max|logits|, a
    4-step decode continuation at 2e-2·scale, prefill on and off giving the
    same greedy tokens on the card."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import transformer
    from repro_torch.serving.decode import generate

    cfg = dataclasses.replace(reduced_config(get_config(arch)), num_layers=3,
                              layer_types=("dense",) * 3)
    cpu = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    card = transformer.Transformer(cfg, cuda)
    card.load_state_dict(cpu.state_dict())
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)))
    v = cfg.vocab_size
    outs = {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        logits, cache = transformer.prefill(model, toks[:, :8].to(model.device), cfg, 12)
        steps = [transformer.decode_step(model, cache, toks[:, i:i + 1].to(model.device), i,
                                         cfg)[0][:, 0, :v].cpu() for i in range(8, 12)]
        outs[name] = (logits[..., :v].cpu(), torch.stack(steps, 1))
    scale = float(outs["cpu"][0].abs().max())
    torch.testing.assert_close(outs["cuda"][0], outs["cpu"][0], atol=1e-4 * scale, rtol=0)
    scale = float(outs["cpu"][1].abs().max())
    torch.testing.assert_close(outs["cuda"][1], outs["cpu"][1], atol=2e-2 * scale, rtol=0)
    prompts = toks[:, :6].to(cuda)
    torch.testing.assert_close(generate(card, cfg, prompts, max_new=5),
                               generate(card, cfg, prompts, max_new=5, use_prefill=False),
                               atol=0, rtol=0)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v2-236b", "zamba2-7b",
                                  "xlstm-1.3b", "llama-3.2-vision-90b", "whisper-small"])
def test_reduced_families_on_card_match_cpu(cuda, arch):
    """The six families of item 10b at ``reduced_config`` on the card against
    the port's CPU path from the same weights (a cross gate opened to 0.5):
    train-mode logits and prefill logits at 1e-4·max, a 4-step decode
    continuation at 2e-2·scale, the MoE routing's expert ids equal, every
    output finite."""
    from repro_torch.models import moe, transformer

    cfg, cpu = port_model(arch)
    card = transformer.Transformer(cfg, cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 12)))
    aux = {}
    if cfg.vision_seq:
        aux["patches"] = torch.as_tensor(0.1 * rng.standard_normal((2, cfg.vision_seq, cfg.d_model)),
                                         dtype=torch.float32)
    if cfg.is_encdec:
        aux["enc_frames"] = torch.as_tensor(
            0.1 * rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)), dtype=torch.float32)
    v = cfg.vocab_size
    outs = {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        dev = model.device
        a = {k: x.to(dev) for k, x in aux.items()} or None
        with moe.record_routing(model) as routed:
            hid, _, _ = transformer.forward_hidden(model, toks.to(dev), cfg, aux=a)
            full = transformer.logits_from_hidden(model, hid, cfg)[..., :v].cpu()
            logits, cache = transformer.prefill(model, toks[:, :8].to(dev), cfg, 12, aux=a)
            steps = [transformer.decode_step(model, cache, toks[:, i:i + 1].to(dev), i, cfg,
                                             aux=a)[0][:, 0, :v].cpu() for i in range(8, 12)]
        outs[name] = (full, logits[..., :v].cpu(), torch.stack(steps, 1),
                      [r[0].cpu() for r in routed])
    for got, want, rtol in zip(outs["cuda"][:3], outs["cpu"][:3], (1e-4, 1e-4, 2e-2)):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, atol=rtol * float(want.abs().max()), rtol=0)
    # each MoE layer routes once in the forward, once in prefill, 4 decode steps
    moe_layers = cfg.types.count("moe") + cfg.types.count("mla_moe")
    assert len(outs["cuda"][3]) == len(outs["cpu"][3]) == 6 * moe_layers
    for got, want in zip(outs["cuda"][3], outs["cpu"][3]):
        assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v2-236b", "gemma-7b",
                                  "granite-3-2b", "granite-3-8b", "llama-3.2-vision-90b",
                                  "qwen1.5-32b", "whisper-small", "xlstm-1.3b", "zamba2-7b"])
def test_reduced_train_step_on_card_matches_cpu(cuda, arch):
    """One ``loss_fn`` step with gradients at ``reduced_config`` in f32
    compute on the card against the port's CPU path from the same weights
    and batch (``chip_smoke.py`` phase 14 (a)): the loss within 1e-5
    relative, every gradient within 1e-4·max|g|, the MoE routing's expert
    ids equal first; then the arch's own bf16 compute on the card gives a
    finite loss and finite gradients."""
    import dataclasses

    from repro_torch.models import moe, transformer

    base, cpu = port_model(arch)
    cfg = dataclasses.replace(base, dtype="float32")
    card = transformer.Transformer(base, cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 17))
    batch = {"tokens": torch.as_tensor(toks[:, :-1]), "targets": torch.as_tensor(toks[:, 1:])}
    if cfg.vision_seq:
        batch["patches"] = torch.as_tensor(
            0.1 * rng.standard_normal((2, cfg.vision_seq, cfg.d_model)), dtype=torch.float32)
    if cfg.is_encdec:
        batch["enc_frames"] = torch.as_tensor(
            0.1 * rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)), dtype=torch.float32)
    outs = {}
    for model, c in ((cpu, cfg), (card, cfg), (card, base)):
        model.requires_grad_(True).zero_grad(set_to_none=True)
        with moe.record_routing(model) as routed:
            loss, _ = transformer.loss_fn(model, {k: v.to(model.device) for k, v in batch.items()},
                                          c)
        loss.backward()
        grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
                 for n, p in model.named_parameters()}
        outs[(model.device.type, c.dtype)] = (float(loss.detach()), grads,
                                              [r[0].cpu() for r in routed])
    (l_c, g_c, r_c), (l_g, g_g, r_g) = outs[("cpu", "float32")], outs[("cuda", "float32")]
    assert len(r_g) == len(r_c) and all(torch.equal(a, b) for a, b in zip(r_g, r_c))
    assert l_g == pytest.approx(l_c, rel=1e-5)
    gmax = max(float(g.abs().max()) for g in g_c.values())
    for name, want in g_c.items():
        torch.testing.assert_close(g_g[name], want, atol=1e-4 * gmax, rtol=0)
    l_b, g_b, _ = outs[("cuda", "bfloat16")]
    assert np.isfinite(l_b) and all(bool(torch.isfinite(g).all()) for g in g_b.values())
