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
from repro_torch.kernels.trisolve import ops as trisolve_ops
from repro_torch.kernels.trisolve.ref import trisolve_ref

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
