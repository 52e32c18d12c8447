"""The yardstick's operations and bytes, pinned at the cells' shapes, and the
rule that no share of a roofline can pass 100%."""
import pytest
import torch

from perfbench.harness import counts

S5 = (8, 2282, 4563)
T1 = (8, 1164, 2327)


def test_peaks():
    assert counts.HBM_BYTES_PER_S == 3.35e12
    assert counts.F32_ACCURATE_FLOPS == pytest.approx(165e12)


def test_consensus_update_pinned():
    f, b = counts.consensus_update_call(*S5, 32)
    assert f == 4 * 8 * 2282 * 4563 * 32 + 8 * 4563 * 32
    assert b == 4 * (8 * 2282 * 4563 + 2 * 8 * 4563 * 32)
    assert counts.least_seconds(f, b) == pytest.approx(b / 3.35e12)  # bytes bound
    f, b = counts.consensus_update_call(*T1, 256)
    assert counts.least_seconds(f, b) == pytest.approx(f / 165e12)  # operations bound
    assert counts.least_seconds(f, b) * 1e3 == pytest.approx(0.1345, rel=1e-3)


def test_trisolve_pinned():
    f, b = counts.trisolve_call(8, 2282, 32)
    assert f == 8 * 32 * 2282 ** 2
    assert b == 4 * (8 * 2282 * 2283 / 2 + 2 * 8 * 2282 * 32)
    assert counts.least_seconds(f, b) * 1e3 == pytest.approx(0.026278, rel=1e-4)


def test_solve_pinned():
    # s5, k = 32, 80 epochs: bytes-bound epochs (W and the blocks, 666 MB)
    t = counts.solve_least_seconds(*S5, 32, 80)
    assert t * 1e3 == pytest.approx(80 * 0.202766 + 0.126440, rel=1e-5)


@pytest.mark.parametrize("J,p,n,k", [S5 + (32,), T1 + (256,), T1 + (32,), S5 + (1,)])
def test_call_counts_are_the_tensors_of_the_call(J, p, n, k):
    """Each input byte once, each output byte once: the bytes counted are
    exactly the bytes of the call's operands and result, no more."""
    meta = torch.device("meta")
    W, v = torch.empty(J, p, n, device=meta), torch.empty(J, n, k, device=meta)
    out = torch.empty(J, n, k, device=meta)
    nbytes = sum(t.numel() * t.element_size() for t in (W, v, out))
    assert counts.consensus_update_call(J, p, n, k)[1] == nbytes
    y = torch.empty(J, p, k, device=meta)
    tri = J * p * (p + 1) // 2 * 4  # the triangle alone
    assert counts.trisolve_call(J, p, k)[1] == tri + 2 * y.numel() * 4


@pytest.mark.parametrize("J,p,n,k", [S5 + (32,), T1 + (256,), T1 + (32,)])
def test_epoch_count_is_no_more_than_its_steps(J, p, n, k):
    """The epoch counted as one step reads each tensor once: it is never
    more than eq. 6, eq. 7 and the residual counted apart, so a fused
    implementation cannot read under it."""
    upd = (4 * J * p * n * k + 4 * J * n * k, 4 * (J * p * n + 2 * J * n * k + n * k))
    mean = ((J + 3) * n * k, 4 * (J * n * k + 2 * n * k))
    res = (2 * J * p * n * k + 3 * J * p * k, 4 * (J * p * n + n * k + J * p * k + k))
    f, b = counts.epoch(J, p, n, k)
    assert f == pytest.approx(upd[0] + mean[0] + res[0])
    assert b <= upd[1] + mean[1] + res[1]
    # the unavoidable bytes: W and the blocks once, x in and out, x̄ in and out, b
    assert b >= 4 * (2 * J * p * n + 2 * J * n * k + 2 * n * k + J * p * k)


@pytest.mark.parametrize("flops,nbytes", [(1e12, 1e6), (1e6, 1e12), (3.3e12, 3.35e12)])
def test_least_time_is_the_larger_bound(flops, nbytes):
    t = counts.least_seconds(flops, nbytes)
    assert t >= flops / (495e12 / 3) and t >= nbytes / 3.35e12
    assert t == max(flops / (495e12 / 3), nbytes / 3.35e12)
