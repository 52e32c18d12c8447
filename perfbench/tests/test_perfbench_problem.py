"""The frozen input generator against the port's ``make_problem``."""
import numpy as np
import pytest
import torch

from perfbench.harness import problem
from repro_torch.sparse.io import generate_schenk_like, make_problem


@pytest.mark.parametrize("n,m,seed", [(64, 256, 0), (97, 300, 5), (128, 128, 3)])
def test_core_equals_generate_schenk_like(n, m, seed):
    want = generate_schenk_like(n, sparsity=0.9, seed=seed)
    rows, cols, vals = problem.schenk_core(n, 0.9, 0.013, 24.31, seed)
    np.testing.assert_array_equal(rows, want.rows)
    np.testing.assert_array_equal(cols, want.cols)
    np.testing.assert_array_equal(vals, want.vals)


@pytest.mark.parametrize("n,m,seed", [(64, 256, 0), (97, 300, 5)])
def test_augmented_system_equals_make_problem(n, m, seed):
    """With make_problem's own mixing rows G, the generator's dense core and
    eq. 8 give make_problem's A: the core to the bit, G·A up to the order of
    the product's sums."""
    want = make_problem(n, m, sparsity=0.9, seed=seed)
    rows, cols, vals = problem.schenk_core(n, 0.9, 0.013, 24.31, seed)
    a_sq = problem.dense_core(rows, cols, vals, n, "cpu")
    g = np.random.default_rng(seed + 13).standard_normal((m - n, n)) / np.sqrt(n)
    got = problem.augment(a_sq, torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy()[:n], want.A[:n])
    np.testing.assert_allclose(got.numpy(), want.A, rtol=1e-12, atol=1e-12)


def test_system_is_seeded_and_consistent():
    p = {"m": 120, "n": 40, "sparsity": 0.9, "value_mean": 0.013, "value_std": 24.31}
    big = 2 ** 33 + 17  # seeds beyond 32 bits
    a, b = problem.make_system(p, big, "cpu"), problem.make_system(p, big, "cpu")
    assert torch.equal(a.A, b.A) and a.A.dtype == torch.float32
    assert not torch.equal(a.A, problem.make_system(p, big + 1, "cpu").A)
    B = a.rhs(3, purpose=0)
    assert torch.equal(B, b.rhs(3, purpose=0))
    x = torch.linalg.lstsq(a.A.double(), B.double()).solution
    resid = torch.linalg.norm(a.A.double() @ x - B.double()) / torch.linalg.norm(B.double())
    assert float(resid) < 1e-6  # B = A·X: consistent up to float32 rounding of B
