"""The plain reference against a float64 direct solve, against the port on
the CPU, and its control (TF32) against both."""
import numpy as np
import pytest
import torch

from perfbench.harness import problem
from perfbench.reference import dapc

P = {"m": 200, "n": 64, "sparsity": 0.9, "value_mean": 0.013, "value_std": 24.31}


def _system(seed):
    s = problem.make_system(P, seed, "cpu")
    return s.A.numpy(), s.rhs(4, purpose=0).numpy()


@pytest.mark.parametrize("m,n,J", [(120, 40, 4), (200, 64, 8), (96, 48, 4)])
def test_reference_converges_to_the_direct_solve(m, n, J):
    """On a small consistent, well-conditioned system the consensus reaches
    the float64 direct solution, and its residual falls to rounding."""
    rng = np.random.default_rng(m + n)
    A = rng.standard_normal((m, n))
    B = A @ rng.standard_normal((n, 3))
    ref = dapc.DapcReference(A, J, 1.0, 0.9)
    hist, x = ref.run(B, 400)
    direct = np.linalg.solve(A.T @ A, A.T @ B)
    err = np.linalg.norm(x.numpy() - direct, axis=0) / np.linalg.norm(direct, axis=0)
    assert err.max() < 1e-10
    h = hist.numpy()
    assert (h[-1] / h[0]).max() < 1e-20


def test_initial_solutions_solve_their_blocks():
    """x_j(0) = Q_j R_j⁻ᵀ b_j is the least-norm solution of block j."""
    A, B = _system(3)
    ref = dapc.DapcReference(A, 8, 1.0, 0.9)
    bvecs = ref.block(B)
    z = torch.linalg.solve_triangular(ref.R.mT, bvecs, upper=False)
    xs = ref.Q @ z
    np.testing.assert_allclose((ref.blocks @ xs).numpy(), bvecs.numpy(), rtol=0, atol=1e-8)
    pinv = torch.linalg.pinv(ref.blocks) @ bvecs
    np.testing.assert_allclose(xs.numpy(), pinv.numpy(), atol=1e-9)


def test_capture_reads_each_column_at_its_epoch():
    A, B = _system(4)
    ref = dapc.DapcReference(A, 8, 1.0, 0.9)
    h_all, _ = ref.run(B, 30)
    _, x10 = ref.run(B, 10)
    _, x30 = ref.run(B, 30)
    h, x = ref.run(B, 30, capture=[10, 30, 10, 30])
    np.testing.assert_array_equal(h.numpy(), h_all.numpy())
    np.testing.assert_array_equal(x[:, [0, 2]].numpy(), x10[:, [0, 2]].numpy())
    np.testing.assert_array_equal(x[:, [1, 3]].numpy(), x30[:, [1, 3]].numpy())


def test_reference_follows_the_port():
    """The port (float32, kernels' plain versions on the CPU) and the
    float64 reference agree to float32 rounding; the reference's mixing rows
    and blocks are the port's."""
    from repro_torch.core import prepare

    A, B = _system(5)
    prep = prepare(A, num_blocks=8, mode="wide", materialize_p=False, use_kernels=True,
                   device="cpu")
    res = prep.solve(B, num_epochs=60)
    ref = dapc.DapcReference(A, 8, 1.0, 0.9)
    np.testing.assert_allclose(ref.blocks.numpy(), prep.blocks.numpy(), rtol=1e-6, atol=1e-4)
    hist, x = ref.run(B, 60)
    err = np.linalg.norm(res.x - x.numpy(), axis=0) / np.linalg.norm(x.numpy(), axis=0)
    assert err.max() < 1e-4
    np.testing.assert_allclose(np.asarray(res.history["residual_sq"]), hist.numpy()[1:],
                               rtol=1e-3)


def test_tf32_rounding():
    t = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 1.0 + 3 * 2 ** -11, -3.14159],
                     dtype=torch.float32)
    got = dapc.tf32_round(t)
    assert got[0] == 1.0 and got[1] == 1.0  # a tie rounds to even
    assert got[2] == 1.0 + 2 ** -10
    assert got[3] == 1.0 + 2 ** -9  # a tie rounds to even
    assert abs(float(got[4]) + 3.14159) < 2 ** -10 * 4


@pytest.mark.parametrize("seed", [6, 7, 8])
def test_control_reads_far_above_the_program(seed):
    """The control (TF32 products) is at least 100x farther from the
    reference than float32 is, on every number."""
    from perfbench.harness import compare

    A, B = _system(seed)
    ref = dapc.DapcReference(A, 8, 1.0, 0.9)
    f32 = dapc.DapcReference(A, 8, 1.0, 0.9, precision="tf32")
    shells = [compare.Answer(b=B, x=np.zeros((64, 4)), iterations=None, history=None)]
    control = compare.judge(ref, compare.control_answers(f32, shells, 60, None), 60, None)
    hist, x = ref.run(B, 60)
    exact = compare.judge(ref, [compare.Answer(
        b=B, x=x.numpy(), iterations=np.full(4, 60), history=hist.numpy())], 60, None)
    assert exact["x_gap"] == 0.0 and exact["resid_gap"] == 0.0
    assert control["x_gap"] > 1e-4 and control["resid_gap"] > 1e-4
