"""The reader ``residual_roofline.solve``: the residual's least time from its
shapes over the mean device time per call of its two kernels, read from the
device trace's aggregates; None without the kernel in the trace (a program
that computes the residual otherwise), on the matrix-free path and in the
served cell."""
import types

import pytest

from perfbench.harness import cell as cell_mod
from perfbench.harness.profiling import TraceStats

NAME = "residual_roofline.solve"
KERNEL = ("void (anonymous namespace)::residual_kernel<(anonymous namespace)::Cfg<32, 64, 2, 3, 1> >"
          "(float const*, float const*, float const*, float*, int*, float*, float*, "
          "(anonymous namespace)::Shape)")
SPLIT = ("void (anonymous namespace)::xbar_split_kernel<(anonymous namespace)::Cfg<32, 64, 2, 3, 1> >"
         "(float const*, float*, (anonymous namespace)::Shape)")


def _ctx(ops, path="dense", served=False, J=8, p=2282, n=4563, k=32):
    trace = TraceStats()
    for name, (count, ns) in ops.items():
        trace.ops[name] = [count, ns]
    window = types.SimpleNamespace(latencies_ms=[1.0] if served else None, results=[],
                                   clean=None)
    return types.SimpleNamespace(window=window, trace=trace, J=J, p=p, n=n, k=k, path=path)


@pytest.mark.parametrize("J,p,n,k", [(8, 2282, 4563, 32), (8, 1164, 2327, 256)])
def test_reads_the_least_time_over_the_mean_call(J, p, n, k):
    """81 calls (x̄(0) and 80 epochs) in 11.826 + 0.324 ms of device time
    (the residual, the split of x̄), beside the kernels of the update pair:
    the share of the mean call, 0.15 ms, that the least time takes, computed
    here by hand."""
    ops = {KERNEL: (81, 11_826_000), SPLIT: (81, 324_000),
           "void wv_kernel<float, float, 32>(...)": (80, 9_000_000),
           "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x32x8_stage3_warpsize2x2x1": (3, 1e6)}
    flops = 2.0 * J * p * n * k + 3.0 * J * p * k
    nbytes = 4.0 * (J * p * n + n * k + J * p * k + k)
    least = max(flops / (495e12 / 3), nbytes / 3.35e12)
    got = cell_mod.reader("metrics", NAME)(_ctx(ops, J=J, p=p, n=n, k=k))
    assert got == pytest.approx(100.0 * least / 0.15e-3, rel=1e-12)
    # s5 (k = 32) is bound by A's bytes, t1 (k = 256) by the products
    assert (nbytes / 3.35e12 > flops / (495e12 / 3)) == (k == 32)


def test_reads_none_without_the_kernel():
    """A program that computes the residual with cuBLAS and ATen (the
    parent of the kernel): nothing to read."""
    ops = {"sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x32x8_stage3_warpsize2x2x1": (81, 2e7),
           "void wv_kernel<float, float, 32>(...)": (80, 9_000_000)}
    assert cell_mod.reader("metrics", NAME)(_ctx(ops)) is None
    ctx = _ctx({KERNEL: (81, 12_150_000)})
    ctx.trace = None  # an untraced run
    assert cell_mod.reader("metrics", NAME)(ctx) is None


def test_reads_none_on_the_matrix_free_path_and_in_the_served_cell():
    ops = {KERNEL: (81, 12_150_000)}
    read = cell_mod.reader("metrics", NAME)
    assert read(_ctx(ops)) > 0
    assert read(_ctx(ops, path="matfree")) is None
    assert read(_ctx(ops, served=True)) is None
