"""The residual kernels' share of their roofline: the least time of one call
from its shapes over the mean device time per call of ``xbar_split_kernel``
(x̄ split once a call) and ``residual_kernel``, in the solve cells.

One call is the consensus loop's residual ‖A x̄ − b‖² of one epoch (or of
x̄(0)): A x̄ for the blocks A (J, p, n) and x̄ (n, k), then the subtraction,
the squares and the sums, 2·J·p·n·k + 3·J·p·k operations; it reads A, x̄ and
b (J, p, k) and writes the k sums. None on the matrix-free path (which has
its own residual), in the served cell, and where the program has no such
kernel."""
from perfbench.harness import counts
from perfbench.harness.readers import is_served, kernel_roofline


def least_seconds(J: int, p: int, n: int, k: int) -> float:
    flops = 2.0 * J * p * n * k + 3.0 * J * p * k
    nbytes = counts.F32 * (J * p * n + n * k + J * p * k + k)
    return counts.least_seconds(flops, nbytes)


def read(ctx):
    if is_served(ctx) or ctx.path != "dense":
        return None
    return kernel_roofline(ctx, ("xbar_split_kernel", "residual_kernel"),
                           least_seconds(ctx.J, ctx.p, ctx.n, ctx.k))
