#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

1. prints the card (nvidia-smi name and power limit) and turns TF32 off;
2. builds the hand-written kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, in parallel) and prints nvcc's ``-Xptxas -v`` report;
3. holds each dense-path kernel against its plain PyTorch version on the
   card at the main path's shapes (and the consensus update at the dense
   scale run's W (8, 2048, 4096), k = 64), and times the kernel, the plain
   version and one PyTorch library call computing the same function (a
   yardstick only; the port never calls it); then times two design choices
   of the consensus update, ungated: W's unaligned rows against a copy
   padded to a multiple of 4 columns, and its split target;
4. drives the dense main path — ``repro_torch.launch.solve`` with
   ``--kernels --implicit-p`` at the paper's Table 1 shape m=9308, n=2327,
   k=32, 80 epochs, J=2 (tall: the upper trisolve) and J=8 (wide: the lower
   trisolve on Rᵀ) — with every launch counter zeroed just before and read
   just after, and checks the solution against the kernels-off solve on the
   card and the residual against the JAX package's CPU value; times a
   second, warm solve on each prepared solver and profiles one more with
   torch.profiler (device time by kernel, device busy share); then one
   timed, ungated scale run at n=4096, m=16384, J=8, k=64;
5. drives the matrix-free path the same way — ``--mode matfree --kernels``
   at the paper's square n=2327 (99.85% sparse), k=32, 300 epochs, J=8,
   with the accelerated (γ, η) = (2.0, 1.9) and the direct Gram solver;
   then ``--mode auto`` at n=16384, 100 epochs, which must resolve the
   matrix-free path with the PCG Gram solver. Each must launch the fused
   packed pass once per epoch and the staged ELL kernel never, and is checked
   against the kernels-off solver restored from its own state on the card
   (within 2.5e-4·max|x|), the n=2327 residual against the JAX package's CPU
   value. The warm solve's peak device memory and its largest difference
   from the cold solve are printed, and, ungated, one warm solve of the same
   solver without the transposed packed form, which takes the staged ELL
   pass and its ``index_add_`` scatter;
6. holds the SpMM kernels against their plain versions on the operators
   those runs prepared (forward, transposed and Gram shards): the
   packed-nonzero ``spmm_packed`` on each operator's packed form, the fused
   packed pass on the forward and transposed packed forms (also bit for bit
   against two ``spmm_packed`` launches), and the blocked-ELL ``spmm_fused``;
   each timed beside ``torch.sparse.mm`` (cuSPARSE) of the same shards laid
   out as block-diagonal CSR matrices (one call, or the pair for the fused
   pass). ``bound_ms`` counts the bytes the product needs (each nonzero's
   value and column, the row pointers, x, y and the outputs once),
   ``bound_ell_ms`` the stored ELL arrays;
7. runs the dgd and cgnr baselines through ``repro_torch.launch.solve
   --method dgd|cgnr`` at the Table 1 width (m=9308, n=2327, J=8, k=32, 80
   epochs; plain batched matmuls, no hand kernel), checks each residual
   against the JAX package's CPU value, prints dgd's step size beside the
   JAX package's, and times and profiles a warm solve;
8. replays a drifting stream (12 updates of 32 streams as columns, the
   reference's b_t = A(x_base + 2e-3·sin(0.25 t + i))) through a ``Session``
   over the kernels-on dense solver (the Table 1 wide system, implicit
   projector) and over the kernels-on matrix-free solver (n=2327, direct
   Gram solver), against independent cold solves at one tol (3x the cold
   floor at the 300-epoch cap): every update below tol and within 5·tol of
   its cold solve, the session's total epochs at most 0.7x the independent
   total, the watchdog all ok; one warm update's launches counted (one
   trisolve and 300 consensus updates dense; 300 fused packed passes, the
   warm start's ``spmm_packed`` and no staged pass matrix-free); the same
   stream on the kernels-off solver restored from each solver's state,
   held at the solve gates; and one warm-started session solve profiled;
9. plants a NaN in one column of b on both kernel paths, which the watchdog
   must flag alone, and checks that a matrix-free ``block_history`` solve
   returns x bit for bit, printing its per-block convergence report;
10. serves requests through the port's ``SolveServer`` (``repro_torch.serving``,
   kernels on, max_batch 32, 5 ms window, cap 300) on both systems: the
   serving command line's Poisson trace (256 requests at 2000 req/s; every
   request answered once, within the kernels-on/off gate (1e-4·max(1,
   max|x|) dense, 2.5e-4·max|x| matrix-free) of a direct solve of its column
   at the served width and within one epoch of it, the summed epochs within
   2% of the JAX package's, the served batches launching the path's
   kernels, counted around the replay), one profiled served batch, the
   session phases' streams as 32 one-column ``ServerSession``s (epochs
   within 2% of the JAX package's own server replay, at most 0.7x the
   independent solves'), 32 requests at max_batch 1 and 32 (printed), a
   checkpoint save and a restore by a fresh server with a pool of one (no
   prepare, served bits equal to the saved solver's, the evicted dense
   solver's memory released), and a fault plan on the dense replay (the
   poison fails alone, a one-shot error is redispatched, the watchdog flags
   the NaN column alone); prints the serving numbers beside the card line;
11. prints the kernel table as one JSON line (with a row per kernel of one
   warm session update and of one served batch, carrying the measured case
   of the same shapes), the card line again, and the ``{"ok": true,
   "device": ...}`` line last.

The kernel cases are timed twice: with CUDA events around
back-to-back calls (``ms``, which includes the Python wrapper's host cost
where a call is shorter than it) and as a CUDA-graph replay of the same
calls, which the card runs without waiting for the host (``device_ms``;
``library_device_ms`` for the library call).

Any failed check raises, so the run exits non-zero and prints no last line.
Without CUDA, or without the repository beside it, it exits non-zero too.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

SRC = Path(__file__).resolve().parent / "src"

# final_residual_sq_max of the JAX package on the CPU for the same solves:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.solve --n 2327 \
#       --m 9308 --blocks {2,8} --epochs 80 --rhs 32 --implicit-p
JAX_CPU_RESIDUAL = {2: 9.247297384717967e-06, 8: 2080.2412109375}
# ... and for the matrix-free solve:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.solve --n 2327 \
#       --m 2327 --blocks 8 --mode matfree --rhs 32 --epochs 300 --gamma 2.0 --eta 1.9
JAX_CPU_MATFREE_RESIDUAL = 7.070346832275391
# ... and for the baselines at the Table 1 width:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.solve --n 2327 \
#       --m 9308 --blocks 8 --epochs 80 --rhs 32 --method {dgd,cgnr}
JAX_CPU_BASELINE_RESIDUAL = {"dgd": 1777464.5, "cgnr": 205.1161346435547}
# dgd's step size 1/λ_max from the JAX package's prepare of that system (its
# power iteration starts at a jax.random vector, the port's at a torch one):
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import numpy as np, repro.core as c, \
#       repro.sparse as s; print(c.prepare(s.make_problem(n=2327, m=9308, seed=0, \
#       dtype=np.float32).A, method='dgd', num_blocks=8).factors[0])"
JAX_CPU_DGD_LR = 1.2971216161973197e-05
RESIDUAL_FACTOR = 10.0  # the card's residual must lie within 10x either way
# the drifting streams of the session phases (``drift_stream``), replayed by
# the JAX package on the CPU through ``replay_stream``, which imports nothing:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import chip_smoke, repro.core, \
#       repro.sparse; chip_smoke.print_stream_reference(repro.core.prepare, \
#       repro.sparse.make_problem)"
# session and independent totals of epochs-to-tol over the 12 updates, and tol
JAX_CPU_STREAM = {
    "dense": {"session": 2239, "independent": 22644, "tol": 52.462440490722656},
    "matfree": {"session": 3572, "independent": 38640, "tol": 9.843310117721558},
}
STREAM_UPDATES, STREAM_COLS, STREAM_SEED, STREAM_AMP = 12, 32, 2, 2e-3
# the epoch cap of every session solve: the JAX CPU replay reaches the
# reference streaming benchmark's 0.5 ratio at it (0.0989 dense, 0.0924
# matrix-free); the card is gated at the reference test's 0.7
STREAM_CAP = 300
SESSION_RATIO_GATE = 0.7
# the serving phases: the serving command line's Poisson trace (256 requests
# at 2000 req/s, seed 0) through a SolveServer of max_batch 32, 5 ms window,
# cap STREAM_CAP, on the session phases' systems
SERVE_REQUESTS, SERVE_RATE, SERVE_BATCH, SERVE_WAIT_MS = 256, 2000.0, 32, 5.0
# the JAX package on the CPU for the same traffic: the Poisson tol (3x the cold
# floor of the first 32 requests at the cap, as stream_tol) and the summed
# epochs-to-tol of the 256 requests at it (batched solves at the served width;
# a column's count does not depend on its batchmates), and the drifting
# streams' summed epochs-to-tol through the JAX package's own SolveServer
# (32 one-column sessions, the session phases' tol), which equal the direct
# sessions' JAX_CPU_STREAM totals:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import chip_smoke, repro.core, \
#       repro.sparse, repro.serving.queue; chip_smoke.print_serving_reference( \
#       repro.core.prepare, repro.sparse.make_problem, repro.serving.queue.SolveServer)"
JAX_CPU_SERVING = {
    "dense": {"poisson_tol": 56.739200592041016, "poisson_iterations": 13761,
              "drifting_iterations": 2239},
    "matfree": {"poisson_tol": 10.222836256027222, "poisson_iterations": 25451,
                "drifting_iterations": 3572},
}
SERVING_ITER_GATE = 0.02  # summed epochs-to-tol within 2% of the JAX package's
# kernels-on vs kernels-off matrix-free solutions, as a share of max|x|: the
# reference's own full-size gate between two float32 trajectories
# (benchmarks/sparse.py)
MATFREE_AGREEMENT = 2.5e-4

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the highest dense
# FLOP/s for each input type (f32 outside the tensor cores; f64 and bf16 on
# them), so that bound_ms is the least time the card could take. The
# consensus update runs its f32 products on the tensor cores as three TF32
# products (3xTF32, 495 TFLOP/s each), so its f32 operations count at a third
# of the TF32 rate; the kernels that still run f32 on CUDA cores keep 67.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12, "bfloat16": 989e12,
              "float32_3xtf32": 495e12 / 3}

TRISOLVE_SRC = "src/repro_torch/csrc/trisolve.cu"
PROJECT_SRC = "src/repro_torch/csrc/project.cu"
SPMM_SRC = "src/repro_torch/csrc/spmm.cu"
TRISOLVE_TPU = "src/repro/kernels/trisolve/trisolve.py:88"
PROJECT_TPU = "src/repro/kernels/project/project.py:71,84"
SPMM_TPU = "src/repro/kernels/spmm/spmm.py:75"
SPMM_FUSED_TPU = "src/repro/kernels/spmm/spmm.py:140"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls, timed
    with CUDA events after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int) -> float:
    """Mean device milliseconds per call without the host's cost of making
    it: ``iters`` calls captured in one CUDA graph (after a warm-up call on
    the capture stream), replayed once and timed with CUDA events. For calls
    that do not wait on the host (kernels, library calls)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, rate: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[rate] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def kernel_phase(torch, trisolve_ops, trisolve_ref, project_ops, project_ref, cu_ref):
    """Each kernel against its plain version at the main path's shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    def factors(J, rows, cols, dtype, tall):
        """W and R of the reduced QR of Gaussian blocks, as prepare() makes
        them: tall blocks (rows >= cols) give R (cols, cols), wide ones are
        factored through their transpose and give R (rows, rows)."""
        a = torch.randn(J, rows, cols, generator=gen, device=dev, dtype=torch.float64)
        if tall:
            q, r = torch.linalg.qr(a, mode="reduced")
            w = q
        else:
            q, r = torch.linalg.qr(a.mT, mode="reduced")
            w = q.mT
        return w.to(dtype).contiguous(), r.to(dtype).contiguous()

    def tri_case(name, J, n, k, dtype, lower, transpose, r):
        y = torch.randn(J, n, k, generator=gen, device=dev, dtype=dtype)
        got = trisolve_ops.trisolve(r, y, lower=lower, transpose=transpose)
        want = trisolve_ref(r, y, lower=lower, transpose=transpose)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rtol = 1e-4 if dtype == torch.float32 else 1e-9
        tol = rtol * max(1.0, float(want.abs().max()))
        iters = 20
        ms = cuda_ms(torch, lambda: trisolve_ops.trisolve(r, y, lower=lower, transpose=transpose), iters)
        plain = cuda_ms(torch, lambda: trisolve_ref(r, y, lower=lower, transpose=transpose), iters)
        op_r = r.mT if transpose else r
        lib = cuda_ms(torch, lambda: torch.linalg.solve_triangular(op_r, y, upper=not lower), iters)
        dev_ms = device_ms(torch, lambda: trisolve_ops.trisolve(r, y, lower=lower, transpose=transpose), iters)
        lib_dev = device_ms(torch, lambda: torch.linalg.solve_triangular(op_r, y, upper=not lower), iters)
        s = r.element_size()
        nbytes = J * n * (n + 1) / 2 * s + 2 * J * n * k * s
        flops = J * k * float(n) * n
        b_ms, b_by = bound(nbytes, flops, str(dtype).split(".")[1])
        results[name] = {
            "shape": f"R ({J}, {n}, {n}) y ({J}, {n}, {k}) {str(dtype).split('.')[1]}"
                     f" {'lower' if lower else 'upper'}{' on R^T' if transpose else ''}",
            "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "device_ms": dev_ms, "library_device_ms": lib_dev,
        }
        print(f"  {name:26s} err {err:.3e} (tol {tol:.1e})  kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f})  plain {plain:.4f} ms  library {lib:.4f} ms (device {lib_dev:.4f})"
              f"  bound {b_ms:.4f} ms ({b_by})")
        check(err <= tol, f"{name}: max error {err} above {tol}")

    def proj_case(name, w, k, x_dtype, with_x):
        J, p, n = w.shape
        xbar = torch.randn(J, n, k, generator=gen, device=dev).to(x_dtype)
        x = torch.randn(J, n, k, generator=gen, device=dev).to(x_dtype) if with_x else None
        gamma = torch.linspace(0.5, 1.5, J, device=dev) if with_x else 1.0
        if with_x:
            def run():
                return project_ops.consensus_update(w, x, xbar, gamma)

            def plain():
                return cu_ref(w, x, xbar, gamma)
        else:
            def run():
                return project_ops.project(w, xbar)

            def plain():
                return project_ref(w, xbar)
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        # the reference's tolerances (tests/test_kernel_project.py), scaled
        # by the input: P v cancels most of v where W spans nearly all of
        # R^n (the tall blocks), so float32 rounding follows |v|, not the
        # small result
        v_max = float(((xbar.float() - x.float()) if with_x else xbar.float()).abs().max())
        if torch.bfloat16 in (w.dtype, x_dtype):
            tol = 0.05 + 0.05 * max(v_max, float(want.float().abs().max()))
        else:
            tol = 2e-5 + 1e-4 * max(v_max, float(want.abs().max()))
        wf = w.float() if w.dtype == torch.bfloat16 else w
        xf = xbar.to(wf.dtype)
        xx = x.to(wf.dtype) if with_x else None

        def library():  # the bmm pair: v − Wᵀ(W v), plus the update when x is given
            v = xf - xx if with_x else xf
            pv = v - torch.bmm(wf.mT, torch.bmm(wf, v))
            return xx + gamma[:, None, None] * pv if with_x else pv

        ms = cuda_ms(torch, run, 20)
        plain_ms = cuda_ms(torch, plain, 5)
        lib = cuda_ms(torch, library, 20)
        dev_ms = device_ms(torch, run, 20)
        lib_dev = device_ms(torch, library, 20)
        sx = xbar.element_size()
        nbytes = J * p * n * w.element_size() + J * n * k * sx * (3 if with_x else 2)
        flops = 4.0 * J * p * n * k
        rate = "bfloat16" if w.dtype == torch.bfloat16 else "float32_3xtf32"
        b_ms, b_by = bound(nbytes, flops, rate)
        results[name] = {
            "shape": f"W ({J}, {p}, {n}) {str(w.dtype).split('.')[1]}, x̄ ({J}, {n}, {k}) "
                     f"{str(x_dtype).split('.')[1]}" + (", x and per-block γ" if with_x else ", project"),
            "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "device_ms": dev_ms, "library_device_ms": lib_dev,
        }
        print(f"  {name:30s} err {err:.3e} (tol {tol:.1e})  kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f})  plain {plain_ms:.4f} ms  library {lib:.4f} ms (device "
              f"{lib_dev:.4f})  bound {b_ms:.4f} ms ({b_by})")
        check(err <= tol, f"{name}: max error {err} above {tol}")

    f32, f64 = torch.float32, torch.float64
    w_tall, r_tall = factors(2, 4654, 2327, f32, tall=True)
    tri_case("trisolve.upper", 2, 2327, 32, f32, False, False, r_tall)
    w_wide, r_wide = factors(8, 1164, 2327, f32, tall=False)
    tri_case("trisolve.lower_t", 8, 1164, 32, f32, True, True, r_wide)
    _, r_wide64 = factors(8, 1164, 2327, f64, tall=False)
    tri_case("trisolve.lower_t.f64", 8, 1164, 32, f64, True, True, r_wide64)
    del r_wide64
    proj_case("consensus_update.tall", w_tall, 32, f32, with_x=False)
    proj_case("consensus_update.wide", w_wide, 32, f32, with_x=False)
    proj_case("consensus_update.wide.x_gamma", w_wide, 32, f32, with_x=True)
    proj_case("consensus_update.wide.bf16", w_wide.to(torch.bfloat16), 32, torch.bfloat16,
              with_x=False)
    design_checks(torch, project_ops, gen, {"tall": w_tall, "wide": w_wide})
    w_scale, _ = factors(8, 2048, 4096, f32, tall=False)
    proj_case("consensus_update.scale", w_scale, 64, f32, with_x=False)
    return results


def design_checks(torch, project_ops, gen, factors):
    """Two choices of the consensus-update kernel, timed on the card (device
    time by CUDA-graph replay, k = 32), printed and not gated:
    (a) W's rows as they are (n = 2327: 4-byte copies) against (b) a copy
    padded by a zero column to n = 2328, whose rows are 16-byte aligned;
    and the split target (thread blocks a pass is cut into) around its
    value."""
    dev = torch.device("cuda")
    for label, w in factors.items():
        J, p, n = w.shape
        xbar = torch.randn(J, n, 32, generator=gen, device=dev)
        n4 = -(-n // 4) * 4
        w_pad = torch.nn.functional.pad(w, (0, n4 - n)).contiguous()
        xbar_pad = torch.nn.functional.pad(xbar, (0, 0, 0, n4 - n)).contiguous()
        a = device_ms(torch, lambda: project_ops.project(w, xbar), 20)
        b = device_ms(torch, lambda: project_ops.project(w_pad, xbar_pad), 20)
        diff = float((project_ops.project(w_pad, xbar_pad)[:, :n] - project_ops.project(w, xbar))
                     .abs().max())
        print(f"  design {label}: rows as they are (n={n}) {a:.4f} ms, padded to n={n4} "
              f"{b:.4f} ms (device; max |diff| {diff:.2e})")
        default = project_ops.TARGET_BLOCKS
        times = {}
        try:
            for target in (132, 264, 528, 1056):
                project_ops.TARGET_BLOCKS = target
                plan = project_ops.split_plan(J, p, n, 32)
                times[f"{target} ({plan.splits1}x, {plan.splits2}x)"] = device_ms(
                    torch, lambda: project_ops.project(w, xbar), 20)
        finally:
            project_ops.TARGET_BLOCKS = default
        print(f"  design {label}: split target (splits pass 1, pass 2) -> device ms "
              + ", ".join(f"{key}: {t:.4f}" for key, t in times.items()))


def reset_launches(ops) -> None:
    """Every kernel's launch count to 0."""
    ops.trisolve.launches = 0
    ops.project.launches = 0
    for key in ops.spmm.launches:
        ops.spmm.launches[key] = 0


def read_launches(ops) -> dict:
    return {"trisolve": ops.trisolve.launches, "consensus_update": ops.project.launches,
            **ops.spmm.launches}


def main_path_run(torch, launch_solve, ops, n, m, J, k, gate):
    """One run of the user's entry point with the kernels, counters zeroed
    just before and read just after; gated runs are also checked against the
    kernels-off solve on the card and the JAX package's CPU residual."""
    argv = ["--n", str(n), "--m", str(m), "--blocks", str(J), "--epochs", "80",
            "--rhs", str(k), "--implicit-p", "--device", "cuda"]
    reset_launches(ops)
    record, prep, res, b, x_ref = launch_solve.run(argv + ["--kernels"])
    launches = read_launches(ops)
    print(f"  n={n} m={m} J={J} k={k} mode={record['mode']}: launches {launches}, "
          f"setup {prep.setup_seconds:.4f} s, solve {res.wall_seconds:.4f} s, "
          f"final_residual_sq_max {record['final_residual_sq_max']:.6e}, "
          f"final_mse_max {record['final_mse_max']:.6e}")
    check(launches["trisolve"] >= 1 and launches["consensus_update"] >= 1,
          f"J={J}: a kernel of the path was not launched: {launches}")
    check(res.x.shape == (n, k), f"J={J}: solution shape {res.x.shape}")
    check(bool(torch.isfinite(torch.as_tensor(res.x)).all()), f"J={J}: non-finite solution")
    warm = prep.solve(b, num_epochs=80, x_ref=x_ref).wall_seconds
    print(f"    warm solve (same prepared solver, second call): {warm:.4f} s")
    out = {"record": record, "launches": launches, "setup_seconds": prep.setup_seconds,
           "solve_seconds": res.wall_seconds, "warm_solve_seconds": warm}
    if not gate:
        return out
    _, prep0, res0, _, _ = launch_solve.run(argv)
    warm0 = prep0.solve(b, num_epochs=80, x_ref=x_ref).wall_seconds
    diff = float(abs(res.x - res0.x).max())
    tol = 1e-4 * max(1.0, float(abs(res0.x).max()))
    print(f"    kernels off: solve {res0.wall_seconds:.4f} s, warm {warm0:.4f} s; "
          f"max |x_kernels - x_plain| {diff:.3e} (tol {tol:.1e})")
    profile_solve(torch, prep, b, x_ref, 80)
    check(diff <= tol, f"J={J}: kernels-on solution differs from kernels-off by {diff}")
    resid, ref = record["final_residual_sq_max"], JAX_CPU_RESIDUAL[J]
    print(f"    residual {resid:.6e} vs JAX CPU {ref:.6e} (ratio {resid / ref:.4f}, "
          f"allowed 1/{RESIDUAL_FACTOR:g}..{RESIDUAL_FACTOR:g})")
    check(ref / RESIDUAL_FACTOR <= resid <= ref * RESIDUAL_FACTOR,
          f"J={J}: residual {resid} not within {RESIDUAL_FACTOR}x of {ref}")
    out.update(plain_solve_seconds=res0.wall_seconds, max_abs_diff_vs_plain=diff)
    return out


def profile_solve(torch, prep, b, x_ref, epochs, label="one warm solve", **solve_kw) -> dict:
    """Where one warm solve's time goes: device time by kernel and the
    device's busy share of the host wall time, from torch.profiler. Prints
    the eight largest rows and every row of the epoch's fused pass.
    ``solve_kw`` go to the solve (a session's warm start and tol)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = prep.solve(b, num_epochs=epochs, x_ref=x_ref, **solve_kw).wall_seconds
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue  # host ranges repeat the time of the kernels they launch
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"    profile of {label}: wall {wall * 1e3:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / (wall * 1e3):.1f}%), "
          f"{sum(r[1] for r in rows)} kernels run")
    for i, (dev_us, count, name) in enumerate(rows):
        if i < 8 or "spmm_fused" in name:
            print(f"      {dev_us / 1e3:9.3f} ms  x{count:<5d} {name[:90]}")
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms}


def peak_memory_solve(torch, prep, b, x_ref, epochs):
    """One solve with the device's peak allocation tracked: (result, peak
    bytes allocated during it, bytes allocated before it)."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = prep.solve(b, num_epochs=epochs, x_ref=x_ref)
    torch.cuda.synchronize()
    return res, torch.cuda.max_memory_allocated(), held


def matfree_run(torch, launch_solve, ops, n, mode, epochs):
    """The matrix-free path through the user's entry point, counters zeroed
    just before and read just after; checked against the kernels-off solver
    restored from this solver's own state on the card."""
    from repro_torch.core import matfree

    argv = ["--n", str(n), "--m", str(n), "--blocks", "8", "--mode", mode, "--kernels",
            "--rhs", "32", "--epochs", str(epochs), "--gamma", "2.0", "--eta", "1.9",
            "--device", "cuda"]
    reset_launches(ops)
    syncs0 = matfree.host_syncs
    record, prep, res, b, x_ref = launch_solve.run(argv)
    launches = read_launches(ops)
    syncs = matfree.host_syncs - syncs0
    inner = np.asarray(res.history["inner_iters"])
    fill = int(torch.count_nonzero(prep.op.fwd_data)) / prep.op.fwd_data.numel()
    print(f"  n={n} --mode {mode}: path {record['path']}, gram solver {prep.gram_solver}, "
          f"launches {launches}, setup {prep.setup_seconds:.4f} s, cold solve "
          f"{res.wall_seconds:.4f} s, final_residual_sq_max "
          f"{record['final_residual_sq_max']:.6e}, final_mse_max {record['final_mse_max']:.6e}")
    print(f"    operator on the card {prep.memory_bytes / 1e6:.3f} MB (dense blocks would be "
          f"{prep.dense_memory_bytes / 1e6:.1f} MB); forward tiles "
          f"{tuple(prep.op.fwd_data.shape)}, {100 * fill:.2f}% of their entries nonzero; "
          f"inner depth per epoch mean {inner.mean():.3f} "
          f"max {inner.max()}; host syncs in the solve {syncs}")
    packs = {name: getattr(prep.op, f"{name}_packed") for name in ("fwd", "tra", "gram")}
    check(all(p is not None for p in packs.values()), f"n={n}: the operator was not packed")
    print("    packed forms on the card: " + ", ".join(
        f"{name} {p.nnz} nonzeros {p.nbytes / 1e6:.3f} MB" for name, p in packs.items()))
    check(record["path"] == "matfree", f"n={n}: path {record['path']}, expected matfree")
    check(launches["spmm"] >= 1 and launches["spmm_fused_packed"] == epochs,
          f"n={n}: expected spmm and one fused packed pass per epoch: {launches}")
    check(launches["spmm_fused"] == 0, f"n={n}: the staged ELL pass ran: {launches}")
    check(res.x.shape == (n, 32), f"n={n}: solution shape {res.x.shape}")
    check(bool(np.isfinite(res.x).all()), f"n={n}: non-finite solution")
    warm_res, peak, held = peak_memory_solve(torch, prep, b, x_ref, epochs)
    warm = warm_res.wall_seconds
    cold_vs_warm = float(np.abs(res.x - warm_res.x).max())
    print(f"    warm solve (same prepared solver, second call): {warm:.4f} s, peak device "
          f"memory {peak / 1e6:.3f} MB ({held / 1e6:.3f} MB held before it); "
          f"max |x_cold - x_warm| {cold_vs_warm:.3e}")
    staged = dataclasses.replace(prep, op=dataclasses.replace(prep.op, tra_packed=None))
    staged_res, staged_peak, _ = peak_memory_solve(torch, staged, b, x_ref, epochs)
    print(f"    staged ELL pass + index_add_ scatter (same solver without the transposed "
          f"packed form, not gated): warm {staged_res.wall_seconds:.4f} s, peak device memory "
          f"{staged_peak / 1e6:.3f} MB; max |x_staged - x_warm| "
          f"{float(np.abs(staged_res.x - warm_res.x).max()):.3e}")
    profile_solve(torch, staged, b, x_ref, epochs, label="the staged warm solve")
    arrays, meta = prep.to_state()
    plain = matfree.MatrixFreePreparedSolver.from_state(
        arrays, {**meta, "use_kernels": False}, device="cuda")
    res0 = plain.solve(b, num_epochs=epochs, x_ref=x_ref)
    warm0 = plain.solve(b, num_epochs=epochs, x_ref=x_ref).wall_seconds
    diff = float(np.abs(res.x - res0.x).max())
    tol = MATFREE_AGREEMENT * float(np.abs(res0.x).max())
    print(f"    kernels off (restored from this solver's state): solve {res0.wall_seconds:.4f} s, "
          f"warm {warm0:.4f} s; max |x_kernels - x_plain| {diff:.3e} (tol {tol:.3e})")
    profile = profile_solve(torch, prep, b, x_ref, epochs)
    check(diff <= tol, f"n={n}: kernels-on solution differs from kernels-off by {diff}")
    return {"record": record, "prep": prep, "launches": launches, "host_syncs": syncs,
            "setup_seconds": prep.setup_seconds, "solve_seconds": res.wall_seconds,
            "warm_solve_seconds": warm, "plain_warm_solve_seconds": warm0,
            "warm_peak_bytes": peak, "staged_peak_bytes": staged_peak,
            "max_abs_diff_cold_vs_warm": cold_vs_warm,
            "max_abs_diff_vs_plain": diff, "inner_mean": float(inner.mean()),
            "profile": profile}


def block_diag_csr(torch, indices, data, num_col_blocks):
    """The J shards as one block-diagonal CSR matrix, for the library
    yardstick (``torch.sparse.mm``, cuSPARSE); the port never calls it."""
    J, R, S, bp, bn = data.shape
    j, r, s, p, b = (data != 0).nonzero(as_tuple=True)
    rows = (j * R + r) * bp + p
    cols = (j * num_col_blocks + indices[j, r, s].long()) * bn + b
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), data[j, r, s, p, b],
                                  (J * R * bp, J * num_col_blocks * bn))
    return coo.coalesce().to_sparse_csr()


def spmm_phase(torch, spmm_ops, spmm_plain, spmm_packed_plain, spmm_fused_plain,
               spmm_fused_packed_plain, op_small, op_big):
    """The SpMM kernels against their plain versions on the card, on the
    operators the matrix-free runs prepared (their packed forms included), at
    k = 32."""
    from repro_torch.sparse import PartitionedBSR, generate_schenk_like
    from repro_torch.sparse.bsr import _pad_cols

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    results = {}

    def case(name, what, indices, data, packed, xb, y=None, iters=20):
        fused = y is not None
        if fused:
            def run():
                return spmm_ops.spmm_fused(indices, data, xb, y)

            def plain():
                return spmm_fused_plain(indices, data, xb, y)
        else:
            def run():
                return (spmm_ops.spmm_packed(packed, xb),)

            def plain():  # the packed kernel's plain version: a segment sum
                return (spmm_packed_plain(packed, xb),)
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        if not fused:  # and the function itself, on the ELL arrays
            err = max(err, float((got[0] - spmm_plain(indices, data, xb)).abs().max()))
        # the reference's own tolerance (tests/test_kernel_spmm.py): atol
        # 1e-4 plus rtol 1e-4 of the largest entry
        tol = min(1e-4 + 1e-4 * float(w.abs().max()) for w in want)
        ms = cuda_ms(torch, run, iters)
        plain_ms = cuda_ms(torch, plain, max(iters // 4, 3))
        dev_ms = device_ms(torch, run, iters)
        lib = lib_dev = lib_err = None
        if not fused:
            C = xb.shape[1]
            csr = block_diag_csr(torch, indices, data, C)
            xs = xb.contiguous().reshape(-1, xb.shape[-1])
            lib_out = torch.sparse.mm(csr, xs)
            lib_err = float((lib_out.reshape(want[0].shape) - want[0]).abs().max())
            lib = cuda_ms(torch, lambda: torch.sparse.mm(csr, xs), iters)
            lib_dev = device_ms(torch, lambda: torch.sparse.mm(csr, xs), iters)
        J, R, S, bp, bn = data.shape
        k = xb.shape[-1]
        s = data.element_size()
        nnz = int(torch.count_nonzero(data))
        x_bytes = xb[0].numel() * s * (1 if xb.stride(0) == 0 else J)
        io_bytes = x_bytes + sum(t.numel() for t in got) * s + (y.numel() * s if fused else 0)
        # what the product needs: each nonzero's value and column (int32) and
        # the int32 row pointers of the J*R*bp rows; the ELL figure streams
        # every stored tile and tile id
        need = nnz * (s + 4) + (J * R * bp + 1) * 4 + io_bytes
        ell = indices.numel() * 4 + data.numel() * s + io_bytes
        flops = 2.0 * nnz * k * (2 if fused else 1)
        dt = str(data.dtype).split(".")[1]
        b_ms, b_by = bound(need, flops, dt)
        ell_ms, _ = bound(ell, flops, dt)
        results[name] = {
            "shape": f"{what}: indices {tuple(indices.shape)}, tiles {(bp, bn)}, k {k}, "
                     f"{nnz} nonzeros"
                     + (", x broadcast over J" if xb.stride(0) == 0 else "")
                     + (", staged contrib" if fused else ""),
            "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bound_ell_ms": ell_ms, "library_ms": lib,
            "device_ms": dev_ms, "library_device_ms": lib_dev,
        }
        lib_txt = "—" if lib is None else f"{lib:.4f} ms (device {lib_dev:.4f}, err {lib_err:.1e})"
        print(f"  {name:24s} err {err:.3e} (tol {tol:.1e})  kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f})  plain {plain_ms:.4f} ms  library "
              f"{lib_txt}  bound {b_ms:.4f} ms ({b_by}, {need / 1e6:.2f} MB, "
              f"{flops / 1e9:.3f} GFLOP)  ELL bound {ell_ms:.4f} ms ({ell / 1e6:.1f} MB)")
        check(err <= tol, f"{name}: max error {err} above {tol}")

    def col_tiles(op, k):  # the main path's broadcast operand: padded once
        x = torch.randn(op.shape[1], k, generator=gen, device=dev)
        return op._col_tiles(x)

    def rows(op, k):  # (J, p_pad, k) row-space operand
        return torch.randn(op.num_blocks, op.p_pad, k, generator=gen, device=dev)

    def row_tiles(op, k):  # its (J, R, bp, k) view for the fused kernel
        return rows(op, k).reshape(op.num_blocks, -1, op.block_shape[0], k)

    def fused_packed_case(name, op, iters):
        """The epoch's fused pass on the operator's packed forms, with the
        main path's operands: x broadcast over the blocks, y per block."""
        fwd_p, tra_p = op.fwd_packed, op.tra_packed
        xb, yb = col_tiles(op, 32), row_tiles(op, 32)

        def run():
            return spmm_ops.spmm_fused_packed(fwd_p, tra_p, xb, yb)

        def plain():
            return spmm_fused_packed_plain(fwd_p, tra_p, xb, yb)

        def pair():  # the two packed products as separate launches
            return spmm_ops.spmm_packed(fwd_p, xb), spmm_ops.spmm_packed(tra_p, yb)

        csr_f = block_diag_csr(torch, op.fwd_indices, op.fwd_data, xb.shape[1])
        csr_t = block_diag_csr(torch, op.tra_indices, op.tra_data, yb.shape[1])
        xs = xb.contiguous().reshape(-1, 32)
        ys = yb.reshape(-1, 32)

        def library():  # the torch.sparse.mm pair on block-diagonal CSR matrices
            return torch.sparse.mm(csr_f, xs), torch.sparse.mm(csr_t, ys)

        got, want, two, lib_out = run(), plain(), pair(), library()
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        tol = min(1e-4 + 1e-4 * float(w.abs().max()) for w in want)
        same = all(torch.equal(g, t) for g, t in zip(got, two))
        lib_err = max(float((o.reshape(w.shape) - w).abs().max()) for o, w in zip(lib_out, want))
        ms = cuda_ms(torch, run, iters)
        plain_ms = cuda_ms(torch, plain, max(iters // 4, 3))
        dev_ms = device_ms(torch, run, iters)
        pair_dev = device_ms(torch, pair, iters)
        lib = cuda_ms(torch, library, iters)
        lib_dev = device_ms(torch, library, iters)
        s = fwd_p.val.element_size()
        nnz = fwd_p.nnz + tra_p.nnz
        ptrs = (fwd_p.row_ptr.numel() + tra_p.row_ptr.numel()) * 4
        need = (nnz * (s + 4) + ptrs + xb[0].numel() * s + yb.numel() * s
                + sum(t.numel() for t in got) * s)
        flops = 2.0 * nnz * 32
        b_ms, b_by = bound(need, flops, str(fwd_p.val.dtype).split(".")[1])
        results[name] = {
            "shape": f"forward {fwd_p.nnz} + transposed {tra_p.nnz} nonzeros packed, rows "
                     f"{fwd_p.num_blocks} x ({fwd_p.block_rows} + {tra_p.block_rows}), k 32, "
                     "x broadcast over J, y per block",
            "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "device_ms": dev_ms, "library_device_ms": lib_dev,
            "spmm_packed_pair_device_ms": pair_dev, "identical_to_spmm_packed_pair": same,
        }
        print(f"  {name:24s} err {err:.3e} (tol {tol:.1e})  kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f}; two spmm_packed launches {pair_dev:.4f}, bit-identical {same})  "
              f"plain {plain_ms:.4f} ms  library {lib:.4f} ms (device {lib_dev:.4f}, err "
              f"{lib_err:.1e}, torch.sparse.mm pair)  bound {b_ms:.4f} ms ({b_by}, "
              f"{need / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
        check(err <= tol, f"{name}: max error {err} above {tol}")
        check(same, f"{name}: not bit-identical to the two spmm_packed launches")

    for label, op in (("n2327", op_small), ("n16384", op_big)):
        iters = 20 if label == "n2327" else 10
        fused_packed_case(f"spmm_fused_packed.{label}", op, iters)
        case(f"spmm.fwd.{label}", "forward shards", op.fwd_indices, op.fwd_data,
             op.fwd_packed, col_tiles(op, 32), iters=iters)
        case(f"spmm_fused.{label}", "forward shards, fused", op.fwd_indices, op.fwd_data,
             None, col_tiles(op, 32), row_tiles(op, 32), iters=iters)
    case("spmm.fwd.n2327.k1", "forward shards, one RHS", op_small.fwd_indices,
         op_small.fwd_data, op_small.fwd_packed, col_tiles(op_small, 1))
    bp = op_big.block_shape[0]
    case("spmm.tra.n16384", "transposed shards", op_big.tra_indices, op_big.tra_data,
         op_big.tra_packed, _pad_cols(rows(op_big, 32), op_big.p_pad, bp), iters=10)
    case("spmm.gram.n16384", "Gram shards", op_big.gram_indices, op_big.gram_data,
         op_big.gram_packed, _pad_cols(rows(op_big, 32), op_big.p_pad, bp), iters=10)
    tall = PartitionedBSR.from_coo(generate_schenk_like(2048, seed=5), 8, (16, 8),
                                   device=dev).with_packed()
    case("spmm.tile16x8", "forward shards, (16, 8) tiles", tall.fwd_indices, tall.fwd_data,
         tall.fwd_packed, col_tiles(tall, 32))
    case("spmm_fused.tile16x8", "forward shards, (16, 8) tiles, fused", tall.fwd_indices,
         tall.fwd_data, None, col_tiles(tall, 32), row_tiles(tall, 32))
    return results


def baseline_run(torch, launch_solve, ops, method):
    """``repro_torch.launch.solve --method dgd|cgnr`` at the Table 1 width:
    no hand kernel runs (the reference's products are plain einsums, here
    batched matmuls); the residual is held against the JAX package's."""
    argv = ["--n", "2327", "--m", "9308", "--blocks", "8", "--epochs", "80", "--rhs", "32",
            "--method", method, "--device", "cuda"]
    reset_launches(ops)
    record, prep, res, b, x_ref = launch_solve.run(argv)
    launches = read_launches(ops)
    resid, ref = record["final_residual_sq_max"], JAX_CPU_BASELINE_RESIDUAL[method]
    print(f"  {method}: mode {record['mode']}, launches {launches}, setup {prep.setup_seconds:.4f} s, "
          f"solve {res.wall_seconds:.4f} s, final_residual_sq_max {resid:.6e}, "
          f"final_mse_max {record['final_mse_max']:.6e}")
    if method == "dgd":
        lr = prep.factors[0]
        print(f"    step size 1/lambda_max {lr:.10e} vs JAX CPU {JAX_CPU_DGD_LR:.10e} "
              f"(ratio {lr / JAX_CPU_DGD_LR:.4f})")
    check(res.x.shape == (2327, 32) and bool(np.isfinite(res.x).all()),
          f"{method}: solution shape {res.x.shape} or non-finite values")
    check(res.gamma is None and res.eta is None, f"{method}: gamma/eta set on a baseline")
    warm = prep.solve(b, num_epochs=80, x_ref=x_ref).wall_seconds
    print(f"    warm solve (same prepared solver, second call): {warm:.4f} s")
    print(f"    residual {resid:.6e} vs JAX CPU {ref:.6e} (ratio {resid / ref:.4f}, "
          f"allowed 1/{RESIDUAL_FACTOR:g}..{RESIDUAL_FACTOR:g})")
    check(ref / RESIDUAL_FACTOR <= resid <= ref * RESIDUAL_FACTOR,
          f"{method}: residual {resid} not within {RESIDUAL_FACTOR}x of {ref}")
    profile = profile_solve(torch, prep, b, x_ref, 80)
    return {"record": record, "warm_solve_seconds": warm, "profile": profile}


def stream_problem(make_problem, path):
    """(matrix to prepare, its dense form, prepare kwargs) of a session
    phase: the Table 1 wide system, or the paper-size square sparse one."""
    if path == "dense":
        prob = make_problem(n=2327, m=9308, seed=0, dtype=np.float32)
        return prob.A, prob.A, {"num_blocks": 8, "materialize_p": False}
    prob = make_problem(n=2327, m=2327, seed=0, dtype=np.float32)
    return (prob.coo, prob.coo.to_dense().astype(np.float32),
            {"mode": "matfree", "num_blocks": 8, "gamma": 2.0, "eta": 1.9})


def drift_stream(A):
    """The reference's streaming trace (benchmarks/streaming.py), 32 streams
    as columns: b_t = A(x_base + 2e-3·sin(0.25 t + i)), t < 12."""
    n = A.shape[1]
    x_base = np.random.default_rng(STREAM_SEED).standard_normal((n, STREAM_COLS)).astype(np.float32)
    phase = np.arange(n)[:, None]
    return [(A @ (x_base + STREAM_AMP * np.sin(0.25 * t + phase))).astype(np.float32)
            for t in range(STREAM_UPDATES)]


def stream_tol(prep, b0):
    """3x the cold solve's residual floor at the cap, the largest column's."""
    cold = prep.solve(b0, num_epochs=STREAM_CAP)
    return 3.0 * float(np.sqrt(np.max(cold.history["residual_sq"][-1])))


def replay_stream(prep, bs, tol, on_update=None):
    """The stream through a session and as independent cold solves at one
    tol. ``on_update(t, update)`` wraps each session update (the launch
    count). Returns the totals of epochs-to-tol and both results per update."""
    sess = prep.open_session(num_epochs=STREAM_CAP, tol=tol)
    independent, pairs = 0, []
    for t, b in enumerate(bs):
        res = on_update(t, lambda: sess.update(b)) if on_update else sess.update(b)
        cold = prep.solve(b, num_epochs=STREAM_CAP, tol=tol)
        independent += int(cold.iterations_to_tol(tol).sum())
        pairs.append((res, cold))
    return {"session": sess.total_epochs, "independent": independent, "tol": tol, "pairs": pairs}


def print_stream_reference(prepare, make_problem):
    """The session phases' streams replayed by a package's ``prepare`` and
    ``make_problem`` on the CPU (the JAX package's, for ``JAX_CPU_STREAM``)."""
    for path in ("dense", "matfree"):
        A, dense, kw = stream_problem(make_problem, path)
        prep = prepare(A, **kw)
        bs = drift_stream(dense)
        out = replay_stream(prep, bs, stream_tol(prep, bs[0]))
        print(json.dumps({"path": path, "session": out["session"],
                          "independent": out["independent"], "tol": out["tol"],
                          "ratio": out["session"] / out["independent"]}))


def serving_problem(make_problem, path):
    """(matrix to register, its dense form, prepare kwargs) of a serving
    phase: the session phases' systems, the dense one pinned to the dense
    path."""
    A, dense, kw = stream_problem(make_problem, path)
    return (A, dense, {**kw, "mode": "dense"}) if path == "dense" else (A, dense, kw)


def poisson_traffic(dense):
    """The serving command line's Poisson trace at seed 0: b_i = A x_i with
    x_i from default_rng(1), then the inter-arrival gaps from the same
    generator (the first request fires at once)."""
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((dense.shape[1], SERVE_REQUESTS)).astype(np.float32)
    gaps = rng.exponential(1.0 / SERVE_RATE, size=SERVE_REQUESTS)
    gaps[0] = 0.0
    return (dense @ xs).astype(np.float32), xs, gaps


def direct_iterations(prep, rhs, tol):
    """Per-request epochs-to-tol of batched solves of ``rhs`` in the served
    width, and their solutions: what a served request must reproduce."""
    iters, xs = [], []
    for i in range(0, rhs.shape[1], SERVE_BATCH):
        res = prep.solve(rhs[:, i:i + SERVE_BATCH], num_epochs=STREAM_CAP, tol=tol)
        iters.append(res.iterations_to_tol(tol))
        xs.append(res.x)
    return np.concatenate(iters), np.concatenate(xs, axis=1)


def serve_streams(server_cls, system, prepare_kwargs, bs, tol, **server_kw):
    """The session phases' streams through a package's ``SolveServer``: one
    ``ServerSession`` per column, all 32 stepping in lockstep, so each
    update's columns coalesce into one batch. Returns the summed
    epochs-to-tol of the sessions, each update's results (one list per
    update, column order) and the server's stats."""
    import asyncio

    async def run():
        async with server_cls(max_batch=SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS,
                              num_epochs=STREAM_CAP, tol=tol, prepare_kwargs=prepare_kwargs,
                              **server_kw) as server:
            fp = server.register(system)
            sessions = [server.open_session(fp) for _ in range(bs[0].shape[1])]
            updates = []
            for b in bs:
                updates.append(await asyncio.gather(
                    *(s.update(b[:, i]) for i, s in enumerate(sessions))))
            return sum(s.total_iterations for s in sessions), updates, server.stats()

    return asyncio.run(asyncio.wait_for(run(), timeout=600))


def print_serving_reference(prepare, make_problem, server_cls):
    """The serving phases' reference numbers from a package's ``prepare``,
    ``make_problem`` and ``SolveServer`` on the CPU (the JAX package's, for
    ``JAX_CPU_SERVING``): the Poisson tol (3x the cold floor of the first 32
    requests) and the summed epochs-to-tol of the 256 requests at it; the
    drifting streams' summed epochs-to-tol through the server."""
    for path in ("dense", "matfree"):
        A, dense, kw = serving_problem(make_problem, path)
        prep = prepare(A, **kw)
        rhs, _, _ = poisson_traffic(dense)
        tol = stream_tol(prep, rhs[:, :SERVE_BATCH])
        iters, _ = direct_iterations(prep, rhs, tol)
        drift, _, stats = serve_streams(server_cls, A, kw, drift_stream(dense),
                                        JAX_CPU_STREAM[path]["tol"])
        print(json.dumps({"path": path, "poisson_tol": tol, "poisson_iterations": int(iters.sum()),
                          "drifting_iterations": int(drift), "drifting_batches": stats["batches"]}))


def session_phase(torch, ops, path, make_problem, prepare):
    """A drifting stream through a session over the kernels-on solver on the
    card: every update and every independent solve below tol, each update
    within 5·tol of its cold solve, the epoch ratio under the gate; the
    launches of one update counted; the watchdog all ok; then the same
    stream on the kernels-off solver restored from this one's state."""
    A, dense, kw = stream_problem(make_problem, path)
    prep = prepare(A, use_kernels=True, device="cuda", **kw)
    bs = drift_stream(dense)
    tol = stream_tol(prep, bs[0])
    counted = {}

    def on_update(t, update):
        if t != STREAM_UPDATES // 2:
            return update()
        reset_launches(ops)  # around one warm update
        res = update()
        counted.update(read_launches(ops))
        return res

    out = replay_stream(prep, bs, tol, on_update)
    ref = JAX_CPU_STREAM[path]
    ratio, ref_ratio = out["session"] / out["independent"], ref["session"] / ref["independent"]
    walls = [(r.wall_seconds, c.wall_seconds) for r, c in out["pairs"]]
    print(f"  {path} session: tol {tol:.6e} (JAX CPU {ref['tol']:.6e}); epochs session "
          f"{out['session']} / independent {out['independent']} = {ratio:.4f} (JAX CPU "
          f"{ref['session']} / {ref['independent']} = {ref_ratio:.4f}; gate {SESSION_RATIO_GATE})")
    print(f"    per update: session wall mean {np.mean([w[0] for w in walls]):.4f} s, independent "
          f"solve wall mean {np.mean([w[1] for w in walls]):.4f} s (cap {STREAM_CAP} epochs each)")
    print(f"    launches in update {STREAM_UPDATES // 2}: {counted}")
    for t, (res, cold) in enumerate(out["pairs"]):
        for name, r in (("session", res), ("independent", cold)):
            top = float(np.sqrt(np.max(r.final_residual)))
            check(top <= tol, f"{path} update {t}: {name} residual {top} above tol {tol}")
        diff = float(np.abs(res.x - cold.x).max())
        check(diff <= 5 * tol, f"{path} update {t}: session differs from cold by {diff} > 5·tol")
        health = res.assess_health(tol)
        check(health.ok, f"{path} update {t}: watchdog {health.status}")
    check(ratio <= SESSION_RATIO_GATE, f"{path}: session/independent epochs {ratio} above gate")
    if path == "dense":
        check(counted["trisolve"] == 1 and counted["consensus_update"] == STREAM_CAP,
              f"dense update: expected 1 trisolve and {STREAM_CAP} consensus updates: {counted}")
    else:
        check(counted["spmm_fused_packed"] == STREAM_CAP and counted["spmm_fused"] == 0
              and counted["spmm"] >= 1,
              f"matfree update: expected {STREAM_CAP} fused packed passes, spmm_packed for the "
              f"warm-start projection and no staged pass: {counted}")
    # kernels on against kernels off, on the same card, the same stream
    arrays, meta = prep.to_state()
    meta = {**meta, "use_kernels": False}
    if meta.get("projector") is not None:
        meta["projector"] = {**meta["projector"], "kind": "implicit"}
    off = type(prep).from_state(arrays, meta, device=prep.device).open_session(
        num_epochs=STREAM_CAP, tol=tol)
    worst, its = 0.0, []
    for t, ((on_res, _), b) in enumerate(zip(out["pairs"], bs)):
        off_res = off.update(b)
        top = float(np.abs(off_res.x).max())
        gate = 1e-4 * max(1.0, top) if path == "dense" else MATFREE_AGREEMENT * top
        diff = float(np.abs(on_res.x - off_res.x).max())
        worst = max(worst, diff / gate)
        its.append((int(on_res.iterations_to_tol(tol).sum()), int(off_res.iterations_to_tol(tol).sum())))
        check(diff <= gate, f"{path} update {t}: kernels on/off differ by {diff} > {gate}")
    print(f"    kernels off (restored from this solver's state): session epochs {off.total_epochs}; "
          f"largest |x_on - x_off| / gate {worst:.3f}; iterations_to_tol per update (on, off) {its}")
    x0 = out["pairs"][-2][0].x  # the session's warm start for the last update
    profile = profile_solve(torch, prep, bs[-1], None, STREAM_CAP,
                            label="one warm-started session solve", x0=x0, tol=tol)
    return {"prep": prep, "b0": bs[0], "launches": counted, "ratio": ratio, "tol": tol,
            "profile": profile,
            "session_epochs": out["session"], "independent_epochs": out["independent"],
            "session_wall_mean": float(np.mean([w[0] for w in walls])),
            "independent_wall_mean": float(np.mean([w[1] for w in walls]))}


def watchdog_phase(sessions):
    """NaN in one column of b: exactly that column is flagged, on the dense
    and on the matrix-free direct kernel paths (solved as a session's
    independent solve, at its cap and tol); and a block_history solve of the
    matrix-free path returns x bit for bit, with its report printed."""
    from repro_torch.obs import convergence_report

    for name, run in sessions.items():
        prep, b, tol = run["prep"], run["b0"], run["tol"]
        bad = b.copy()
        bad[5, 7] = np.nan
        health = prep.solve(bad, num_epochs=STREAM_CAP, tol=tol).assess_health(tol)
        want = tuple("nan" if i == 7 else "ok" for i in range(b.shape[1]))
        print(f"  {name}: NaN planted in column 7 of b -> nan columns {health.nan_columns}, "
              f"sick columns {health.sick_columns}")
        check(health.status == want, f"{name}: watchdog verdict {health.status}")
    matfree_prep, matfree_b = sessions["matfree"]["prep"], sessions["matfree"]["b0"]
    check(matfree_prep.gram_solver == "direct", "matfree watchdog run: expected the direct solver")
    plain = matfree_prep.solve(matfree_b, num_epochs=STREAM_CAP)
    diag = matfree_prep.solve(matfree_b, num_epochs=STREAM_CAP, block_history=True)
    same = bool(np.array_equal(plain.x, diag.x))
    rep = convergence_report(diag)
    print(f"  matfree block_history: x bit-identical {same}; slowest block per column "
          f"{np.bincount(rep['slowest_block'], minlength=8).tolist()} (counts over 32 columns), "
          f"imbalance min {rep['imbalance'].min():.3f} max {rep['imbalance'].max():.3f}, "
          f"rates min {rep['rates'].min():.5f} max {rep['rates'].max():.5f}")
    check(same, "matfree: block_history changed the solution")


def pct(values, q) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def served_tolerance(path, x):
    """The kernels-on/off gate for one served solution: 1e-4·max(1, max|x|)
    dense, 2.5e-4·max|x| matrix-free."""
    top = float(np.abs(x).max())
    return 1e-4 * max(1.0, top) if path == "dense" else MATFREE_AGREEMENT * top


def profile_served_batch(torch, loop, server, fp, B):
    """One served batch of 32 requests under torch.profiler: the device
    time by kernel (CUPTI sees the worker thread's launches too) against
    the host wall of the batch, from submit to the last answer."""
    import asyncio

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    async def batch():
        return await asyncio.gather(*(server.submit(fp, B[:, i]) for i in range(B.shape[1])))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        results = loop.run_until_complete(batch())
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"    profile of one served batch of {B.shape[1]}: wall {wall * 1e3:.3f} ms (solve "
          f"{results[0].solve_ms:.3f} ms), device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / (wall * 1e3):.1f}%), {sum(r[1] for r in rows)} kernels run")
    for dev_us, count, name in rows[:6]:
        print(f"      {dev_us / 1e3:9.3f} ms  x{count:<5d} {name[:90]}")
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
            "top": [(name[:60], dev_us / 1e3) for dev_us, _, name in rows[:4]]}


def poisson_phase(torch, ops, path, make_problem, serving, card):
    """The serving command line's Poisson trace (256 requests at 2000 req/s)
    through a ``SolveServer`` of the port on the card, kernels on: every
    request answered once, by its own b, within the kernels-on/off gate of
    a direct solve of the same columns at the served width and within one
    epoch of it; the summed epochs-to-tol within 2% of the JAX package's; the served
    batches launch the path's hand kernels (counts zeroed just before the
    replay, read just after). Prints throughput, latency and queue wait
    from the server's clock, the batches, the cold first batch apart, the
    pool, the lateness of the arrivals (the GIL's share of queue wait) and
    one profiled served batch."""
    import asyncio

    A, dense, kw = serving_problem(make_problem, path)
    kw = {**kw, "use_kernels": True, "device": "cuda"}
    rhs, _, gaps = poisson_traffic(dense)
    tol = JAX_CPU_SERVING[path]["poisson_tol"]
    tracer = serving.Tracer()
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    server = serving.SolveServer(max_batch=SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS,
                                 num_epochs=STREAM_CAP, tol=tol, prepare_kwargs=kw, tracer=tracer)
    fp = server.register(A)

    async def replay():
        t_start = server.clock.now()
        reset_launches(ops)
        t0 = time.perf_counter()
        results = await serving.replay_trace(server, fp, rhs, gaps)
        wall = time.perf_counter() - t0
        return results, read_launches(ops), wall, t_start

    results, launches, wall, t_start = loop.run_until_complete(asyncio.wait_for(replay(), 600))
    stats = server.stats()
    spans = tracer.spans()
    batches = sorted((s for s in spans if s.name == "batch"), key=lambda s: s.t0)
    prepare_ms = sum(s.duration_ms for s in spans if s.name == "pool.prepare")
    queue_spans = sorted((s for s in spans if s.name == "queue"), key=lambda s: s.trace_id)
    lateness = [(s.t0 - t_start - a) * 1e3 for s, a in zip(queue_spans, np.cumsum(gaps))]
    cold, warm = batches[0], batches[1:]
    profile = profile_served_batch(torch, loop, server, fp, rhs[:, :SERVE_BATCH])
    loop.run_until_complete(server.aclose())
    loop.close()
    asyncio.set_event_loop(None)
    prep = server.pool.get(fp)
    direct_its, direct_x = direct_iterations(prep, rhs, tol)

    n = len(results)
    lat = [r.queue_ms + r.solve_ms for r in results]
    queue = [r.queue_ms for r in results]
    its = np.array([r.iterations for r in results])
    nb = stats["batches"]
    per_batch = {k: v / nb for k, v in launches.items()}
    worst, bit_equal = 0.0, 0
    for i, r in enumerate(results):
        diff = float(np.abs(r.x - direct_x[:, i]).max())
        worst = max(worst, diff / served_tolerance(path, direct_x[:, i]))
        bit_equal += bool(np.array_equal(r.x, direct_x[:, i]))
    ref_total = JAX_CPU_SERVING[path]["poisson_iterations"]
    total = int(its.sum())
    print(f"  {path} Poisson replay [{card}]: {n} requests at ~{SERVE_RATE:g} req/s in {wall:.3f} s "
          f"-> {n / wall:.1f} req/s; after the cold batch {(n - cold.args['batch_size']) / (batches[-1].t1 - cold.t1):.1f} req/s")
    print(f"    latency ms p50 {pct(lat, 50):.1f} p99 {pct(lat, 99):.1f} max {max(lat):.1f}; queue wait "
          f"ms p50 {pct(queue, 50):.1f} p99 {pct(queue, 99):.1f}; arrival lateness ms p50 "
          f"{pct(lateness, 50):.3f} p99 {pct(lateness, 99):.3f} max {max(lateness):.3f}")
    print(f"    batches {nb} (mean size {stats['mean_batch_size']:.2f}, full {stats['full_batches']}, "
          f"timeout-flushed {stats['timeout_flushes']}); cold first batch "
          f"{cold.duration_ms:.1f} ms ({cold.args['batch_size']} requests, prepare "
          f"{prepare_ms:.1f} ms inside), the rest mean {np.mean([b.duration_ms for b in warm]):.1f} ms "
          f"min {min(b.duration_ms for b in warm):.1f} max {max(b.duration_ms for b in warm):.1f}")
    print(f"    pool hits {stats['hits']} prepares {stats['prepares']} restores {stats['restores']}; "
          f"launches per served batch {per_batch}")
    print(f"    against direct solves at width {SERVE_BATCH}: worst |x - x_direct| / gate "
          f"{worst:.3f}, {bit_equal}/{n} bit-equal, iterations max diff "
          f"{int(np.abs(its - direct_its).max())}; summed epochs-to-tol {total} vs JAX CPU "
          f"{ref_total} (ratio {total / ref_total:.4f}, tol {tol:.6g})")
    check(n == SERVE_REQUESTS and stats["requests"] == n and stats["failed_requests"] == 0,
          f"{path}: {stats['requests']} answered of {n}")
    check(worst <= 1.0, f"{path}: a served solution is off its direct solve by {worst:.3f} x the gate")
    check(int(np.abs(its - direct_its).max()) <= 1, f"{path}: iterations differ by more than one")
    check(abs(total / ref_total - 1.0) <= SERVING_ITER_GATE,
          f"{path}: summed epochs-to-tol {total} not within 2% of the JAX package's {ref_total}")
    if path == "dense":
        check(launches["trisolve"] == nb and launches["consensus_update"] == STREAM_CAP * nb,
              f"dense served batches: expected 1 trisolve and {STREAM_CAP} consensus updates "
              f"per batch: {launches} over {nb}")
    else:
        check(launches["spmm_fused_packed"] == STREAM_CAP * nb and launches["spmm"] >= nb
              and launches["spmm_fused"] == 0,
              f"matfree served batches: expected {STREAM_CAP} fused packed passes and spmm_packed "
              f"per batch, no staged pass: {launches} over {nb}")
    return {"pool": server.pool, "fp": fp, "A": A, "dense": dense, "kw": kw, "rhs": rhs,
            "tol": tol, "gaps": gaps, "direct_x": direct_x, "launches": launches,
            "per_batch": per_batch, "batches": nb, "throughput": n / wall,
            "lat_p50": pct(lat, 50), "lat_p99": pct(lat, 99), "queue_p50": pct(queue, 50),
            "queue_p99": pct(queue, 99), "mean_batch": stats["mean_batch_size"],
            "cold_batch_ms": cold.duration_ms, "prepare_ms": prepare_ms,
            "warm_batch_ms": float(np.mean([b.duration_ms for b in warm])),
            "iterations": total, "bit_equal": bit_equal, "profile": profile,
            "lateness_p99": pct(lateness, 99)}


def drifting_phase(path, run, session, serving, card):
    """The session phases' streams as 32 concurrent ``ServerSession``s of
    one column through the pooled kernels-on solver: the summed epochs-to-tol
    within 2% of the JAX package's own server replay, at most 0.7x the
    independent solves' of the session phase, every update converged."""
    t0 = time.perf_counter()
    total, updates, stats = serve_streams(
        serving.SolveServer, run["A"], run["kw"], drift_stream(run["dense"]), session["tol"],
        pool=run["pool"])
    wall = time.perf_counter() - t0
    ref = JAX_CPU_SERVING[path]["drifting_iterations"]
    ratio = total / session["independent_epochs"]
    bad = [(t, i) for t, upd in enumerate(updates) for i, r in enumerate(upd)
           if not (r.converged and np.isfinite(r.x).all())]
    print(f"  {path} drifting [{card}]: {STREAM_COLS} server sessions x {STREAM_UPDATES} updates in "
          f"{wall:.3f} s, {stats['batches']} batches (mean size {stats['mean_batch_size']:.2f}); "
          f"summed epochs-to-tol {total} vs JAX CPU server {ref} (ratio {total / ref:.4f}); "
          f"/ independent {session['independent_epochs']} = {ratio:.4f} (gate {SESSION_RATIO_GATE})")
    check(not bad, f"{path} drifting: unconverged or non-finite updates {bad[:5]}")
    check(abs(total / ref - 1.0) <= SERVING_ITER_GATE,
          f"{path} drifting: {total} epochs not within 2% of the JAX server's {ref}")
    check(ratio <= SESSION_RATIO_GATE, f"{path} drifting: ratio {ratio} above the gate")
    return {"iterations": total, "ratio": ratio, "wall_s": wall, "batches": stats["batches"]}


def coalescing_phase(run, serving, card):
    """32 dense requests at once through the pooled solver, at max_batch 1
    and at 32 (printed, not gated)."""
    import asyncio

    out = {}
    B = run["rhs"][:, :SERVE_BATCH]
    for max_batch in (1, SERVE_BATCH):
        async def burst():
            async with serving.SolveServer(pool=run["pool"], max_batch=max_batch,
                                           max_wait_ms=SERVE_WAIT_MS, num_epochs=STREAM_CAP,
                                           tol=run["tol"]) as server:
                t0 = time.perf_counter()
                await serving.replay_trace(server, run["fp"], B, np.zeros(B.shape[1]))
                return time.perf_counter() - t0, server.stats()

        wall, stats = asyncio.run(asyncio.wait_for(burst(), 600))
        out[max_batch] = B.shape[1] / wall
        print(f"  coalescing [{card}]: {B.shape[1]} dense requests at max_batch {max_batch}: "
              f"{wall:.3f} s, {stats['batches']} batches -> {out[max_batch]:.1f} req/s")
    return out


def checkpoint_phase(torch, runs, serving, card):
    """The pooled solvers saved through the port's ``CheckpointStore`` and
    restored by a fresh server with a fresh pool of one entry: no prepare,
    two restores, each served batch equal bit for bit to the saved solver's
    solve of it; and the dense solver's eviction (the matrix-free system's
    restore) releases at least half its ``memory_bytes`` on the card."""
    import asyncio
    import gc
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        store = serving.CheckpointStore(d)
        saved = {}
        for path, run in runs.items():
            t0 = time.perf_counter()
            prep = run["pool"].get(run["fp"])
            check(store.save(run["fp"], prep, run["kw"]), f"{path}: checkpoint save refused")
            saved[path] = (prep, time.perf_counter() - t0)
        tracer = serving.Tracer()
        memory = {}

        async def restore():
            async with serving.SolveServer(max_batch=SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS,
                                           num_epochs=STREAM_CAP, pool_size=1, checkpoint=d,
                                           tracer=tracer) as server:
                fps = {path: server.register(run["A"], **run["kw"]) for path, run in runs.items()}
                served = {}
                for path, run in runs.items():
                    B = run["rhs"][:, :SERVE_BATCH]
                    opts = serving.SubmitOptions(tol=run["tol"])
                    served[path] = await asyncio.gather(
                        *(server.submit(fps[path], B[:, i], opts) for i in range(B.shape[1])))
                    gc.collect()
                    torch.cuda.synchronize()
                    memory[path] = (torch.cuda.memory_allocated(), server.pool.resident())
                return served, server.stats()

        served, stats = asyncio.run(asyncio.wait_for(restore(), 600))
    restore_ms = {s.args["fingerprint"]: s.duration_ms for s in tracer.spans()
                  if s.name == "pool.restore"}
    out = {"restores": stats["restores"], "prepares": stats["prepares"]}
    for path, run in runs.items():
        prep, save_s = saved[path]
        B = run["rhs"][:, :SERVE_BATCH]
        want = prep.solve(B, num_epochs=STREAM_CAP, tol=run["tol"]).x
        same = sum(bool(np.array_equal(r.x, want[:, i])) for i, r in enumerate(served[path]))
        out[path] = {"restore_ms": restore_ms.get(run["fp"]), "prepare_ms": run["prepare_ms"],
                     "save_s": save_s, "bit_equal": same}
        print(f"  checkpoint {path} [{card}]: save {save_s * 1e3:.1f} ms, restore "
              f"{restore_ms.get(run['fp'], float('nan')):.1f} ms against prepare "
              f"{run['prepare_ms']:.1f} ms; served batch bit-equal to the saved solver on "
              f"{same}/{B.shape[1]} requests")
        check(same == B.shape[1], f"{path}: restored solves differ from the saved solver's")
    print(f"  restoring server: pool restores {stats['restores']}, prepares {stats['prepares']}, "
          f"evictions {stats['evictions']}")
    check(stats["restores"] == 2 and stats["prepares"] == 0,
          f"the restoring server prepared: {stats}")
    (held, (dense_entry,)), (after, _) = memory["dense"], memory["matfree"]
    freed = held - after
    print(f"  eviction of the dense solver ({dense_entry['memory_bytes'] / 1e6:.1f} MB of factors): "
          f"torch.cuda.memory_allocated {held / 1e6:.1f} -> {after / 1e6:.1f} MB "
          f"(freed {freed / 1e6:.1f} MB)")
    check(freed >= 0.5 * dense_entry["memory_bytes"],
          f"evicting the dense solver freed {freed} bytes of {dense_entry['memory_bytes']}")
    out["freed_bytes"] = freed
    out["dense_memory_bytes"] = dense_entry["memory_bytes"]
    return out


def fault_phase(run, serving, card):
    """One fault plan on the dense Poisson replay (watchdog armed, replay
    with ``return_exceptions``): a persistent poison fails alone, with
    ``SolveFailure``; a one-shot solve error is retried (the failing batch
    redispatched in halves) and answered; a NaN planted in one column is
    flagged by the watchdog, that column alone, and recovers on the retry.
    Every other request is answered within the kernels-on/off gate."""
    import asyncio

    poison, transient, nan = 40, 100, 170
    plan = serving.FaultPlan(rules=(
        serving.FaultRule(site="solve", kind="error", request=poison),
        serving.FaultRule(site="solve", kind="error", request=transient, times=1),
        serving.FaultRule(site="solve", kind="nan", request=nan, times=1),
    ), seed=17)
    faults = serving.FaultInjector(plan)

    async def replay():
        async with serving.SolveServer(pool=run["pool"], max_batch=SERVE_BATCH,
                                       max_wait_ms=SERVE_WAIT_MS, num_epochs=STREAM_CAP,
                                       tol=run["tol"], faults=faults,
                                       watchdog=serving.Watchdog()) as server:
            t0 = time.perf_counter()
            results = await serving.replay_trace(server, run["fp"], run["rhs"], run["gaps"],
                                                 return_exceptions=True)
            v = server.metrics.value
            flags = {r: int(v("server_failures_total", reason=r)) for r in ("nan", "stalled")}
            return results, time.perf_counter() - t0, server.stats(), flags

    results, wall, stats, flags = asyncio.run(asyncio.wait_for(replay(), 600))
    failed = {i: r for i, r in enumerate(results) if isinstance(r, BaseException)}
    worst = max(float(np.abs(r.x - run["direct_x"][:, i]).max())
                / served_tolerance("dense", run["direct_x"][:, i])
                for i, r in enumerate(results) if i not in failed)
    fires = [s["fires"] for s in faults.stats()]
    attempts = {i: r.attempts for i, r in enumerate(results) if i not in failed and r.attempts != 1}
    print(f"  faults [{card}]: {len(results)} requests in {wall:.3f} s; failed {sorted(failed)} "
          f"({[(f.reason, f.request, f.attempts) for f in failed.values()]}); rule fires {fires}; "
          f"watchdog flags {flags}; retries {stats['retries']}, recovered "
          f"{stats['recovered_requests']}; requests with more than one attempt {attempts}; "
          f"worst |x - x_direct| / gate {worst:.3f}")
    check(set(failed) == {poison} and isinstance(failed[poison], serving.SolveFailure)
          and failed[poison].request == poison and failed[poison].reason == "error",
          f"faults: expected request {poison} alone to fail: {failed}")
    check(worst <= 1.0, f"faults: a batchmate is off its direct solve by {worst:.3f} x the gate")
    check(fires[1] == 1 and stats["retries"] >= 1,
          f"faults: the one-shot error fired {fires[1]} times, retries {stats['retries']}")
    check(flags == {"nan": 1, "stalled": 0} and attempts == {nan: 2},
          f"faults: watchdog flags {flags}, attempts {attempts}: expected request {nan} alone")
    return {"failed": sorted(failed), "fires": fires, "flags": flags, "wall_s": wall,
            "retries": stats["retries"], "recovered": stats["recovered_requests"]}


def serving_phases(torch, ops, make_problem, sessions, card):
    """Every serving phase on the card, in order; returns their numbers."""
    from repro_torch import serving as srv
    from repro_torch.core import Watchdog
    from repro_torch.obs import Tracer

    serving = SimpleNamespace(
        SolveServer=srv.SolveServer, replay_trace=srv.replay_trace,
        CheckpointStore=srv.CheckpointStore, SubmitOptions=srv.SubmitOptions,
        FaultPlan=srv.FaultPlan, FaultRule=srv.FaultRule, FaultInjector=srv.FaultInjector,
        SolveFailure=srv.SolveFailure, Tracer=Tracer, Watchdog=Watchdog)
    t0 = time.perf_counter()
    runs = {path: poisson_phase(torch, ops, path, make_problem, serving, card)
            for path in ("dense", "matfree")}
    drifting = {path: drifting_phase(path, runs[path], sessions[path], serving, card)
                for path in ("dense", "matfree")}
    coalescing = coalescing_phase(runs["dense"], serving, card)
    restore = checkpoint_phase(torch, runs, serving, card)
    faults = fault_phase(runs["dense"], serving, card)
    seconds = time.perf_counter() - t0
    print(f"  serving phases: {seconds:.1f} s")
    summary = {path: {k: v for k, v in run.items() if isinstance(v, (int, float, str, dict))
                      and k not in ("kw", "pool")} for path, run in runs.items()}
    print(json.dumps({"serving": {"poisson": summary, "drifting": drifting,
                                  "coalescing_req_per_s": coalescing, "checkpoint": restore,
                                  "faults": faults, "seconds": seconds}, "card": card}))
    return runs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not at {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build
    from repro_torch.kernels.project import ops as project_ops
    from repro_torch.kernels.project.ref import consensus_update_ref, project_ref
    from repro_torch.kernels.spmm import ops as spmm_ops
    from repro_torch.kernels.spmm.ref import (
        spmm_fused_packed_plain,
        spmm_fused_plain,
        spmm_packed_plain,
        spmm_plain,
    )
    from repro_torch.kernels.trisolve import ops as trisolve_ops
    from repro_torch.kernels.trisolve.ref import trisolve_ref
    from repro_torch.core import prepare
    from repro_torch.launch import solve as launch_solve
    from repro_torch.sparse import make_problem

    ops = SimpleNamespace(trisolve=trisolve_ops, project=project_ops, spmm=spmm_ops)
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch.cuda.get_device_name(): {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    per_source = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall, per source {per_source}")
    for name, log in _build.BUILD_LOG.items():
        print(f"--- nvcc {name}.cu -Xptxas -v ---\n{log.strip()}")

    print("kernel phase (kernel vs plain version on the card):")
    cases = kernel_phase(torch, trisolve_ops, trisolve_ref, project_ops, project_ref,
                         consensus_update_ref)

    print("main path (repro_torch.launch.solve --kernels --implicit-p --device cuda):")
    runs = {J: main_path_run(torch, launch_solve, ops, 2327, 9308, J, 32, gate=True)
            for J in (2, 8)}
    print("scale run (timed, not gated):")
    scale = main_path_run(torch, launch_solve, ops, 4096, 16384, 8, 64, gate=False)

    print("matrix-free path (repro_torch.launch.solve --mode matfree --kernels --device cuda):")
    mf_small = matfree_run(torch, launch_solve, ops, 2327, "matfree", 300)
    resid = mf_small["record"]["final_residual_sq_max"]
    ref = JAX_CPU_MATFREE_RESIDUAL
    print(f"    residual {resid:.6e} vs JAX CPU {ref:.6e} (ratio {resid / ref:.4f}, "
          f"allowed 1/{RESIDUAL_FACTOR:g}..{RESIDUAL_FACTOR:g})")
    check(ref / RESIDUAL_FACTOR <= resid <= ref * RESIDUAL_FACTOR,
          f"matfree n=2327: residual {resid} not within {RESIDUAL_FACTOR}x of {ref}")
    check(mf_small["prep"].gram_solver == "direct", "matfree n=2327: expected the direct Gram solver")
    print("matrix-free path at n=16384 (--mode auto must resolve matfree with PCG):")
    mf_big = matfree_run(torch, launch_solve, ops, 16384, "auto", 100)
    check(mf_big["prep"].gram_solver == "pcg", "matfree n=16384: expected the PCG Gram solver")
    # 15 Gram products per epoch (the PCG depth) over 100 epochs, all packed
    check(mf_big["launches"]["spmm"] >= 1500,
          f"matfree n=16384: {mf_big['launches']['spmm']} packed SpMM launches, expected >= 1500")

    print("SpMM kernel phase (kernel vs plain version on the card, operators of the runs above):")
    cases.update(spmm_phase(torch, spmm_ops, spmm_plain, spmm_packed_plain, spmm_fused_plain,
                            spmm_fused_packed_plain, mf_small["prep"].op, mf_big["prep"].op))

    print("baselines at the Table 1 width (repro_torch.launch.solve --method dgd|cgnr --device cuda):")
    t0 = time.perf_counter()
    for method in ("dgd", "cgnr"):
        baseline_run(torch, launch_solve, ops, method)
    print(f"  baseline phase: {time.perf_counter() - t0:.1f} s")
    print(f"sessions: {STREAM_UPDATES} updates of {STREAM_COLS} drifting streams through the "
          f"kernels-on solvers, cap {STREAM_CAP} epochs:")
    t0 = time.perf_counter()
    sessions = {path: session_phase(torch, ops, path, make_problem, prepare)
                for path in ("dense", "matfree")}
    print(f"  session phases: {time.perf_counter() - t0:.1f} s")
    print("watchdog and per-block diagnostics on the card:")
    t0 = time.perf_counter()
    watchdog_phase(sessions)
    print(f"  watchdog phase: {time.perf_counter() - t0:.1f} s")
    print(f"serving (repro_torch.serving.SolveServer, kernels on, max_batch {SERVE_BATCH}, "
          f"{SERVE_WAIT_MS:g} ms window, cap {STREAM_CAP}) on {card}:")
    served = serving_phases(torch, ops, make_problem, sessions, card)

    def entry(name, source, replaces, launches, case, extra=(), **notes):
        out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches, **cases[case], **notes}
        if extra:
            out["cases"] = [{"name": e, **cases[e]} for e in extra]
        return out

    staged = {"main_path": False,
              "note": "the staged interface counterpart; the main path runs spmm_fused_packed"}
    on_session = {"path": f"one warm update of the session phase (update {STREAM_UPDATES // 2})"}

    def on_served(path):
        run = served[path]
        return {"path": "a served batch of the Poisson phase", "launches_per": "served batch",
                "batches": run["batches"], "launches_in_replay": run["launches"]}

    def per_batch(path, kernel):
        value = served[path]["per_batch"][kernel]
        return int(value) if float(value).is_integer() else value

    kernels = [
        entry("trisolve.upper", TRISOLVE_SRC, TRISOLVE_TPU,
              runs[2]["launches"]["trisolve"], "trisolve.upper"),
        entry("trisolve.lower_t", TRISOLVE_SRC, TRISOLVE_TPU,
              runs[8]["launches"]["trisolve"], "trisolve.lower_t", ["trisolve.lower_t.f64"]),
        entry("consensus_update.tall", PROJECT_SRC, PROJECT_TPU,
              runs[2]["launches"]["consensus_update"], "consensus_update.tall"),
        entry("consensus_update.wide", PROJECT_SRC, PROJECT_TPU,
              runs[8]["launches"]["consensus_update"], "consensus_update.wide",
              ["consensus_update.wide.x_gamma", "consensus_update.wide.bf16"]),
        entry("consensus_update.scale", PROJECT_SRC, PROJECT_TPU,
              scale["launches"]["consensus_update"], "consensus_update.scale"),
        entry("spmm.matfree_2327", SPMM_SRC, SPMM_TPU, mf_small["launches"]["spmm"],
              "spmm.fwd.n2327", ["spmm.fwd.n2327.k1", "spmm.tile16x8"]),
        entry("spmm.matfree_16384", SPMM_SRC, SPMM_TPU, mf_big["launches"]["spmm"],
              "spmm.gram.n16384", ["spmm.fwd.n16384", "spmm.tra.n16384"]),
        entry("spmm_fused_packed.matfree_2327", SPMM_SRC, SPMM_FUSED_TPU,
              mf_small["launches"]["spmm_fused_packed"], "spmm_fused_packed.n2327"),
        entry("spmm_fused_packed.matfree_16384", SPMM_SRC, SPMM_FUSED_TPU,
              mf_big["launches"]["spmm_fused_packed"], "spmm_fused_packed.n16384"),
        entry("spmm_fused.matfree_2327", SPMM_SRC, SPMM_FUSED_TPU,
              mf_small["launches"]["spmm_fused"], "spmm_fused.n2327", ["spmm_fused.tile16x8"],
              **staged),
        entry("spmm_fused.matfree_16384", SPMM_SRC, SPMM_FUSED_TPU,
              mf_big["launches"]["spmm_fused"], "spmm_fused.n16384", **staged),
        # one warm session update; the operands have the shapes of the rows
        # whose measured case each row carries
        entry("trisolve.session_dense", TRISOLVE_SRC, TRISOLVE_TPU,
              sessions["dense"]["launches"]["trisolve"], "trisolve.lower_t", **on_session),
        entry("consensus_update.session_dense", PROJECT_SRC, PROJECT_TPU,
              sessions["dense"]["launches"]["consensus_update"], "consensus_update.wide",
              **on_session),
        entry("spmm.session_matfree", SPMM_SRC, SPMM_TPU, sessions["matfree"]["launches"]["spmm"],
              "spmm.fwd.n2327", **on_session),
        entry("spmm_fused_packed.session_matfree", SPMM_SRC, SPMM_FUSED_TPU,
              sessions["matfree"]["launches"]["spmm_fused_packed"], "spmm_fused_packed.n2327",
              **on_session),
        # one served batch of the Poisson phases (launches per batch: the
        # replay's counts over its batches); same operand shapes as the cases
        entry("trisolve.served_dense", TRISOLVE_SRC, TRISOLVE_TPU,
              per_batch("dense", "trisolve"), "trisolve.lower_t", **on_served("dense")),
        entry("consensus_update.served_dense", PROJECT_SRC, PROJECT_TPU,
              per_batch("dense", "consensus_update"), "consensus_update.wide",
              **on_served("dense")),
        entry("spmm.served_matfree", SPMM_SRC, SPMM_TPU, per_batch("matfree", "spmm"),
              "spmm.fwd.n2327", **on_served("matfree")),
        entry("spmm_fused_packed.served_matfree", SPMM_SRC, SPMM_FUSED_TPU,
              per_batch("matfree", "spmm_fused_packed"), "spmm_fused_packed.n2327",
              **on_served("matfree")),
    ]
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
