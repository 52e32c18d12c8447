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
10. prints the kernel table as one JSON line (with a row per kernel of one
   warm session update, carrying the measured case of the same shapes), the
   card line again, and the ``{"ok": true, "device": ...}`` line last.

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

    def entry(name, source, replaces, launches, case, extra=(), **notes):
        out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches, **cases[case], **notes}
        if extra:
            out["cases"] = [{"name": e, **cases[e]} for e in extra]
        return out

    staged = {"main_path": False,
              "note": "the staged interface counterpart; the main path runs spmm_fused_packed"}
    on_session = {"path": f"one warm update of the session phase (update {STREAM_UPDATES // 2})"}

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
