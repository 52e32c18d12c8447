#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

1. prints the card (nvidia-smi name and power limit) and turns TF32 off;
2. builds the hand-written kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, in parallel) and prints nvcc's ``-Xptxas -v`` report;
3. holds each dense-path kernel against its plain PyTorch version on the
   card at the main path's shapes, and times the kernel, the plain version
   and one PyTorch library call computing the same function (a yardstick
   only; the port never calls it);
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
   matrix-free path with the PCG Gram solver. Each is checked against the
   kernels-off solver restored from its own state on the card (within
   2.5e-4·max|x|), the n=2327 residual against the JAX package's CPU value;
6. holds the two blocked-ELL SpMM kernels against their plain versions on
   the operators those runs prepared (forward, transposed and Gram shards),
   timed beside one ``torch.sparse.mm`` (cuSPARSE) of the same shards laid
   out as a block-diagonal CSR matrix;
7. prints the kernel table as one JSON line, the card line again, and the
   ``{"ok": true, "device": ...}`` line last.

Any failed check raises, so the run exits non-zero and prints no last line.
Without CUDA, or without the repository beside it, it exits non-zero too.
"""
from __future__ import annotations

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
RESIDUAL_FACTOR = 10.0  # the card's residual must lie within 10x either way
# kernels-on vs kernels-off matrix-free solutions, as a share of max|x|: the
# reference's own full-size gate between two float32 trajectories
# (benchmarks/sparse.py)
MATFREE_AGREEMENT = 2.5e-4

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the highest dense
# FLOP/s for each input type (f32 outside the tensor cores; f64 and bf16 on
# them), so that bound_ms is the least time the card could take
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12, "bfloat16": 989e12}

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


def bound(nbytes: float, flops: float, dtype_name: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
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
        s = r.element_size()
        nbytes = J * n * (n + 1) / 2 * s + 2 * J * n * k * s
        flops = J * k * float(n) * n
        b_ms, b_by = bound(nbytes, flops, str(dtype).split(".")[1])
        results[name] = {
            "shape": f"R ({J}, {n}, {n}) y ({J}, {n}, {k}) {str(dtype).split('.')[1]}"
                     f" {'lower' if lower else 'upper'}{' on R^T' if transpose else ''}",
            "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
        }
        print(f"  {name:26s} err {err:.3e} (tol {tol:.1e})  kernel {ms:.4f} ms  "
              f"plain {plain:.4f} ms  library {lib:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
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
        sx = xbar.element_size()
        nbytes = J * p * n * w.element_size() + J * n * k * sx * (3 if with_x else 2)
        flops = 4.0 * J * p * n * k
        b_ms, b_by = bound(nbytes, flops, str(w.dtype).split(".")[1])
        results[name] = {
            "shape": f"W ({J}, {p}, {n}) {str(w.dtype).split('.')[1]}, x̄ ({J}, {n}, {k}) "
                     f"{str(x_dtype).split('.')[1]}" + (", x and per-block γ" if with_x else ", project"),
            "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
        }
        print(f"  {name:26s} err {err:.3e} (tol {tol:.1e})  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  library {lib:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
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
    return results


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


def profile_solve(torch, prep, b, x_ref, epochs) -> dict:
    """Where one warm solve's time goes: device time by kernel and the
    device's busy share of the host wall time, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = prep.solve(b, num_epochs=epochs, x_ref=x_ref).wall_seconds
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
    print(f"    profile of one warm solve: wall {wall * 1e3:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / (wall * 1e3):.1f}%), "
          f"{sum(r[1] for r in rows)} kernels run")
    for dev_us, count, name in rows[:8]:
        print(f"      {dev_us / 1e3:9.3f} ms  x{count:<5d} {name[:90]}")
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms}


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
    check(record["path"] == "matfree", f"n={n}: path {record['path']}, expected matfree")
    check(launches["spmm"] >= 1 and launches["spmm_fused"] >= 1,
          f"n={n}: a kernel of the matrix-free path was not launched: {launches}")
    check(res.x.shape == (n, 32), f"n={n}: solution shape {res.x.shape}")
    check(bool(np.isfinite(res.x).all()), f"n={n}: non-finite solution")
    warm = prep.solve(b, num_epochs=epochs, x_ref=x_ref).wall_seconds
    print(f"    warm solve (same prepared solver, second call): {warm:.4f} s")
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


def spmm_phase(torch, spmm_ops, spmm_plain, spmm_fused_plain, op_small, op_big):
    """The SpMM kernels against their plain versions on the card, on the
    operators the matrix-free runs prepared, at k = 32."""
    from repro_torch.sparse import PartitionedBSR, generate_schenk_like
    from repro_torch.sparse.bsr import _pad_cols

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    results = {}

    def case(name, what, indices, data, xb, y=None, iters=20):
        fused = y is not None
        if fused:
            def run():
                return spmm_ops.spmm_fused(indices, data, xb, y)

            def plain():
                return spmm_fused_plain(indices, data, xb, y)
        else:
            def run():
                return (spmm_ops.spmm(indices, data, xb),)

            def plain():
                return (spmm_plain(indices, data, xb),)
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        # the reference's own tolerance (tests/test_kernel_spmm.py): atol
        # 1e-4 plus rtol 1e-4 of the largest entry
        tol = min(1e-4 + 1e-4 * float(w.abs().max()) for w in want)
        ms = cuda_ms(torch, run, iters)
        plain_ms = cuda_ms(torch, plain, max(iters // 4, 3))
        lib = lib_err = None
        if not fused:
            C = xb.shape[1]
            csr = block_diag_csr(torch, indices, data, C)
            xs = xb.contiguous().reshape(-1, xb.shape[-1])
            lib_out = torch.sparse.mm(csr, xs)
            lib_err = float((lib_out.reshape(want[0].shape) - want[0]).abs().max())
            lib = cuda_ms(torch, lambda: torch.sparse.mm(csr, xs), iters)
        J, R, S, bp, bn = data.shape
        k = xb.shape[-1]
        s = data.element_size()
        x_bytes = xb[0].numel() * s * (1 if xb.stride(0) == 0 else J)
        nbytes = (indices.numel() * 4 + data.numel() * s + x_bytes
                  + sum(t.numel() for t in got) * s + (y.numel() * s if fused else 0))
        flops = 2.0 * int(torch.count_nonzero(data)) * k * (2 if fused else 1)
        b_ms, b_by = bound(nbytes, flops, str(data.dtype).split(".")[1])
        results[name] = {
            "shape": f"{what}: indices {tuple(indices.shape)}, tiles {(bp, bn)}, k {k}"
                     + (", x broadcast over J" if xb.stride(0) == 0 else "")
                     + (", staged contrib" if fused else ""),
            "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
        }
        lib_txt = "—" if lib is None else f"{lib:.4f} ms (err {lib_err:.1e})"
        print(f"  {name:24s} err {err:.3e} (tol {tol:.1e})  kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  library {lib_txt}  bound {b_ms:.4f} ms ({b_by}, "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")
        check(err <= tol, f"{name}: max error {err} above {tol}")

    def col_tiles(op, k):  # the main path's broadcast operand: padded once
        x = torch.randn(op.shape[1], k, generator=gen, device=dev)
        return op._col_tiles(x)

    def rows(op, k):  # (J, p_pad, k) row-space operand
        return torch.randn(op.num_blocks, op.p_pad, k, generator=gen, device=dev)

    def row_tiles(op, k):  # its (J, R, bp, k) view for the fused kernel
        return rows(op, k).reshape(op.num_blocks, -1, op.block_shape[0], k)

    for label, op in (("n2327", op_small), ("n16384", op_big)):
        iters = 20 if label == "n2327" else 10
        case(f"spmm.fwd.{label}", "forward shards", op.fwd_indices, op.fwd_data,
             col_tiles(op, 32), iters=iters)
        case(f"spmm_fused.{label}", "forward shards, fused", op.fwd_indices, op.fwd_data,
             col_tiles(op, 32), row_tiles(op, 32), iters=iters)
    case("spmm.fwd.n2327.k1", "forward shards, one RHS", op_small.fwd_indices,
         op_small.fwd_data, col_tiles(op_small, 1))
    bp = op_big.block_shape[0]
    case("spmm.tra.n16384", "transposed shards", op_big.tra_indices, op_big.tra_data,
         _pad_cols(rows(op_big, 32), op_big.p_pad, bp), iters=10)
    case("spmm.gram.n16384", "Gram shards", op_big.gram_indices, op_big.gram_data,
         _pad_cols(rows(op_big, 32), op_big.p_pad, bp), iters=10)
    tall = PartitionedBSR.from_coo(generate_schenk_like(2048, seed=5), 8, (16, 8), device=dev)
    case("spmm.tile16x8", "forward shards, (16, 8) tiles", tall.fwd_indices, tall.fwd_data,
         col_tiles(tall, 32))
    case("spmm_fused.tile16x8", "forward shards, (16, 8) tiles, fused", tall.fwd_indices,
         tall.fwd_data, col_tiles(tall, 32), row_tiles(tall, 32))
    return results


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
    from repro_torch.kernels.spmm.ref import spmm_fused_plain, spmm_plain
    from repro_torch.kernels.trisolve import ops as trisolve_ops
    from repro_torch.kernels.trisolve.ref import trisolve_ref
    from repro_torch.launch import solve as launch_solve

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
    main_path_run(torch, launch_solve, ops, 4096, 16384, 8, 64, gate=False)

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

    print("SpMM kernel phase (kernel vs plain version on the card, operators of the runs above):")
    cases.update(spmm_phase(torch, spmm_ops, spmm_plain, spmm_fused_plain,
                            mf_small["prep"].op, mf_big["prep"].op))

    def entry(name, source, replaces, launches, case, extra=()):
        out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches, **cases[case]}
        if extra:
            out["cases"] = [{"name": e, **cases[e]} for e in extra]
        return out

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
        entry("spmm.matfree_2327", SPMM_SRC, SPMM_TPU, mf_small["launches"]["spmm"],
              "spmm.fwd.n2327", ["spmm.fwd.n2327.k1", "spmm.tile16x8"]),
        entry("spmm.matfree_16384", SPMM_SRC, SPMM_TPU, mf_big["launches"]["spmm"],
              "spmm.gram.n16384", ["spmm.fwd.n16384", "spmm.tra.n16384"]),
        entry("spmm_fused.matfree_2327", SPMM_SRC, SPMM_FUSED_TPU,
              mf_small["launches"]["spmm_fused"], "spmm_fused.n2327", ["spmm_fused.tile16x8"]),
        entry("spmm_fused.matfree_16384", SPMM_SRC, SPMM_FUSED_TPU,
              mf_big["launches"]["spmm_fused"], "spmm_fused.n16384"),
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
