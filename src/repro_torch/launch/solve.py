"""Solver command line (the paper's workload as a launchable job).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.solve --n 1024 --m 4096 \
      --blocks 8 --method dapc --epochs 100
  ... --rhs 32                  # a 32-RHS batch against one prepared factorization
  ... --kernels --implicit-p    # the hand-written CUDA kernels
  ... --n 2327 --m 2327 --mode matfree --kernels   # the sparse operator path
  ... --mode matfree --mesh 4 --backend gloo   # blocked-ELL shards on 4 ranks
  ... --device cpu              # the card is the default

Prints the same JSON record as the reference package's command line. With
``--mesh D`` it spawns D ranks (``repro_torch.launch.mesh.run_ranks``), each
prepares and solves its shard, and rank 0 prints the record with the mesh's
numbers: ``mesh_devices``, ``backend``, ``per_device_mb`` and each rank's
device bytes, solve time and kernel launches. ``nccl`` (the default on the
card) needs one card per rank; ``--backend gloo`` runs every rank on one card
and stages each all-reduce through host memory.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--m", type=int, default=4096)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--method", default="dapc",
                    choices=["apc", "dapc", "dgd", "cgnr"])
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--gamma", type=float, default=1.0)
    ap.add_argument("--eta", type=float, default=0.9)
    ap.add_argument("--rhs", type=int, default=1,
                    help="number of right-hand sides solved as one batch "
                         "against the prepared factorization")
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "dense", "matfree"],
                    help="execution path: dense blocks, matrix-free sparse "
                         "operator, or auto (nnz/memory estimate)")
    ap.add_argument("--gram-solver", default="auto", choices=["auto", "direct", "pcg"],
                    help="matfree inner Gram solver (auto: direct while the "
                         "stacked inverses fit, PCG beyond)")
    ap.add_argument("--mesh", type=int, default=0, metavar="D",
                    help="shard the matfree operator over D ranks, one "
                         "process each (requires --mode matfree)")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="process-group backend of --mesh (default: nccl on "
                         "the card, gloo on the CPU)")
    ap.add_argument("--audit", action="store_true",
                    help="with --mesh: count the collectives of one epoch, "
                         "without and with a tol (audit_epoch_collectives)")
    ap.add_argument("--profile", action="store_true",
                    help="with --mesh on the card: time one more warm solve "
                         "per rank under torch.profiler (device busy time)")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="write the record, x and the residual history to "
                         "this .npz (rank 0)")
    ap.add_argument("--implicit-p", action="store_true",
                    help="beyond-paper: never materialize the projector")
    ap.add_argument("--kernels", action="store_true",
                    help="route through the hand-written CUDA kernels")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' must be asked for)")
    return ap.parse_args(argv)


def run(argv=None, mesh=None):
    """Prepare and solve as the command line says (on ``mesh`` when given:
    every rank of it calls this); returns ``(record, prepared_solver,
    solve_result, b, x_ref)``, the last two the host right-hand side and
    reference solution it solved for."""
    args = parse_args(argv)

    import numpy as np

    from repro_torch.core import prepare
    from repro_torch.sparse import make_problem

    prob = make_problem(n=args.n, m=args.m, seed=0, dtype=np.float32)
    kw = {}
    if args.method == "dapc":
        kw = {"materialize_p": not args.implicit_p, "use_kernels": args.kernels}
    if args.gram_solver != "auto":
        kw["gram_solver"] = args.gram_solver
    if mesh is not None:
        kw["mesh"] = mesh
    # square systems stay sparse end to end: hand prepare the COO
    A = prob.coo if prob.shape[0] == prob.shape[1] else prob.A
    prep = prepare(
        A, method=args.method, num_blocks=args.blocks, mode=args.mode,
        gamma=args.gamma, eta=args.eta, device=args.device, **kw,
    )
    if args.rhs > 1:
        rng = np.random.default_rng(1)
        xs = rng.standard_normal((args.n, args.rhs)).astype(np.float32)
        b, x_ref = prob.A @ xs, xs
    else:
        b, x_ref = prob.b, prob.x_true
    res = prep.solve(b, num_epochs=args.epochs, x_ref=x_ref)
    mse = np.asarray(res.final_mse)
    record = {
        "method": res.method, "mode": res.mode, "blocks": res.num_blocks,
        "epochs": res.num_epochs, "num_rhs": res.num_rhs,
        "path": prep.path,
        "device": str(prep.device),
        "setup_seconds": round(prep.setup_seconds, 3),
        "solve_seconds": round(res.wall_seconds, 3),
        "initial_mse": float(np.max(np.asarray(res.history["initial"]["mse"]))),
        "final_mse_max": float(mse.max()),
        "final_residual_sq_max": float(np.max(np.asarray(res.final_residual))),
    }
    return record, prep, res, b, x_ref


def _device_busy_ms(fn) -> tuple[float, float]:
    """(host wall ms, device busy ms) of ``fn()`` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    busy_us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            busy_us += getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
    return wall * 1e3, busy_us / 1e3


def _all_reduce_ms(comm, numel: int, device, iters: int = 50) -> float:
    """Mean host milliseconds of one all-reduce of ``numel`` float32 on
    ``device`` over ``comm`` (every rank calls this in step)."""
    import torch

    from repro_torch.device import synchronize

    device = torch.device(device)
    t = torch.zeros(numel, device=device)
    for _ in range(3):
        comm.all_reduce(t)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        comm.all_reduce(t)
    synchronize(device)
    return (time.perf_counter() - t0) / iters * 1e3


def rank_main(rank: int, argv) -> None:
    """One rank of ``--mesh D``: prepare and solve this rank's shard, gather
    every rank's numbers, and (rank 0) print the record and write ``--out``."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.kernels.spmm import ops as spmm_ops
    from repro_torch.launch.mesh import make_host_local_mesh

    args = parse_args(argv)
    mesh = make_host_local_mesh(args.mesh, device=args.device, backend=args.backend)
    for key in spmm_ops.launches:
        spmm_ops.launches[key] = 0
    record, prep, res, b, x_ref = run(argv, mesh=mesh)
    mine = {
        "rank": rank,
        "device": str(prep.device),
        "device_bytes": prep.local_memory_bytes,
        "solve_seconds": res.wall_seconds,
        "launches": dict(spmm_ops.launches),
    }
    if args.profile and prep.device.type == "cuda":
        wall_ms, busy_ms = _device_busy_ms(
            lambda: prep.solve(b, num_epochs=args.epochs, x_ref=x_ref))
        # the epoch's consensus all-reduce alone, on the card (and, where
        # the backend takes them, on host tensors)
        numel = args.n * max(args.rhs, 1)
        mine.update(warm_wall_ms=wall_ms, device_busy_ms=busy_ms,
                    all_reduce_ms=_all_reduce_ms(prep.comm, numel, prep.device),
                    all_reduce_1_ms=_all_reduce_ms(prep.comm, 1, prep.device))
        if dist.get_backend() == "gloo":
            mine["all_reduce_host_ms"] = _all_reduce_ms(prep.comm, numel, "cpu")
    if args.audit:
        for tag, tol in (("", None), ("_tol", 1.0)):
            audit = obs.audit_epoch_collectives(prep, b, num_epochs=4, tol=tol)
            mine["audit" + tag] = {"ops": audit["ops"], "payload_elems": audit["payload_elems"]}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    if rank != 0:
        return
    record.update(
        gram_solver=prep.gram_solver,
        mesh_devices=args.mesh,
        backend=dist.get_backend(),
        per_device_mb=round(prep.per_device_memory_bytes / 1e6, 3),
        memory_mb=round(prep.memory_bytes / 1e6, 3),
        ranks=ranks,
    )
    print(json.dumps(record, indent=1))
    if args.out:
        np.savez(args.out, record=json.dumps(record), x=res.x,
                 residual_sq=res.history["residual_sq"])


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.mesh:
        if args.mode != "matfree":
            raise SystemExit("--mesh shards the matfree path; pass --mode matfree")
        if args.blocks % args.mesh:
            raise SystemExit(f"--blocks {args.blocks} must divide over --mesh "
                             f"{args.mesh} devices")
        from repro_torch.device import resolve_device
        from repro_torch.launch.mesh import run_ranks

        if args.kernels and resolve_device(args.device).type == "cuda":
            from repro_torch.kernels import _build

            _build.build()  # once here, not once per rank
        run_ranks(rank_main, args.mesh, args.backend, args.device, (argv,))
        return None
    record = run(argv)[0]
    print(json.dumps(record, indent=1))
    return record


if __name__ == "__main__":
    main()
