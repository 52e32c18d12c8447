"""Solver command line (the paper's workload as a launchable job).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.solve --n 1024 --m 4096 \
      --blocks 8 --method dapc --epochs 100
  ... --rhs 32                  # a 32-RHS batch against one prepared factorization
  ... --kernels --implicit-p    # the hand-written CUDA kernels
  ... --n 2327 --m 2327 --mode matfree --kernels   # the sparse operator path
  ... --device cpu              # the card is the default

Prints the same JSON record as the reference package's command line.
"""
from __future__ import annotations

import argparse
import json


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
    ap.add_argument("--implicit-p", action="store_true",
                    help="beyond-paper: never materialize the projector")
    ap.add_argument("--kernels", action="store_true",
                    help="route through the hand-written CUDA kernels")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' must be asked for)")
    return ap.parse_args(argv)


def run(argv=None):
    """Prepare and solve as the command line says; returns
    ``(record, prepared_solver, solve_result, b, x_ref)``, the last two the
    host right-hand side and reference solution it solved for."""
    args = parse_args(argv)

    import numpy as np

    from repro_torch.core import prepare
    from repro_torch.sparse import make_problem

    prob = make_problem(n=args.n, m=args.m, seed=0, dtype=np.float32)
    kw = {}
    if args.method == "dapc":
        kw = {"materialize_p": not args.implicit_p, "use_kernels": args.kernels}
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


def main(argv=None):
    record = run(argv)[0]
    print(json.dumps(record, indent=1))
    return record


if __name__ == "__main__":
    main()
