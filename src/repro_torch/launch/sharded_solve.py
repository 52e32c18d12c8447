"""Dense sharded solver command line: ``solve_sharded`` / ``solve_sharded_2d``
over the ranks of a ``torch.distributed`` mesh.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.sharded_solve --mesh 4 \\
      --n 2327 --m 9308 --blocks 8 --rhs 32 --epochs 80 --backend gloo
  ... --model 2            # 2-D: (data, model) = (mesh, 2), TSQR setup
  ... --straggler 0.3      # stale consensus, 30% of updates dropped per epoch
  ... --compress bf16_delta
  ... --device cpu         # the card is the default

Spawns ``--mesh`` × ``--model`` ranks (``repro_torch.launch.mesh.run_ranks``);
every rank partitions the same seeded problem on the host and keeps its own
blocks on its device. Rank 0 prints a JSON record (residual, MSE, the time
of the solve on each rank, and under ``--straggler`` how many block updates
each rank dropped) and writes it with x, the history and every rank's drop
masks to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--m", type=int, default=1024)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--method", default="dapc", choices=["apc", "dapc"])
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--gamma", type=float, default=1.0)
    ap.add_argument("--eta", type=float, default=0.9)
    ap.add_argument("--rhs", type=int, default=1)
    ap.add_argument("--mesh", type=int, default=1, metavar="D",
                    help="ranks on the block axis 'data'")
    ap.add_argument("--model", type=int, default=1, metavar="MS",
                    help="ranks on the 'model' axis: > 1 runs the 2-D "
                         "solver (n must divide by MS; dapc, wide blocks)")
    ap.add_argument("--straggler", type=float, default=0.0,
                    help="probability a block's update is dropped per epoch")
    ap.add_argument("--compress", default=None, choices=["bf16_delta"])
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' must be asked for)")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="write the record, x, the history and the drop "
                         "masks to this .npz (rank 0)")
    return ap.parse_args(argv)


def rank_main(rank: int, argv) -> None:
    """One rank: build the mesh, solve, gather, and (rank 0) report."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import partition_system
    from repro_torch.core.distributed import solve_sharded, solve_sharded_2d, straggler_masks
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sparse import make_problem

    args = parse_args(argv)
    mesh = make_mesh((args.mesh, args.model), ("data", "model"),
                     device=args.device, backend=args.backend)
    prob = make_problem(n=args.n, m=args.m, seed=0, dtype=np.float32)
    if args.rhs > 1:
        xs = np.random.default_rng(1).standard_normal((args.n, args.rhs)).astype(np.float32)
        b, x_ref = prob.A @ xs, xs
    else:
        b, x_ref = prob.b, prob.x_true
    part = partition_system(prob.A, b, args.blocks, device="cpu")
    t0 = time.perf_counter()
    if args.model > 1:
        if part.mode != "wide":
            raise SystemExit(f"--model needs wide blocks; this system is {part.mode}")
        x, hist = solve_sharded_2d(
            part.blocks.transpose(1, 2), part.bvecs, mesh, gamma=args.gamma,
            eta=args.eta, num_epochs=args.epochs, x_ref=x_ref)
    else:
        x, hist = solve_sharded(
            part.blocks, part.bvecs, mesh, part.mode, method=args.method,
            gamma=args.gamma, eta=args.eta, num_epochs=args.epochs,
            straggler_prob=args.straggler, x_ref=x_ref,
            compress=args.compress)
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    seconds = time.perf_counter() - t0
    masks = None
    if args.straggler > 0:
        masks = straggler_masks(0, mesh, ("data",), args.epochs,
                                args.blocks // args.mesh, args.straggler)
    mine = {"rank": rank, "coords": list(mesh.get_coordinate()), "solve_seconds": seconds,
            "dropped": None if masks is None else int((~masks).sum()),
            "masks": None if masks is None else masks.tolist()}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    if rank != 0:
        return
    hist = {k: v.cpu().numpy() for k, v in hist.items()}
    record = {
        "method": args.method, "blocks": args.blocks, "epochs": args.epochs,
        "num_rhs": args.rhs, "mode": part.mode, "mesh": [args.mesh, args.model],
        "backend": dist.get_backend(), "device": str(x.device),
        "solve_seconds": seconds,
        "final_mse_max": float(np.max(hist["mse"][-1])),
        "final_residual_sq_max": float(np.max(hist["residual_sq"][-1])),
        "ranks": [{k: v for k, v in r.items() if k != "masks"} for r in ranks],
    }
    print(json.dumps(record, indent=1))
    if args.out:
        extra = {}
        if masks is not None:
            extra["masks"] = np.array([r["masks"] for r in ranks], bool)
        np.savez(args.out, record=json.dumps(record), x=x.cpu().numpy(), **hist, **extra)


def main(argv=None) -> None:
    from repro_torch.launch.mesh import run_ranks

    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    run_ranks(rank_main, args.mesh * args.model, args.backend, args.device, (argv,))


if __name__ == "__main__":
    main()
