"""Choose a configuration's stated accuracy T with the plain reference.

    python3 perfbench/tools/pick_tol.py perfbench/configs/dapc-s5-18252x4563.json \
        [--seed 0] [--k 32] [--cap 300] [--device cuda]

Solves a k-column batch of the configuration's system (seed 0 unless told)
with the float64 reference for ``cap`` epochs and prints, for every power of
ten, the epochs at which the columns reach ‖A x̄ − b‖ ≤ T (the program's
freeze rule), then the powers of ten at which every column freezes between
epoch 60 and epoch 200 of the cap, as one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    import numpy as np

    from perfbench.harness import problem
    from perfbench.reference import dapc

    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--cap", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    config = json.loads(Path(args.config).read_text())
    system = problem.make_system(config["problem"], args.seed, args.device)
    B = system.rhs(args.k, purpose=0)
    A = system.host()
    del system
    ref = dapc.build(A, config, "float64", args.device)
    hist, _ = ref.run(B, args.cap)
    hist = hist.cpu().numpy()
    bnorm = np.linalg.norm(B.cpu().numpy().astype(np.float64), axis=0)
    rows = {}
    for e in range(-4, 7):
        T = 10.0 ** e
        it = dapc.iterations_to_tol(hist, T)
        rows[f"1e{e}"] = [int(it.min()), int(it.max())]
        print(f"T=1e{e}: epochs to freeze min {it.min()} max {it.max()}")
    fits = [t for t, (lo, hi) in rows.items() if lo >= 60 and hi <= 200]
    print(json.dumps({
        "config": args.config, "seed": args.seed, "k": args.k, "cap": args.cap,
        "residual_norm": {e: [float(np.sqrt(hist[e]).min()), float(np.sqrt(hist[e]).max())]
                          for e in (0, 60, 80, 200, args.cap)},
        "b_norm": [float(bnorm.min()), float(bnorm.max())],
        "epochs_to_tol": rows, "fits_60_200": fits,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
