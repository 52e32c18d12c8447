"""Quickstart on the PyTorch port: solve a sparse overdetermined system with
decomposed APC (the counterpart of ``examples/quickstart.py``).

Runs on the card unless ``--device cpu`` is given; ``--kernels`` puts the
hand-written triangular solve and consensus update on the path (on the CPU
their plain versions).

    PYTHONPATH=src python examples/quickstart_torch.py [--kernels] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import solve
from repro_torch.device import resolve_device
from repro_torch.sparse import make_problem

ERR_GATE = 1e-3  # the reference's max |x̂ - x| gate


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--kernels", action="store_true",
                    help="prepare with use_kernels=True (the hand-written kernels)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' must be asked for)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # synthetic Schenk_IBMNA-like system (paper §4): square sparse core,
    # augmented to 4× overdetermined with consistent linear combinations (eq. 8)
    prob = make_problem(n=512, m=2048, sparsity=0.9985, seed=0, dtype=np.float32)
    system = f"system: A {prob.A.shape}, sparsity(core) {prob.coo.sparsity:.2f}%"
    print(system)

    # the paper's method: QR decomposition + back-substitution, no inversions
    res = solve(
        prob.A, prob.b,
        method="dapc",          # "apc" = classical baseline, "dgd" = gradient
        num_blocks=8,           # J workers (wide regime: m/J < n)
        num_epochs=100,         # T consensus epochs (paper eqs. 6-7)
        gamma=1.0, eta=0.9,     # paper's hyperparameters
        x_ref=prob.x_true,      # for MSE reporting only
        materialize_p=False,    # beyond-paper: implicit projector
        use_kernels=args.kernels,
        device=device,
    )
    print(f"mode={res.mode} wall={res.wall_seconds:.2f}s")
    initial = float(res.history["initial"]["mse"])
    print(f"initial MSE {initial:.3e} -> final MSE {res.final_mse:.3e}")
    err = float(np.abs(res.x - prob.x_true).max())
    print(f"max |x̂ - x| = {err:.2e}")
    if not err < ERR_GATE:
        raise SystemExit(f"max |x̂ - x| = {err:.2e} is not below {ERR_GATE:g}")
    print("OK")
    return {"system": system, "mode": res.mode, "wall_seconds": res.wall_seconds,
            "initial_mse": initial, "final_mse": float(res.final_mse), "max_err": err,
            "x": res.x}


if __name__ == "__main__":
    main()
