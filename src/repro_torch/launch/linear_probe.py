"""DAPC fitting a linear probe on frozen transformer features: the port's
counterpart of the JAX package's ``examples/linear_probe.py``.

The probe system  H w = y  (token features x readout) is solved by the
decomposed APC solver with the implicit projector (``materialize_p=False``),
so ``--kernels`` puts the hand-written triangular solve (the warm start)
and consensus update (every epoch) on its path.

  PYTHONPATH=src python -m repro_torch.launch.linear_probe --reduce --kernels [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.linear_probe --kernels   # full width

``--reduce`` is the reference's configuration: a reduced granite-3-2b
backbone, tokens (64, 32), features (2048, 64), gated at final MSE < 1e-4
as the reference gates it. Without it, granite-3-2b at full width (40
layers, d_model 2048): tokens (64, 128), features (8192, 2048); over 8
blocks of 1024 rows the blocks are wide, and the final MSE is printed
ungated. Weights come from a ``torch.Generator`` seeded with ``--seed`` on
the device, tokens from numpy's ``default_rng(1)`` and the true readout from
``default_rng(0)``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core import solve
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import transformer

MSE_GATE = 1e-4  # the reference example's gate


def probe_config(reduce: bool):
    cfg = get_config("granite-3-2b")
    return reduced_config(cfg) if reduce else cfg


def probe_tokens(cfg, reduce: bool) -> np.ndarray:
    shape = (64, 32) if reduce else (64, 128)
    return np.random.default_rng(1).integers(0, cfg.vocab_size, shape)


def features(model, cfg, tokens: np.ndarray) -> np.ndarray:
    """Final hidden states of every token, (tokens, d_model) float32 on the host."""
    toks = torch.as_tensor(tokens, device=model.device)
    with torch.no_grad():
        hidden, _, _ = transformer.forward_hidden(model, toks, cfg)
    return hidden.reshape(-1, cfg.d_model).float().cpu().numpy()


def fit(feats: np.ndarray, w_true: np.ndarray, kernels: bool, device):
    """The probe's least-squares solve, configured as the reference's."""
    y = feats @ w_true
    return solve(feats, y, method="dapc", num_blocks=8, num_epochs=150,
                 gamma=1.0, eta=0.9, x_ref=w_true, materialize_p=False,
                 use_kernels=kernels, device=device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduce", action="store_true",
                    help="the reference's reduced backbone (gated at MSE < 1e-4)")
    ap.add_argument("--kernels", action="store_true",
                    help="the hand-written CUDA trisolve and consensus update")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def run(argv=None) -> dict:
    """Builds the backbone, extracts features and fits the probe; returns
    the record and the arrays (``feats``, ``w_true``, ``result``)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = probe_config(args.reduce)
    model = transformer.init_params(cfg, torch.Generator(device=device).manual_seed(args.seed))
    tokens = probe_tokens(cfg, args.reduce)
    synchronize(device)
    t0 = time.perf_counter()
    feats = features(model, cfg, tokens)
    feature_seconds = time.perf_counter() - t0
    del model
    w_true = np.random.default_rng(0).standard_normal(cfg.d_model).astype(np.float32)
    res = fit(feats, w_true, args.kernels, device)
    record = {
        "arch": cfg.name, "reduced": args.reduce, "device": str(device),
        "kernels": args.kernels, "tokens": list(tokens.shape), "features": list(feats.shape),
        "mode": res.mode, "feature_seconds": feature_seconds,
        "solve_seconds": res.wall_seconds, "final_mse": float(res.final_mse),
    }
    return {"record": record, "feats": feats, "w_true": w_true, "result": res}


def main(argv=None) -> dict:
    out = run(argv)
    record = out["record"]
    print(json.dumps(record))
    print(f"probe fit: mode={record['mode']} final MSE to true readout "
          f"{record['final_mse']:.3e}")
    if record["reduced"]:
        if not record["final_mse"] < MSE_GATE:
            raise SystemExit(f"probe fit: final MSE {record['final_mse']:.3e} "
                             f"not below {MSE_GATE:g}")
        print("recovered readout OK")
    return out


if __name__ == "__main__":
    main()
