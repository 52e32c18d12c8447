"""End-to-end training entry point, ported from the JAX package's
``repro.launch.train``: config → state → step → checkpoint/restart loop,
on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b --reduce \\
      --steps 40 [--device cpu] [--ckpt-dir DIR] [--fail-at 20] [--compress-grads]

Prints the reference's lines: the config, one JSON record per logged step
and the final loss. ``--layers`` is parsed and ignored, as the reference
does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.training import data as data_lib
from repro_torch.training import train_loop
from repro_torch.training.optimizer import OptConfig


def opt_config(steps: int, lr: float) -> OptConfig:
    """The optimizer of a run of ``steps`` steps at peak ``lr``: warmup over
    a twentieth of the run (at least 5 steps), then the cosine decay."""
    return OptConfig(learning_rate=lr, warmup_steps=max(steps // 20, 5), total_steps=steps)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduce", action="store_true",
                    help="shrink to CPU-runnable scale (same structure)")
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="simulate a node failure at this step (then rerun)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced_config(cfg)
    overrides = {}
    if args.d_model:
        overrides["d_model"] = args.d_model
    if args.vocab:
        overrides["vocab_size"] = args.vocab
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cfg.validate()

    devices = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"layers={cfg.num_layers} devices={devices}")
    tcfg = train_loop.TrainConfig(
        opt=opt_config(args.steps, args.lr),
        num_steps=args.steps,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=max(args.steps // 4, 10),
        log_every=max(args.steps // 20, 5),
        compress_grads=args.compress_grads,
    )
    dcfg = data_lib.DataConfig(cfg.vocab_size, args.seq, args.batch, seed=0,
                               repeat_prob=0.75)
    _, history = train_loop.train(cfg, tcfg, dcfg, fail_at_step=args.fail_at, device=device)
    for h in history:
        print(json.dumps(h))
    print(f"final loss: {history[-1]['loss']:.4f}")
    return history


if __name__ == "__main__":
    main()
