"""End-to-end LM training example on the PyTorch port (the
counterpart of ``examples/train_lm.py``).

Default builds a ~100M-parameter granite-style model; --small selects a
~10M config. The code path (config -> state -> train step ->
checkpoint/restart) is the same at every scale. With --ckpt-dir, a rerun
resumes from the latest complete checkpoint there.

Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/train_lm_torch.py [--small --steps 150] [--device cpu]
"""
import argparse

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training import data as data_lib
from repro_torch.training import train_loop
from repro_torch.training.optimizer import OptConfig

DROP_GATE = 0.1  # the reference's gate on the loss drop over the run


def lm_config(small: bool) -> ModelConfig:
    if small:  # ~10M params
        return ModelConfig(
            name="lm-10m", family="dense", num_layers=4, d_model=256,
            num_heads=4, num_kv_heads=2, d_ff=1024, vocab_size=4096,
            attn_chunk_q=0, xent_chunk=128, remat="none",
        )
    return ModelConfig(  # ~100M params
        name="lm-100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=4, d_ff=3072, vocab_size=32000,
        attn_chunk_q=0, xent_chunk=256,
    )


def run(argv=None) -> dict:
    """The run and its printed lines, without the gate: the model's name
    and parameter count, the step it resumed from, the logged history and
    the loss drop (absent when a rerun found every step done)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' must be asked for)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = lm_config(args.small)
    print(f"model: {cfg.name} ({cfg.param_count()/1e6:.1f}M params)")
    tcfg = train_loop.TrainConfig(
        opt=OptConfig(learning_rate=3e-3, warmup_steps=args.steps // 10,
                      total_steps=args.steps),
        num_steps=args.steps,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=max(args.steps // 3, 20),
        log_every=max(args.steps // 15, 5),
    )
    dcfg = data_lib.DataConfig(cfg.vocab_size, args.seq, args.batch,
                               seed=0, repeat_prob=0.75)
    # the step train() resumes from: its latest complete checkpoint
    start = (ckpt_lib.latest_step(args.ckpt_dir) if args.ckpt_dir else None) or 0
    _, hist = train_loop.train(cfg, tcfg, dcfg, device=device)
    for h in hist:
        print(h)
    out = {"name": cfg.name, "params": cfg.param_count(), "resumed_from": start,
           "history": hist}
    if not hist:  # the reference indexes hist[0] here and raises IndexError
        print(f"resumed from step {start}: all {args.steps} steps done, nothing to train")
        return out
    drop = hist[0]["loss"] - hist[-1]["loss"]
    print(f"loss drop over run: {drop:.3f} (must be > 0)")
    return {**out, "drop": drop}


def main(argv=None) -> dict:
    """``run`` held at the reference's gate: the loss drops by more than
    0.1 over a run that trained."""
    out = run(argv)
    if "drop" in out and not out["drop"] > DROP_GATE:
        raise SystemExit(f"loss drop {out['drop']:.3f} is not above {DROP_GATE:g}")
    return out


if __name__ == "__main__":
    main()
