"""Batched serving command line: init a model from a seed and serve a batch of
prompts by greedy decoding (``serving.decode.generate``: one parallel
prefill, then one-token serve steps against the KV cache).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b --reduce \
      --batch 4 --prompt-len 8 --max-new 16 [--device cpu] [--seed 0]

Weights are random, drawn from a ``torch.Generator`` seeded with ``--seed``
on the serving device; prompts from one seeded with ``--seed + 1`` on the
host, so every device serves the same prompts. The modality stubs are
0.1·N(0, 1) on the serving device, as the reference draws them with PRNG
keys 2 and 3: image patch embeddings (``vision_seq`` × d_model, vision
archs) from a generator seeded 2, encoder frames (``encoder_seq`` ×
d_model, encoder–decoder archs) from one seeded 3. Prints the reference's
two lines (shape, seconds, tokens/s; the first sequence). On the card the
clock stops after a synchronize.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import transformer
from repro_torch.serving.decode import generate


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def stubs(cfg, batch, device):
    """The modality frontends' stand-ins ``generate`` takes as ``aux``, or
    None for a text-only arch: 0.1·N(0, 1) patches (batch, vision_seq,
    d_model) from a generator seeded 2 and encoder frames (batch,
    encoder_seq, d_model) from one seeded 3, on ``device``."""
    def draw(seq, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        return 0.1 * torch.randn((batch, seq, cfg.d_model), generator=gen, device=device)

    aux = {}
    if cfg.vision_seq:
        aux["patches"] = draw(cfg.vision_seq, 2)
    if cfg.is_encdec:
        aux["enc_frames"] = draw(cfg.encoder_seq, 3)
    return aux or None


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced_config(cfg)
    params = transformer.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed))
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        generator=torch.Generator().manual_seed(args.seed + 1),
    ).to(device)
    aux = stubs(cfg, args.batch, device)
    synchronize(device)
    t0 = time.perf_counter()
    out = generate(params, cfg, prompts, max_new=args.max_new, aux=aux)
    synchronize(device)
    dt = time.perf_counter() - t0
    toks = args.batch * args.max_new
    print(f"arch={cfg.name} generated {tuple(out.shape)} in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s incl. prompt)")
    print("sample:", out[0].tolist())
    return out


if __name__ == "__main__":
    main()
