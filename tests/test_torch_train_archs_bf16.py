"""The training loss of all ten reduced archs in bf16 compute against the
JAX package on the CPU (tolerances and measurements in
``test_torch_train_archs.py``), and a check that tells bf16 compute from
f32: the loss and gradient tolerances alone cannot (the reference's own
bf16 gradient lies as close to its f32 one as to the port's)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.models import transformer

from test_torch_train_archs import batch_arrays, check_loss_and_grads, one_torch_thread  # noqa: F401


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch, "bfloat16")


def compute_dtypes(cfg):
    """One ``loss_fn`` with its backward from the port's own draws: the
    dtypes its blocks computed with (``record_compute_dtypes``) and the
    number of matrices its blocks hold, one count per block call."""
    model = transformer.init_params(cfg, torch.Generator().manual_seed(0)).requires_grad_(True)
    units = list(model.layers) + (list(model.encoder.blocks) if cfg.is_encdec else [])
    matrices = sum(p.ndim >= 2 for block in units for p in block.parameters())
    batch = {k: torch.as_tensor(v) for k, v in batch_arrays(cfg).items()}
    with transformer.record_compute_dtypes(model) as seen:
        loss, _ = transformer.loss_fn(model, batch, cfg)
        loss.backward()
    assert np.isfinite(float(loss.detach()))
    return seen, matrices


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_compute_reaches_every_block_and_its_recompute(arch):
    """Under the arch's own ``dtype="bfloat16"`` every matrix of every block
    call is a bf16 copy, in the forward and again in the checkpoint's
    recompute (twice the calls of ``remat="none"``). The f32 control, the
    same model at ``dtype="float32"``, computes on the f32 masters and so
    fails that check."""
    base = reduced_config(get_config(arch))
    assert base.dtype == "bfloat16" and base.remat == "block"
    seen, matrices = compute_dtypes(base)
    assert matrices > 0
    assert seen == {torch.bfloat16: 2 * matrices}, seen
    once, _ = compute_dtypes(dataclasses.replace(base, remat="none"))
    assert once == {torch.bfloat16: matrices}, once
    control, _ = compute_dtypes(dataclasses.replace(base, dtype="float32"))
    assert control == {torch.float32: 2 * matrices}, control
    assert control != seen
