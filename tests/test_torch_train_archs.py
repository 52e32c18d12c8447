"""The training loss of all ten reduced archs against the JAX package on the
CPU: ``loss_fn``'s value and every gradient leaf (carried back to the
reference's stacked layout by ``params_to_reference``) against
``jax.value_and_grad`` of the reference's ``loss_fn``, from the reference's
weights (``params_from_reference``) on one batch made by numpy from a seed.

Tolerances:

- f32 compute: the loss and the MoE load-balance loss within 1e-5
  relative, each gradient leaf within
  1e-4·max|that leaf| (measured: 1.0e-7 and 6.4e-6, zamba2-7b's ``a_log``).
- bf16 compute (``cast_for_compute``): the loss within 5e-4 relative
  (measured 1.03e-4, zamba2-7b), the MoE load-balance loss within 5e-3
  (measured 1.7e-3, deepseek-v2-236b: its router logits are bf16, routing
  equal) and every gradient leaf within 5e-2·max|g|
  over the arch's whole gradient (measured 2.67e-2, xlstm-1.3b). Each
  package's bf16 gradient is as far from the reference's f32 gradient as
  the two are from each other (xlstm-1.3b: 2.45e-2 for the reference's own).
  Per leaf the two bf16 roundings differ more on small leaves: the
  reference's bf16 ``moe/w_out`` of deepseek-v2-236b lies 0.515·max of that
  leaf from its own f32 gradient, the port's 0.0117.

The bf16 cases are in ``test_torch_train_archs_bf16.py``. Plus the
reference's own smoke test of one train step
(``tests/test_arch_smoke.py::test_smoke_train_step``) on the port's own
draws: a finite loss above 0.5, finite gradients, some nonzero.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced_config as jreduce
from repro.models import transformer as jt

from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_reference, params_to_reference
from repro_torch.training.checkpoint import flatten

from test_torch_families import moved

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small ops: one intra-op thread keeps them fast when parallel
    test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


LOSS_RTOL = {"float32": 1e-5, "bfloat16": 5e-4}
AUX_RTOL = {"float32": 1e-5, "bfloat16": 5e-3}  # the MoE load-balance loss
GRAD_RTOL = {"float32": 1e-4, "bfloat16": 5e-2}


def batch_arrays(cfg, b=2, s=16, seed=1):
    """The reference test's ``_batch`` shapes, drawn by numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.vision_seq:
        batch["patches"] = 0.1 * rng.standard_normal((b, cfg.vision_seq, cfg.d_model))
    if cfg.is_encdec:
        batch["enc_frames"] = 0.1 * rng.standard_normal((b, cfg.encoder_seq, cfg.d_model))
    return {k: v if k in ("tokens", "targets") else v.astype(np.float32)
            for k, v in batch.items()}


def port_loss_and_grads(model, batch, cfg):
    """(loss, metrics, gradient tree in the reference's layout)."""
    loss, metrics = transformer.loss_fn(model, {k: torch.as_tensor(v) for k, v in batch.items()},
                                        cfg)
    loss.backward()
    grads = params_to_reference(model, {n: p.grad for n, p in model.named_parameters()})
    return float(loss), metrics, flatten(grads)


def check_loss_and_grads(arch, dtype):
    """The port's loss and gradient against the reference's, at ``dtype``'s
    tolerances."""
    jcfg = dataclasses.replace(jreduce(jget(arch)), dtype=dtype)
    tcfg = dataclasses.replace(reduced_config(get_config(arch)), dtype=dtype)
    params = moved(jax.tree.map(np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(0))))
    batch = batch_arrays(jcfg)
    (want, want_m), jg = jax.value_and_grad(
        lambda p: jt.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg),
        has_aux=True)(jax.tree.map(jnp.asarray, params))
    model = params_from_reference(tcfg, params, device="cpu").requires_grad_(True)
    got, got_m, grads = port_loss_and_grads(model, batch, tcfg)
    assert got == pytest.approx(float(want), rel=LOSS_RTOL[dtype])
    assert float(got_m["aux_loss"]) == pytest.approx(float(want_m["aux_loss"]), rel=AUX_RTOL[dtype],
                                                     abs=1e-7)
    want_g = flatten(jax.tree.map(np.asarray, jg))
    assert set(grads) == set(want_g)
    gmax = max(float(np.abs(g).max()) for g in want_g.values())
    for path, want_leaf in want_g.items():
        got_leaf = np.asarray(grads[path], np.float64)
        want_leaf = np.asarray(want_leaf, np.float64)
        assert got_leaf.shape == want_leaf.shape, path
        scale = float(np.abs(want_leaf).max()) if dtype == "float32" else gmax
        err = float(np.abs(got_leaf - want_leaf).max())
        assert err <= GRAD_RTOL[dtype] * scale, (path, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch, "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_step(arch):
    """One loss+grad step on the reduced config from the port's own draws:
    finite loss above 0.5, finite gradients, some nonzero."""
    cfg = reduced_config(get_config(arch))
    cfg.validate()
    model = transformer.init_params(cfg, torch.Generator().manual_seed(0)).requires_grad_(True)
    batch = {k: torch.as_tensor(v) for k, v in batch_arrays(cfg).items()}
    loss, _ = transformer.loss_fn(model, batch, cfg)
    loss.backward()
    assert np.isfinite(float(loss)), f"{arch} loss not finite"
    assert float(loss) > 0.5  # random-init LM must not be degenerate
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert all(bool(torch.isfinite(g).all()) for g in grads), arch
    assert any(float(g.abs().max()) > 0 for g in grads), arch
