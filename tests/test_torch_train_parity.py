"""The training path's pieces against the JAX package on the CPU, inputs made
by numpy from a seed:

- flash attention's ``autograd.Function`` against ``jax.vjp`` of the
  reference's ``_chunked_attention`` (causal and not, cq == ck with its
  diagonal skip and cq ≠ ck, sequences over the chunk): output and dq, dk,
  dv within 1e-5·max;
- ``chunked_softmax_xent`` against ``jax.vjp`` of the reference's (padded
  vocab, with and without a mask): the loss within 1e-6 relative, dhidden
  and dembed within 1e-5·max; and against a full-logits ``F.cross_entropy``;
- a 5-step ``train`` fed the reference's weights and batches: losses equal
  to 1e-4 in f32 compute, 1e-3 in bf16 (measured 2.5e-4); and at
  granite-3-2b's vocabulary with chunked attention and cross-entropy;
- the √d embedding scale in bf16 equal bit for bit to the reference's;
- ``params_to_reference(params_from_reference(tree))`` equal to ``tree``
  bit for bit for all ten reduced archs;
- a serving model's forward builds no autograd graph.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jget
from repro.configs import reduced_config as jreduce
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import layers as jl
from repro.models import losses as jlosses
from repro.models import transformer as jt
from repro.training import data as jdata
from repro.training import train_loop as jtl
from repro.training.optimizer import OptConfig as JOptConfig

from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, losses, transformer
from repro_torch.models.convert import (
    load_reference,
    params_from_reference,
    params_to_reference,
)
from repro_torch.training import train_loop
from repro_torch.training.checkpoint import flatten
from repro_torch.training.optimizer import OptConfig

from test_torch_models import close, t

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small ops: one intra-op thread keeps them fast when parallel
    test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


MODULE_RTOL = 1e-5


# -- flash attention's backward ----------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,cq,ck", [
    (20, 20, 8, 8),  # cq == ck: the causal diagonal skip, a padded last chunk
    (20, 20, 8, 4),  # cq != ck
    (13, 21, 4, 8),  # sq != sk
])
def test_flash_backward_matches_reference_vjp(causal, sq, sk, cq, ck):
    rng = np.random.default_rng(0)
    b, h, hkv, d = 2, 4, 2, 16
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    dout = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    want, vjp = jax.vjp(lambda q, k, v: jl._chunked_attention(q, k, v, causal, cq, ck),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(dout))
    tq, tk, tv = (t(x).requires_grad_(True) for x in (q, k, v))
    out = layers.attention(tq, tk, tv, causal=causal, chunk_q=cq, chunk_kv=ck)
    out.backward(t(dout))
    close(out.detach(), want, MODULE_RTOL)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want_grads):
        close(got, ref, MODULE_RTOL)


# -- the chunked cross-entropy -----------------------------------------------


def xent_inputs(masked, seed=0):
    rng = np.random.default_rng(seed)
    b, s, d, vocab, vpad = 2, 13, 16, 50, 64
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    embed = (0.5 * rng.standard_normal((vpad, d))).astype(np.float32)
    targets = rng.integers(0, vocab, (b, s))
    mask = (rng.random((b, s)) < 0.7).astype(np.float32) if masked else None
    return hidden, embed, targets, mask, vocab


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_xent_matches_reference_vjp(masked):
    hidden, embed, targets, mask, vocab = xent_inputs(masked)
    chunk = 4  # 13 positions: three full chunks and a padded one
    jmask = None if mask is None else jnp.asarray(mask)
    want, vjp = jax.vjp(
        lambda h, e: jlosses.chunked_softmax_xent(h, e, jnp.asarray(targets), vocab, chunk, jmask),
        jnp.asarray(hidden), jnp.asarray(embed))
    want_dh, want_de = vjp(jnp.float32(1.0))
    th, te = t(hidden).requires_grad_(True), t(embed).requires_grad_(True)
    got = losses.chunked_softmax_xent(th, te, t(targets), vocab, chunk,
                                      None if mask is None else t(mask))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    close(th.grad, want_dh, MODULE_RTOL)
    close(te.grad, want_de, MODULE_RTOL)


def test_chunked_xent_matches_full_logits_cross_entropy():
    hidden, embed, targets, mask, vocab = xent_inputs(True, seed=1)
    th, te = t(hidden).requires_grad_(True), t(embed).requires_grad_(True)
    got = losses.chunked_softmax_xent(th, te, t(targets), vocab, 4, t(mask))
    got.backward()
    h2, e2 = t(hidden).requires_grad_(True), t(embed).requires_grad_(True)
    logits = (h2 @ e2.T).masked_fill(torch.arange(embed.shape[0]) >= vocab, -1e30)
    nll = F.cross_entropy(logits.reshape(-1, embed.shape[0]), t(targets).reshape(-1),
                          reduction="none")
    want = (nll * t(mask).reshape(-1)).sum() / t(mask).sum()
    want.backward()
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    close(th.grad, h2.grad, MODULE_RTOL)
    close(te.grad, e2.grad, MODULE_RTOL)


# -- a short trajectory -------------------------------------------------------

TINY = dict(name="tiny", family="dense", num_layers=2, d_model=32, num_heads=2,
            num_kv_heads=2, d_ff=64, vocab_size=64, attn_chunk_q=0, xent_chunk=16,
            remat="none")


def reference_batches(monkeypatch, dcfg):
    """Make the port's train loop draw the reference's batches."""

    def make_batch(_, step, device=None):
        return {k: torch.as_tensor(np.array(v)).long()
                for k, v in jdata.make_batch(dcfg, step).items()}

    monkeypatch.setattr(train_loop.data_lib, "make_batch", make_batch)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 1e-3)])
def test_train_trajectory_matches_reference(monkeypatch, dtype, atol):
    """Five steps of the reference's test config (AdamW with warm-up) from
    the reference's weights on the reference's batches. In bf16 compute
    (the config's default) the two roundings part by 2.5e-4 at step 5."""
    jcfg, cfg = JModelConfig(**TINY, dtype=dtype), ModelConfig(**TINY, dtype=dtype)
    dcfg = jdata.DataConfig(64, 16, 8, seed=0, repeat_prob=0.75)
    opt = dict(learning_rate=1e-2, warmup_steps=2, total_steps=5)
    _, want = jtl.train(jcfg, jtl.TrainConfig(opt=JOptConfig(**opt), num_steps=5, log_every=1),
                        dcfg)
    tcfg = train_loop.TrainConfig(opt=OptConfig(**opt), num_steps=5, log_every=1)
    state = train_loop.init_state(cfg, torch.Generator().manual_seed(0), tcfg)
    init = jtl.init_state(jcfg, jax.random.PRNGKey(0), jtl.TrainConfig())
    load_reference(state["params"], jax.tree.map(np.asarray, init["params"]))
    reference_batches(monkeypatch, dcfg)
    _, got = train_loop.train(cfg, tcfg, None, state=state)
    assert [h["step"] for h in got] == [h["step"] for h in want] == [1, 2, 3, 4, 5]
    np.testing.assert_allclose([h["loss"] for h in got], [h["loss"] for h in want], rtol=0,
                               atol=atol)


def test_wide_train_trajectory_matches_reference(monkeypatch):
    """granite-3-2b's vocabulary and head width at d_model 256, 4 layers,
    S 512: the chunked flash attention (chunks of 128), the chunked
    cross-entropy, block remat and bf16 compute inside the train step, five
    steps at the learning rate of ``chip_smoke.py``'s full-width run.
    Losses and gradient norms within 1e-3 (about 1e-4 apart over 10 steps)."""
    over = dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=2, d_ff=1024,
                attn_chunk_q=128, attn_chunk_kv=128, xent_chunk=128)
    jcfg = dataclasses.replace(jget("granite-3-2b"), **over)
    cfg = dataclasses.replace(get_config("granite-3-2b"), **over)
    dcfg = jdata.DataConfig(jcfg.vocab_size, 512, 2, seed=0, repeat_prob=0.75)
    opt = dict(learning_rate=3e-4, warmup_steps=5, total_steps=5)
    _, want = jtl.train(jcfg, jtl.TrainConfig(opt=JOptConfig(**opt), num_steps=5, log_every=1),
                        dcfg)
    tcfg = train_loop.TrainConfig(opt=OptConfig(**opt), num_steps=5, log_every=1)
    state = train_loop.init_state(cfg, torch.Generator().manual_seed(0), tcfg)
    init = jtl.init_state(jcfg, jax.random.PRNGKey(0), jtl.TrainConfig())
    load_reference(state["params"], jax.tree.map(np.asarray, init["params"]))
    reference_batches(monkeypatch, dcfg)
    _, got = train_loop.train(cfg, tcfg, None, state=state)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in got], [h[key] for h in want], rtol=0,
                                   atol=1e-3)


# -- the embedding scale, the converter, serving without a graph --------------


def test_bf16_embedding_scale_equals_reference_bits():
    """√2048 rounds to 45.25 in bf16 before it scales the rows, as the
    reference's ``jnp.asarray(√d, x.dtype)`` does."""
    rng = np.random.default_rng(0)
    d = 2048
    table = (0.02 * rng.standard_normal((64, d))).astype(np.float32)
    toks = rng.integers(0, 64, (2, 9))
    jcfg = dataclasses.replace(jget("granite-3-2b"), vocab_size=64)
    cfg = dataclasses.replace(get_config("granite-3-2b"), vocab_size=64)
    want = jt._embed({"embed": jnp.asarray(table).astype(jnp.bfloat16)}, jnp.asarray(toks), jcfg)
    got = transformer._embed(SimpleNamespace(embed=t(table)), t(toks), cfg, cast=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    # f32 rows: √d in f32, as before
    want32 = jt._embed({"embed": jnp.asarray(table)}, jnp.asarray(toks), jcfg)
    np.testing.assert_array_equal(transformer._embed(SimpleNamespace(embed=t(table)), t(toks),
                                                     cfg).numpy(),
                                  np.asarray(want32))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_reference_inverts_params_from_reference(arch):
    jcfg = jreduce(jget(arch))
    tree = jax.tree.map(np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(0)))
    back = params_to_reference(params_from_reference(reduced_config(get_config(arch)), tree,
                                                     device="cpu"))
    want, got = flatten(tree), flatten(back)
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype and got[path].shape == leaf.shape, path
        np.testing.assert_array_equal(got[path], leaf, err_msg=path)


def test_serving_forward_builds_no_graph():
    """Serving models keep ``requires_grad=False``: the forward without
    ``no_grad`` records nothing, and prefill/decode run under ``no_grad``."""
    cfg = reduced_config(get_config("granite-3-2b"))
    model = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in model.parameters())
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    hidden, _, _ = transformer.forward_hidden(model, toks, cfg)
    assert hidden.grad_fn is None and not hidden.requires_grad
    trainable = transformer.init_params(cfg, torch.Generator().manual_seed(0)).requires_grad_(True)
    logits, cache = transformer.prefill(trainable, toks, cfg, 12)
    assert logits.grad_fn is None
    assert all(v.grad_fn is None for slot in cache["main"].values() for v in slot.values())
    assert transformer.forward_hidden(trainable, toks, cfg)[0].grad_fn is not None
