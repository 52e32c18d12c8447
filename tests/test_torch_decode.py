"""KV-cache decode, greedy generation, the serving command line and the
linear probe: the port against the JAX package on the CPU, and the
reference's own decode properties held within the port."""
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solve as ref_solve
from repro.models import transformer as jt
from repro.serving import decode as jdecode

from repro_torch.launch import linear_probe, serve
from repro_torch.models import transformer
from repro_torch.serving import decode

from test_torch_models import DENSE_ARCHS, close, pair, t, tokens


def _decode_all(step, caches, toks):
    outs = []
    for i in range(toks.shape[1]):
        logits, caches = step(caches, toks[:, i : i + 1], i)
        outs.append(np.asarray(logits)[:, 0])
    return np.stack(outs, 1)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_decode_matches_reference(arch):
    """Token-by-token decode from an empty bf16 cache, both packages, at the
    reference's 5e-3·scale."""
    jcfg, params, tcfg, model = pair(arch)
    toks = tokens(tcfg, (2, 8))
    want = _decode_all(
        lambda c, tk, i: jt.decode_step(params, c, jnp.asarray(tk), jnp.int32(i), jcfg),
        jt.init_cache(jcfg, 2, 8), toks)
    got = _decode_all(
        lambda c, tk, i: transformer.decode_step(model, c, t(tk), i, tcfg),
        transformer.init_cache(tcfg, 2, 8, device="cpu"), toks)
    v = tcfg.vocab_size
    scale = float(np.abs(want[..., :v]).max())
    np.testing.assert_allclose(got[..., :v], want[..., :v], rtol=0, atol=5e-3 * scale)


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma-7b"])
def test_decode_matches_teacher_forcing(arch):
    """Within the port: decode reproduces the train-mode forward (the
    reference's property test)."""
    _, _, tcfg, model = pair(arch)
    toks = t(tokens(tcfg, (2, 8)))
    hid, _, _ = transformer.forward_hidden(model, toks, tcfg)
    full = transformer.logits_from_hidden(model, hid, tcfg).numpy()
    dec = _decode_all(lambda c, tk, i: transformer.decode_step(model, c, tk, i, tcfg),
                      transformer.init_cache(tcfg, 2, 8, device="cpu"), toks)
    v = tcfg.vocab_size
    scale = float(np.abs(full[..., :v]).max()) + 1e-6
    np.testing.assert_allclose(dec[..., :v], full[..., :v], rtol=0, atol=5e-3 * scale)


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen1.5-32b"])
def test_prefill_continuation_matches_decode(arch):
    """Continuing from a prefilled cache equals pure token-by-token decode."""
    _, _, tcfg, model = pair(arch)
    s, p = 12, 8
    toks = t(tokens(tcfg, (2, s)))
    _, cache = transformer.prefill(model, toks[:, :p], tcfg, s)
    a = _decode_all(lambda c, tk, i: transformer.decode_step(model, c, tk, i + p, tcfg),
                    cache, toks[:, p:])
    b = _decode_all(lambda c, tk, i: transformer.decode_step(model, c, tk, i, tcfg),
                    transformer.init_cache(tcfg, 2, s, device="cpu"), toks)[:, p:]
    v = tcfg.vocab_size
    scale = float(np.abs(b[..., :v]).max()) + 1e-9
    np.testing.assert_allclose(a[..., :v], b[..., :v], rtol=0, atol=2e-2 * scale)


def test_fp8_cache_decode_close():
    """An fp8 KV cache (half the bytes) stays close to bf16 decode logits."""
    _, _, tcfg, model = pair("granite-3-2b", 1)
    cfg8 = dataclasses.replace(tcfg, cache_dtype="float8_e4m3fn")
    toks = t(tokens(tcfg, (2, 8)))
    outs = {}
    for name, c in (("bf16", tcfg), ("fp8", cfg8)):
        cache = transformer.init_cache(c, 2, 8, device="cpu")
        assert cache["main"]["cache0"]["k"].dtype == getattr(torch, c.cache_dtype)
        outs[name] = _decode_all(
            lambda cc, tk, i, c=c: transformer.decode_step(model, cc, tk, i, c), cache, toks
        )[:, -1, : tcfg.vocab_size]
    scale = np.abs(outs["bf16"]).max()
    np.testing.assert_allclose(outs["fp8"], outs["bf16"], rtol=0, atol=0.12 * scale)


def test_generate_with_and_without_prefill_agree():
    _, _, tcfg, model = pair("granite-3-2b", 1)
    prompts = t(tokens(tcfg, (2, 6), seed=5))
    out_pf = decode.generate(model, tcfg, prompts, max_new=5, use_prefill=True)
    out_td = decode.generate(model, tcfg, prompts, max_new=5, use_prefill=False)
    assert out_pf.shape == (2, 5)
    torch.testing.assert_close(out_pf, out_td, rtol=0, atol=0)


def test_greedy_tokens_match_reference():
    """The port's greedy tokens equal the reference's at every step whose
    top-2 logit margin (on the reference's own trajectory) exceeds the decode
    tolerance, up to the first step where it does not."""
    jcfg, params, tcfg, model = pair("granite-3-2b")
    prompts = tokens(tcfg, (3, 6), seed=7)
    max_new = 8
    want = np.asarray(jdecode.generate(params, jcfg, jnp.asarray(prompts), max_new=max_new))
    got = decode.generate(model, tcfg, t(prompts), max_new=max_new).numpy()
    # the reference's logits along its own tokens: prefill, then decode steps
    seq = np.concatenate([prompts, want], axis=1)
    plen = prompts.shape[1]
    logits, cache = jt.prefill(params, jnp.asarray(prompts), jcfg, plen + max_new)
    steps = [np.asarray(logits)[:, -1]]
    for i in range(plen, plen + max_new - 1):
        lg, cache = jt.decode_step(params, cache, jnp.asarray(seq[:, i : i + 1]),
                                   jnp.int32(i), jcfg)
        steps.append(np.asarray(lg)[:, 0])
    ref_logits = np.stack(steps, 1)[..., : tcfg.vocab_size]  # (B, max_new, V)
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    tol = 5e-3 * float(np.abs(ref_logits).max())
    for b in range(prompts.shape[0]):
        decided = np.cumprod(margin[b] > tol).astype(bool)
        assert decided[0]
        np.testing.assert_array_equal(got[b][decided], want[b][decided])


def test_serve_step_is_built_once_per_config():
    _, _, tcfg, model = pair("granite-3-2b", 1)
    assert decode.prepared_serve_step(tcfg) is decode.prepared_serve_step(tcfg)
    cache = transformer.init_cache(tcfg, 2, 4, device="cpu")
    nxt, cache2 = decode.make_serve_step(tcfg)(model, cache, t(tokens(tcfg, (2, 1))), 0)
    assert nxt.shape == (2, 1) and cache2 is cache
    assert int(nxt.max()) < tcfg.vocab_size
    assert cache["main"]["cache0"]["k"][:, :, 0].any()  # written in place


def test_launch_serve_prints_the_reference_lines(capsys):
    out = serve.main(["--arch", "granite-3-2b", "--reduce", "--batch", "2", "--prompt-len", "4",
                      "--max-new", "4", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"arch=granite-3-2b generated \(2, 4\) in \d+\.\d\ds "
                        r"\(\d+\.\d tok/s incl\. prompt\)", lines[0]), lines[0]
    assert lines[1] == f"sample: {out[0].tolist()}"
    again = serve.main(["--arch", "granite-3-2b", "--reduce", "--batch", "2", "--prompt-len",
                        "4", "--max-new", "4", "--device", "cpu"])
    torch.testing.assert_close(out, again, rtol=0, atol=0)  # seeded


def test_linear_probe_matches_reference(capsys):
    """The reduced probe: the port's features from the reference's weights at
    1e-4, and its solution within 1e-4 of the reference's, both under the
    reference's final MSE < 1e-4 gate."""
    cfg = linear_probe.probe_config(reduce=True)
    jcfg, params, tcfg, model = pair("granite-3-2b", 1)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    toks = linear_probe.probe_tokens(cfg, reduce=True)
    assert toks.shape == (64, 32)
    hidden, _, _ = jt.forward_hidden(params, jnp.asarray(toks), jcfg)
    want_feats = np.asarray(hidden.reshape(-1, jcfg.d_model), np.float32)
    feats = linear_probe.features(model, cfg, toks)
    assert feats.shape == (2048, 64) and feats.dtype == np.float32
    close(feats, want_feats, 1e-4)
    w_true = np.random.default_rng(0).standard_normal(cfg.d_model).astype(np.float32)
    want = ref_solve(want_feats, want_feats @ w_true, method="dapc", num_blocks=8,
                     num_epochs=150, gamma=1.0, eta=0.9, x_ref=w_true, materialize_p=False)
    got = linear_probe.fit(feats, w_true, kernels=True, device="cpu")
    assert got.final_mse < linear_probe.MSE_GATE and want.final_mse < linear_probe.MSE_GATE
    np.testing.assert_allclose(got.x, np.asarray(want.x), rtol=0, atol=1e-4)
    out = linear_probe.main(["--reduce", "--kernels", "--device", "cpu"])
    assert out["record"]["mode"] == "tall" and out["record"]["features"] == [2048, 64]
    assert capsys.readouterr().out.strip().endswith("recovered readout OK")
