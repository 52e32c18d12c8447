"""The reference's own model properties held within the port for the six
families item 10b ported, and the reference's faults pinned in both
packages: decode reproduces teacher forcing (tests/test_arch_smoke.py) and
a prefilled cache continues as token-by-token decode does
(tests/test_model_properties.py) with no MoE token dropped; whisper's
encoder is bidirectional; whisper's decode embeds position 0 in both
packages; the port skips the encoder in decode with the same logits; the
converter refuses leftover, missing and short leaves for every arch."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as jget
from repro.configs import reduced_config as jreduce
from repro.models import transformer as jt

from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import serve
from repro_torch.models import moe, transformer
from repro_torch.models.convert import params_from_reference

from test_torch_cuda import port_model
from test_torch_families import DECODE_RTOL, FAMILIES, aux_inputs, family, tokens
from test_torch_models import close, t

CONTINUATION_RTOL = 2e-2  # the reference's gate (tests/test_model_properties.py)


def decode_all(model, cfg, toks, caches, start=0, aux=None):
    """Logits (first vocab_size) of decoding ``toks`` from position ``start``."""
    out = []
    for i in range(toks.shape[1]):
        logits, caches = transformer.decode_step(model, caches, toks[:, i:i + 1], start + i, cfg,
                                                 aux=aux)
        out.append(logits[:, 0, :cfg.vocab_size])
    return torch.stack(out, 1)


def scaled_err(got, want):
    return float((got - want).abs().max()) / (float(want.abs().max()) + 1e-9)


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b", "deepseek-v2-236b",
                                  "deepseek-moe-16b"])
def test_decode_matches_teacher_forcing(arch):
    """Token-by-token decode reproduces the train-mode forward at 5e-3·scale.
    The MoE archs run where the drop counter reads 0 (decode and the forward
    drop different tokens otherwise)."""
    cfg, model = port_model(arch)
    toks = t(tokens(cfg, (2, 8)))
    with moe.record_routing(model) as routed:
        hid, _, _ = transformer.forward_hidden(model, toks, cfg)
        dec = decode_all(model, cfg, toks, transformer.init_cache(cfg, 2, 8, device="cpu"))
    assert sum(r[2] for r in routed) == 0
    assert bool(routed) == bool(cfg.num_experts)
    full = transformer.logits_from_hidden(model, hid, cfg)[..., :cfg.vocab_size]
    assert scaled_err(dec, full) <= DECODE_RTOL


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b", "deepseek-v2-236b",
                                  "llama-3.2-vision-90b"])
def test_prefill_continuation_matches_decode(arch):
    """Continuing from a prefilled cache (KV caches, MLA's latent caches, the
    SSD/mLSTM/sLSTM states, the cross caches) equals pure token-by-token
    decode at 2e-2·scale, with no MoE token dropped. Only a prefill writes
    the cross caches, so for the vision arch token by token starts from a
    one-token prefill."""
    cfg, model = port_model(arch)
    _, aux = aux_inputs(cfg, 2)
    s, p = 12, 8
    toks = t(tokens(cfg, (2, s)))
    with moe.record_routing(model) as routed:
        _, cache = transformer.prefill(model, toks[:, :p], cfg, s, aux=aux)
        a = decode_all(model, cfg, toks[:, p:], cache, p, aux)
        first = 1 if cfg.vision_seq else 0
        if first:
            cache = transformer.prefill(model, toks[:, :first], cfg, s, aux=aux)[1]
        else:
            cache = transformer.init_cache(cfg, 2, s, device="cpu")
        b = decode_all(model, cfg, toks[:, first:], cache, first, aux)[:, p - first:]
    assert sum(r[2] for r in routed) == 0
    assert scaled_err(a, b) <= CONTINUATION_RTOL


def test_whisper_encoder_not_causal():
    """Changing the LAST frames changes the FIRST decoder position."""
    cfg, model = port_model("whisper-small")
    toks = t(tokens(cfg, (1, 6)))
    rng = np.random.default_rng(2)
    frames = t((0.1 * rng.standard_normal((1, cfg.encoder_seq, cfg.d_model))).astype(np.float32))
    frames2 = frames.clone()
    frames2[:, -2:] += t(rng.standard_normal((1, 2, cfg.d_model)).astype(np.float32))
    h1, _, _ = transformer.forward_hidden(model, toks, cfg, aux={"enc_frames": frames})
    h2, _, _ = transformer.forward_hidden(model, toks, cfg, aux={"enc_frames": frames2})
    assert float((h1[:, 0] - h2[:, 0]).abs().max()) > 1e-4


def test_whisper_decode_embeds_position_zero_in_both_packages():
    """A fault of the reference, copied for parity: ``_embed`` adds the
    sinusoid at ``arange(tokens.shape[1])``, so every one-token decode step
    embeds position 0 (and absolute positions mean no RoPE either). Both
    packages: a step's embedding is the first position's of a prompt
    starting with its token, and token-by-token decode misses the
    train-mode forward by far more than the decode gate, while the two
    packages' decode logits agree."""
    jcfg, params, tcfg, model = family("whisper-small")
    toks = tokens(tcfg, (2, 8))
    for embed, p, cfg, arr in ((jt._embed, params, jcfg, jnp.asarray),
                               (transformer._embed, model, tcfg, t)):
        one = np.asarray(embed(p, arr(toks[:, 5:6]), cfg))
        np.testing.assert_array_equal(one, np.asarray(embed(p, arr(toks[:, 5:]), cfg))[:, :1])
    jaux, taux = aux_inputs(tcfg, 2)
    v = tcfg.vocab_size
    jh, _, _ = jt.forward_hidden(params, jnp.asarray(toks), jcfg, aux=jaux)
    want_full = np.asarray(jt.logits_from_hidden(params, jh, jcfg))[..., :v]
    _, jcache = jt.prefill(params, jnp.asarray(toks[:, :1]), jcfg, 8, aux=jaux)
    want = []
    for i in range(1, 8):
        lg, jcache = jt.decode_step(params, jcache, jnp.asarray(toks[:, i:i + 1]),
                                    jnp.int32(i), jcfg, aux=jaux)
        want.append(np.asarray(lg)[:, 0, :v])
    want = np.stack(want, 1)
    _, cache = transformer.prefill(model, t(toks[:, :1]), tcfg, 8, aux=taux)
    got = decode_all(model, tcfg, t(toks[:, 1:]), cache, 1, taux)
    close(got, want, DECODE_RTOL)
    for full, dec in ((want_full, want), (transformer.logits_from_hidden(
            model, transformer.forward_hidden(model, t(toks), tcfg, aux=taux)[0], tcfg)[..., :v],
            got)):
        assert scaled_err(torch.as_tensor(dec), torch.as_tensor(np.array(full))[:, 1:]) > 0.1


def test_encoder_is_skipped_in_decode():
    """The port runs the encoder in train and prefill only: decode logits
    are equal with and without ``enc_frames`` (decode's cross-attention
    reads the ck/cv caches), and equal the reference's, which re-runs the
    encoder on every step."""
    jcfg, params, tcfg, model = family("whisper-small")
    jaux, taux = aux_inputs(tcfg, 2)
    toks = tokens(tcfg, (2, 10))
    v = tcfg.vocab_size
    _, with_frames = transformer.prefill(model, t(toks[:, :6]), tcfg, 10, aux=taux)
    without = {g: None if c is None else {s: {k: x.clone() for k, x in leaves.items()}
                                          for s, leaves in c.items()}
               for g, c in with_frames.items()}
    a = decode_all(model, tcfg, t(toks[:, 6:]), with_frames, 6, taux)
    b = decode_all(model, tcfg, t(toks[:, 6:]), without, 6)
    assert torch.equal(a, b)
    _, jcache = jt.prefill(params, jnp.asarray(toks[:, :6]), jcfg, 10, aux=jaux)
    for i in range(6, 10):
        lg, jcache = jt.decode_step(params, jcache, jnp.asarray(toks[:, i:i + 1]),
                                    jnp.int32(i), jcfg, aux=jaux)
        close(b[:, i - 6], np.asarray(lg)[:, 0, :v], DECODE_RTOL)


def _first_stacked(tree, group):
    """Path of the first leaf under ``group`` (every leaf there is stacked)."""
    for path, _ in jax.tree_util.tree_flatten_with_path(tree[group])[0]:
        return [group] + [str(getattr(k, "key", k)) for k in path]
    raise AssertionError(group)


def _replace(tree, path, value):
    if len(path) == 1:
        out = dict(tree)
        if value is None:
            del out[path[0]]
        else:
            out[path[0]] = value
        return out
    return {**tree, path[0]: _replace(tree[path[0]], path[1:], value)}


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_converter_refuses_leftover_missing_and_short_leaves(arch):
    """For every arch: a leaf the port does not use, a missing leaf and a
    stack shorter than the port's layers each raise, naming the leaf; the
    complete tree converts with every parameter filled."""
    jcfg, tcfg = jreduce(jget(arch)), reduced_config(get_config(arch))
    tree = jax.tree.map(np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(0)))
    model = params_from_reference(tcfg, tree, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == jt.count_params(jcfg)
    extra = _replace(tree, ["main", "unused"], np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="left over.*main/unused"):
        params_from_reference(tcfg, extra, device="cpu")
    groups = ["main"] + (["encoder"] if jcfg.is_encdec else [])
    for group in groups:
        path = _first_stacked(tree, group)
        with pytest.raises(KeyError, match="/".join(path)):
            params_from_reference(tcfg, _replace(tree, path, None), device="cpu")
        short = _leaf(tree, path)[:-1]
        with pytest.raises(ValueError, match=f"{'/'.join(path)} stacks {len(short)} layers"):
            params_from_reference(tcfg, _replace(tree, path, short), device="cpu")


@pytest.mark.parametrize("arch", FAMILIES)
def test_launch_serve_runs_every_family(arch, capsys):
    """The serving command line on each family's reduced config prints the
    reference's two lines, seeded: the same tokens twice. Its modality stubs
    are 0.1·N(0, 1) from generators seeded 2 (patches) and 3 (frames)."""
    argv = ["--arch", arch, "--reduce", "--batch", "2", "--prompt-len", "4", "--max-new", "4",
            "--device", "cpu"]
    out = serve.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(rf"arch={arch} generated \(2, 4\) in \d+\.\d\ds "
                        r"\(\d+\.\d tok/s incl\. prompt\)", lines[0]), lines[0]
    assert lines[1] == f"sample: {out[0].tolist()}"
    assert torch.equal(out, serve.main(argv))
    cfg = reduced_config(get_config(arch))
    aux = serve.stubs(cfg, 2, "cpu")
    assert (aux is None) == (not cfg.vision_seq and not cfg.is_encdec)
    for key, seq, seed in (("patches", cfg.vision_seq, 2), ("enc_frames", cfg.encoder_seq, 3)):
        if aux and key in aux:
            gen = torch.Generator().manual_seed(seed)
            assert torch.equal(aux[key], 0.1 * torch.randn((2, seq, cfg.d_model), generator=gen))
