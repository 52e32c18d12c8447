"""The six model families item 10b ported (deepseek-moe-16b,
deepseek-v2-236b, zamba2-7b, xlstm-1.3b, llama-3.2-vision-90b,
whisper-small) against the JAX package on the CPU, from the reference's
weights carried across by ``params_from_reference``.

Per module (MLA in train, prefill and decode; the gated and ungated
cross-attention blocks; the non-causal encoder block): 1e-5·max of the
reference. Per arch: the forward and its logits at 1e-4·max, the prefill's
logits and caches, decode steps at the reference's 5e-3·scale, greedy
tokens equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced_config as jreduce
from repro.models import blocks as jb
from repro.models import transformer as jt
from repro.serving import decode as jdecode

from repro_torch.configs import get_config, reduced_config
from repro_torch.models import blocks, transformer
from repro_torch.models.convert import params_from_reference
from repro_torch.serving import decode

from test_torch_models import close, t
from test_torch_moe import MODULE_RTOL, load_tree, spec_params

FAMILIES = ["deepseek-moe-16b", "deepseek-v2-236b", "zamba2-7b", "xlstm-1.3b",
            "llama-3.2-vision-90b", "whisper-small"]
ARCH_RTOL = 1e-4  # forward and logits, per arch
DECODE_RTOL = 5e-3  # the reference's decode gate (tests/test_arch_smoke.py)


def moved(tree, seed=7):
    """Every constant-initialised leaf (zeros, ones: norms, biases, the
    cross gate) moved by 0.05·N(0, 1), so it counts in the comparison."""
    rng = np.random.default_rng(seed)

    def move(x):
        x = np.asarray(x)
        if x.size and (np.all(x == 0) or np.all(x == 1)):
            return (x + 0.05 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x

    return jax.tree.map(move, tree)


def family(arch):
    """(ref cfg, ref params, port cfg, port model) at ``reduced_config``."""
    jcfg, tcfg = jreduce(jget(arch)), reduced_config(get_config(arch))
    params = moved(jt.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, params, tcfg, params_from_reference(tcfg, params, device="cpu")


def aux_inputs(cfg, b, seed=2):
    """The modality stubs the serving command line draws: (ref's, port's)."""
    rng = np.random.default_rng(seed)
    aux = {}
    if cfg.vision_seq:
        aux["patches"] = 0.1 * rng.standard_normal((b, cfg.vision_seq, cfg.d_model))
    if cfg.is_encdec:
        aux["enc_frames"] = 0.1 * rng.standard_normal((b, cfg.encoder_seq, cfg.d_model))
    aux = {k: v.astype(np.float32) for k, v in aux.items()}
    return ({k: jnp.asarray(v) for k, v in aux.items()} or None,
            {k: t(v) for k, v in aux.items()} or None)


def tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def bf16_close(got, want):
    """A bf16 cache within one bf16 ulp of the reference's, entry by entry,
    plus 1e-6·max|want| for entries near zero (a difference of two f32
    terms, where the stack's f32 rounding exceeds an ulp of the result)."""
    a = np.asarray(want.astype(jnp.float32))
    b = got.float().numpy()
    assert got.dtype == torch.bfloat16 and b.shape == a.shape
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 1e-30))) - 7)
    assert (np.abs(a - b) <= ulp + 1e-6 * np.abs(a).max()).all()


# -- modules ------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_mla_attention_matches_reference(mode):
    """MLA: full attention in train and prefill (prefill writes ``ckv``/``kpe``
    in bf16), the absorbed decode against the bf16 caches at position 5."""
    jcfg, tcfg = jreduce(jget("deepseek-v2-236b")), reduced_config(get_config("deepseek-v2-236b"))
    p = spec_params(jb.mla_spec(jcfg), 0)
    mod = load_tree(blocks.MLA(tcfg, "cpu"), p)
    rng = np.random.default_rng(1)
    s = 1 if mode == "decode" else 7
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    jcache = cache = None
    if mode != "train":
        shapes = jb._mla_cache_shapes(jcfg, 2, 9)
        filled = {k: rng.standard_normal(shape) * (mode == "decode") for k, (shape, _, _)
                  in shapes.items()}
        jcache = {k: jnp.asarray(v, jnp.bfloat16) for k, v in filled.items()}
        cache = {k: t(np.asarray(v.astype(jnp.float32))).bfloat16() for k, v in jcache.items()}
    want, want_cache = jb._mla_attn(p, jnp.asarray(x), jcfg, mode, jcache, 5)
    got, same = mod(t(x), mode, cache, 5)
    close(got, want, MODULE_RTOL)
    if cache is not None:
        assert same is cache
        for k in cache:
            bf16_close(cache[k], want_cache[k])


@pytest.mark.parametrize("btype", ["cross", "encdec_dec"])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_cross_blocks_match_reference(btype, mode):
    """Self-attention, cross-attention to the source (patches, gated by the
    moved gate; or the encoder output, ungated), the MLP. Prefill writes
    ``ck``/``cv`` from the source; decode reads them, every position valid."""
    arch = "llama-3.2-vision-90b" if btype == "cross" else "whisper-small"
    jcfg, tcfg = jreduce(jget(arch)), reduced_config(get_config(arch))
    p = spec_params(jb.block_spec(jcfg, btype), 3)
    block = load_tree(blocks.make_block(tcfg, btype, "cpu"), p)
    rng = np.random.default_rng(4)
    src_len = jcfg.vision_seq or jcfg.encoder_seq
    src = (0.5 * rng.standard_normal((2, src_len, jcfg.d_model))).astype(np.float32)
    key = "patches" if btype == "cross" else "enc_out"
    s = 1 if mode == "decode" else 6
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    jcache = cache = None
    if mode != "train":
        shapes = jb.cache_shapes(jcfg, btype, 2, 8)
        filled = {k: rng.standard_normal(shape) * (mode == "decode")
                  for k, (shape, _, _) in shapes.items()}
        jcache = {k: jnp.asarray(v, jnp.bfloat16) for k, v in filled.items()}
        cache = {k: t(np.asarray(v.astype(jnp.float32))).bfloat16() for k, v in jcache.items()}
    want, want_cache, _ = jb.apply_block(jcfg, btype, p, jnp.asarray(x), mode, jcache, 5,
                                         {key: jnp.asarray(src)})
    got, same, _ = blocks.apply_block(tcfg, btype, block, t(x), mode, cache, 5, {key: t(src)})
    close(got, want, MODULE_RTOL)
    if cache is not None:
        assert same is cache
        for k in cache:
            bf16_close(cache[k], want_cache[k])


@pytest.mark.parametrize("mode", ["train", "decode"])
def test_encoder_block_matches_reference(mode):
    """The ``enc`` block attends both ways and keeps no cache in any mode."""
    jcfg, tcfg = jreduce(jget("whisper-small")), reduced_config(get_config("whisper-small"))
    p = spec_params(jb.enc_spec(jcfg), 5)
    block = load_tree(blocks.make_block(tcfg, "enc", "cpu"), p)
    x = np.random.default_rng(6).standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    want, _, _ = jb.apply_block(jcfg, "enc", p, jnp.asarray(x), mode)
    got, cache, aux = blocks.apply_block(tcfg, "enc", block, t(x), mode)
    close(got, want, MODULE_RTOL)
    assert cache is None and aux == 0.0


# -- whole archs -----------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_prefill_and_decode_match_reference(arch):
    """Train-mode forward, its logits and its MoE aux loss at 1e-4·max; the
    prefill's logits at 1e-4, its bf16 caches within one ulp and its f32
    states at 1e-4; then four decode steps continuing it at 5e-3·scale."""
    jcfg, params, tcfg, model = family(arch)
    jaux, taux = aux_inputs(tcfg, 2)
    toks = tokens(tcfg, (2, 12))
    v = tcfg.vocab_size
    jh, _, jal = jt.forward_hidden(params, jnp.asarray(toks), jcfg, aux=jaux)
    th, caches, tal = transformer.forward_hidden(model, t(toks), tcfg, aux=taux)
    assert caches is None
    close(th, jh, ARCH_RTOL)
    assert float(tal) == pytest.approx(float(jal), rel=1e-5, abs=1e-7)
    close(transformer.logits_from_hidden(model, th, tcfg)[..., :v],
          np.asarray(jt.logits_from_hidden(params, jh, jcfg))[..., :v], ARCH_RTOL)

    want_logits, want = jt.prefill(params, jnp.asarray(toks[:, :8]), jcfg, 12, aux=jaux)
    got_logits, got = transformer.prefill(model, t(toks[:, :8]), tcfg, 12, aux=taux)
    close(got_logits[..., :v], np.asarray(want_logits)[..., :v], ARCH_RTOL)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, leaf in flat:
        group, slot, name = (str(getattr(k, "key", k)) for k in path)
        tensor = got[group][slot][name]
        if leaf.dtype == jnp.bfloat16:
            bf16_close(tensor, leaf)
        else:
            assert tensor.dtype == torch.float32
            close(tensor, leaf, ARCH_RTOL)
    for i in range(8, 12):
        want_l, want = jt.decode_step(params, want, jnp.asarray(toks[:, i:i + 1]),
                                      jnp.int32(i), jcfg, aux=jaux)
        got_l, got = transformer.decode_step(model, got, t(toks[:, i:i + 1]), i, tcfg,
                                             aux=taux)
        close(got_l[..., :v], np.asarray(want_l)[..., :v], DECODE_RTOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_greedy_tokens_match_reference(arch):
    """``generate`` (prefill, then greedy steps) gives the reference's tokens
    at every step whose top-2 margin, on the reference's own logits, exceeds
    1e-4·max|logits|, up to the first that does not. (The margin is the
    forward's tolerance, not the decode gate: the port's decode logits agree
    with the reference's to ~1e-5·max, and reduced xlstm's first margin is
    1.5e-3·max.)"""
    jcfg, params, tcfg, model = family(arch)
    jaux, taux = aux_inputs(tcfg, 3)
    prompts = tokens(tcfg, (3, 6), seed=7)
    max_new = 6
    want = np.asarray(jdecode.generate(params, jcfg, jnp.asarray(prompts), max_new=max_new,
                                       aux=jaux))
    got = decode.generate(model, tcfg, t(prompts), max_new=max_new, aux=taux).numpy()
    seq = np.concatenate([prompts, want], axis=1)
    plen = prompts.shape[1]
    logits, cache = jt.prefill(params, jnp.asarray(prompts), jcfg, plen + max_new, aux=jaux)
    steps = [np.asarray(logits)[:, -1]]
    for i in range(plen, plen + max_new - 1):
        lg, cache = jt.decode_step(params, cache, jnp.asarray(seq[:, i:i + 1]), jnp.int32(i),
                                   jcfg, aux=jaux)
        steps.append(np.asarray(lg)[:, 0])
    ref_logits = np.stack(steps, 1)[..., :tcfg.vocab_size]
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    tol = ARCH_RTOL * float(np.abs(ref_logits).max())
    for b in range(prompts.shape[0]):
        decided = np.cumprod(margin[b] > tol).astype(bool)
        assert decided[0]
        np.testing.assert_array_equal(got[b][decided], want[b][decided])
