"""The port's model stack against the JAX package's on the CPU: layers,
attention cores, the dense forward of the four dense archs, prefill caches,
the weight converter and the declarations' init rules. The reference runs as
its own tests run it; the port runs with ``device="cpu"`` on weights carried
across by ``params_from_reference``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced_config as jreduce
from repro.models import layers as jl
from repro.models import transformer as jt

from repro_torch.configs import get_config, reduced_config
from repro_torch.models import blocks, layers, transformer
from repro_torch.models.convert import params_from_reference
from repro_torch.models.spec import ParamSpec, draw, iter_specs

DENSE_ARCHS = ["granite-3-2b", "granite-3-8b", "gemma-7b", "qwen1.5-32b"]
UNPORTED_ARCHS = ["deepseek-moe-16b", "deepseek-v2-236b", "zamba2-7b", "xlstm-1.3b",
                  "llama-3.2-vision-90b", "whisper-small"]


def configs(arch, num_layers=3, **over):
    """The reference's and the port's reduced config of ``arch`` at
    ``num_layers`` dense layers."""
    over = {"num_layers": num_layers, "layer_types": ("dense",) * num_layers, **over}
    return (dataclasses.replace(jreduce(jget(arch)), **over),
            dataclasses.replace(reduced_config(get_config(arch)), **over))


def pair(arch, num_layers=3, **over):
    """(ref cfg, ref params, port cfg, port model): the reference's init
    carried into the port. QKV biases get a nonzero value so they count."""
    jcfg, tcfg = configs(arch, num_layers, **over)
    params = jt.init_params(jcfg, jax.random.PRNGKey(0))
    if jcfg.qkv_bias:
        params = jax.tree_util.tree_map_with_path(
            lambda p, x: x + 0.05 if str(p[-1].key).startswith("b_") else x, params)
    model = params_from_reference(tcfg, jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, tcfg, model


def tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def t(x):
    return torch.as_tensor(np.array(x))


def close(got, want, rtol):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


# -- layers -------------------------------------------------------------------


def test_norms_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    scale = rng.standard_normal(48).astype(np.float32) * 0.1
    bias = rng.standard_normal(48).astype(np.float32) * 0.1
    close(layers.rms_norm(t(x), t(scale), 1e-6), jl.rms_norm(x, scale, 1e-6), 1e-5)
    close(layers.layer_norm(t(x), t(scale + 1), t(bias), 1e-5),
          jl.layer_norm(x, scale + 1, bias, 1e-5), 1e-5)
    # bf16 input: normalized in f32, cast back before the scale
    xb = jnp.asarray(x, jnp.bfloat16)
    got = layers.rms_norm(t(np.asarray(xb.astype(jnp.float32))).bfloat16(), t(scale), 1e-6)
    assert got.dtype == torch.bfloat16
    close(got.float(), jl.rms_norm(xb, scale, 1e-6).astype(jnp.float32), 1e-2)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_rotates_split_halves_like_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7)[None] + 3, (2, 7))
    close(layers.apply_rope(t(x), t(pos), theta), jl.apply_rope(x, pos, theta), 1e-5)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_mlps_match_reference(activation):
    jcfg, tcfg = configs("granite-3-2b", activation=activation)
    spec = jl.mlp_spec(jcfg)
    p = jax.tree.map(np.asarray, jax.tree.map(
        lambda s: 0.1 * jax.random.normal(jax.random.PRNGKey(len(s.shape)), s.shape), spec,
        is_leaf=lambda s: hasattr(s, "axes")))
    x = np.random.default_rng(2).standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    mlp = layers.MLP(tcfg, "cpu")
    assert set(mlp.specs) == set(spec)
    with torch.no_grad():
        for name in mlp.specs:
            getattr(mlp, name).copy_(t(p[name]))
        got = mlp(t(x))
    close(got, jl.apply_mlp(p, x, jcfg), 1e-5)


def _qkv(seed, b, sq, sk, h, hkv, d, dv=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, dv or d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal,q_offset,sq,sk", [
    (True, 0, 9, 9), (True, 4, 5, 9), (False, 0, 6, 11)])
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2)])
def test_plain_attention_matches_reference(causal, q_offset, sq, sk, h, hkv):
    q, k, v = _qkv(sq * sk + h, 2, sq, sk, h, hkv, 8)
    close(layers._plain_attention(t(q), t(k), t(v), causal, q_offset),
          jl._plain_attention(q, k, v, causal, q_offset), 1e-5)


@pytest.mark.parametrize("causal,sq,sk,cq,ck", [
    (True, 40, 40, 16, 16),  # cq == ck: diagonal skip, padded tail
    (True, 48, 48, 16, 16),  # no padding
    (True, 40, 40, 16, 8),  # cq != ck: full causal bias
    (False, 37, 29, 16, 16),  # non-causal, padded q and kv
    (False, 20, 45, 8, 16),
])
def test_chunked_attention_matches_reference(causal, sq, sk, cq, ck):
    q, k, v = _qkv(sq + sk + cq, 2, sq, sk, 8, 2, 8, 12)
    want = jl._chunked_attention(q, k, v, causal, cq, ck)
    got = layers._chunked_attention(t(q), t(k), t(v), causal, cq, ck)
    close(got, want, 1e-5)
    close(got, layers._plain_attention(t(q), t(k), t(v), causal), 1e-5)
    # the dispatcher takes the chunked path only past chunk_q
    close(layers.attention(t(q), t(k), t(v), causal, chunk_q=cq, chunk_kv=ck), want, 1e-5)


@pytest.mark.parametrize("length", [1, 6, 12])
def test_decode_attention_matches_reference(length):
    q, k, v = _qkv(length, 3, 1, 12, 8, 2, 16)
    close(layers.decode_attention(t(q), t(k), t(v), length),
          jl.decode_attention(q, k, v, length), 1e-5)


# -- the dense forward ----------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_and_logits_match_reference(arch):
    jcfg, params, tcfg, model = pair(arch)
    toks = tokens(tcfg, (2, 12))
    jh, _, _ = jt.forward_hidden(params, jnp.asarray(toks), jcfg)
    th, caches, aux = transformer.forward_hidden(model, t(toks), tcfg)
    assert caches is None and aux == 0.0
    close(th, jh, 1e-4)
    want = np.asarray(jt.logits_from_hidden(params, jh, jcfg))
    got = transformer.logits_from_hidden(model, th, tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 12, tcfg.padded_vocab)
    v = tcfg.vocab_size
    close(got[..., :v], want[..., :v], 1e-4)
    assert bool((got[..., v:] == -1e30).all()) and bool((want[..., v:] == -1e30).all())


def test_chunked_prefill_and_absolute_positions_match_reference():
    """A prompt longer than attn_chunk_q takes the chunked path; LayerNorm,
    GELU and sinusoidal positions (whisper's dense choices) on a dense stack."""
    jcfg, params, tcfg, model = pair("granite-3-2b", 2, attn_chunk_q=8, attn_chunk_kv=8,
                                     norm="layernorm", activation="gelu",
                                     pos_embed="absolute")
    toks = tokens(tcfg, (2, 20))
    jh, _, _ = jt.forward_hidden(params, jnp.asarray(toks), jcfg)
    th, _, _ = transformer.forward_hidden(model, t(toks), tcfg)
    close(th, jh, 1e-4)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_caches_match_reference(arch):
    """The bf16 caches agree within one bf16 ulp of each entry; logits at
    1e-4·max|logits|."""
    jcfg, params, tcfg, model = pair(arch)
    toks = tokens(tcfg, (2, 8))
    want_logits, want = jt.prefill(params, jnp.asarray(toks), jcfg, 12)
    got_logits, got = transformer.prefill(model, t(toks), tcfg, 12)
    v = tcfg.vocab_size
    close(got_logits[..., :v], np.asarray(want_logits)[..., :v], 1e-4)
    assert set(got) == set(want) and set(got["main"]) == set(want["main"])
    for name in ("k", "v"):
        a = np.asarray(want["main"]["cache0"][name].astype(jnp.float32))
        b = got["main"]["cache0"][name]
        assert b.dtype == torch.bfloat16 and tuple(b.shape) == a.shape
        b = b.float().numpy()
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 1e-30))) - 7)
        assert (np.abs(a - b) <= ulp).all(), name
        assert not b[:, :, 8:].any()  # the rest of the cache stays zero


def test_causality():
    _, _, tcfg, model = pair("granite-3-2b")
    toks = tokens(tcfg, (2, 12))
    toks2 = toks.copy()
    toks2[:, 6:] = (toks2[:, 6:] + 7) % tcfg.vocab_size
    h1, _, _ = transformer.forward_hidden(model, t(toks), tcfg)
    h2, _, _ = transformer.forward_hidden(model, t(toks2), tcfg)
    torch.testing.assert_close(h1[:, :6], h2[:, :6], atol=1e-5, rtol=0)
    assert float((h1[:, 6:] - h2[:, 6:]).abs().max()) > 1e-4


# -- the converter and the declarations -------------------------------------------


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_converter_maps_every_leaf(arch):
    jcfg, params, tcfg, model = pair(arch)
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    n_port = sum(p.numel() for p in model.parameters())
    assert n_ref == n_port == transformer.count_params(tcfg) == jt.count_params(jcfg)
    # layer r of the stacked slot is the port's layer r
    w = np.asarray(params["main"]["slot0_dense"]["attn"]["w_q"])
    for r in range(3):
        assert np.array_equal(model.layers[r].attn.w_q.numpy(), w[r])
    tree = jax.tree.map(np.asarray, params)
    extra = {**tree, "lm_head": tree["embed"]}
    with pytest.raises(ValueError, match="left over"):
        params_from_reference(tcfg, extra, device="cpu")
    short = {**tree, "main": {"slot0_dense": {**tree["main"]["slot0_dense"], "ln1": {}}}}
    with pytest.raises(KeyError, match="ln1/scale"):
        params_from_reference(tcfg, short, device="cpu")
    cut = jax.tree.map(lambda x: x[:2] if x.ndim > 1 and x.shape[0] == 3 else x, tree)
    with pytest.raises(ValueError, match="stacks 2 layers"):
        params_from_reference(tcfg, cut, device="cpu")


def test_converter_untied_head_and_shared_block():
    """An untied lm_head and a weight-shared zamba_attn block (one module
    repeated) carry across; the forward still matches."""
    types = ("dense", "zamba_attn") * 2 + ("dense",)
    jcfg, params, tcfg, model = pair("granite-3-2b", 5, layer_types=types,
                                     tie_embeddings=False)
    assert "lm_head" in params and "shared" in params and "tail" in params
    assert model.layers[1] is model.layers[3]
    assert sum(p.numel() for p in model.parameters()) == jt.count_params(jcfg)
    toks = tokens(tcfg, (2, 6))
    jh, _, _ = jt.forward_hidden(params, jnp.asarray(toks), jcfg)
    th, _, _ = transformer.forward_hidden(model, t(toks), tcfg)
    close(th, jh, 1e-4)
    close(transformer.logits_from_hidden(model, th, tcfg)[..., :tcfg.vocab_size],
          np.asarray(jt.logits_from_hidden(params, jh, jcfg))[..., :tcfg.vocab_size], 1e-4)
    want_caches = jt.init_cache(jcfg, 2, 8)
    got_caches = transformer.init_cache(tcfg, 2, 8, device="cpu")
    for group in ("main", "tail"):
        for slot, leaves in want_caches[group].items():
            for name, arr in leaves.items():
                assert tuple(got_caches[group][slot][name].shape) == arr.shape


def test_init_params_follows_the_specs():
    cfg = dataclasses.replace(reduced_config(get_config("qwen1.5-32b")), d_model=128,
                              d_ff=256, vocab_size=512)
    model = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    again = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name
        assert not p.requires_grad
    block = model.layers[0]
    assert not block.ln1.scale.any() and not block.attn.b_q.any()
    assert float(model.embed.std()) == pytest.approx(0.02, rel=0.02)
    assert float(block.mlp.w_in.std()) == pytest.approx(0.02, rel=0.05)
    assert model.device == torch.device("cpu")
    gen = torch.Generator().manual_seed(1)
    scaled = draw(ParamSpec((4, 1000), (None, None), scale=0.5), gen)
    assert scaled.device == torch.device("cpu") and scaled.shape == (4, 1000)
    assert float(scaled.std()) == pytest.approx(0.5, rel=0.05)
    assert torch.equal(draw(ParamSpec((3,), (None,), init="ones"), gen), torch.ones(3))
    assert torch.equal(draw(ParamSpec((2, 3), (None, None), init="zeros"), gen,
                            torch.bfloat16), torch.zeros(2, 3, dtype=torch.bfloat16))


# the block types and archs that raised item 10b until it was ported: each
# now builds and runs (the parity tests are test_torch_{moe,ssm_xlstm,families}.py)
ITEM_10B_TYPES = ["cross", "enc", "encdec_dec", "mamba2", "mla_moe", "mlstm", "moe", "slstm"]
ITEM_10B_ARCH_OF = {"cross": "llama-3.2-vision-90b", "enc": "whisper-small",
                    "encdec_dec": "whisper-small", "mamba2": "zamba2-7b",
                    "mla_moe": "deepseek-v2-236b", "mlstm": "xlstm-1.3b",
                    "moe": "deepseek-moe-16b", "slstm": "xlstm-1.3b"}


@pytest.mark.parametrize("btype", ITEM_10B_TYPES)
def test_unported_block_types_raise_with_their_item(btype):
    """Item 10b is in: ``make_block`` builds the type with the reference's
    parameter names and counts, and ``apply_block`` runs it in every mode,
    writing its cache in place."""
    assert btype in blocks._MAKERS
    cfg = reduced_config(get_config(ITEM_10B_ARCH_OF[btype]))
    block = blocks.make_block(cfg, btype, "cpu")
    names = {name.replace(".", "/") for name, _ in block.named_parameters()}
    assert names == {path for path, _ in iter_specs(blocks.block_spec(cfg, btype))}
    gen = torch.Generator().manual_seed(0)
    for module in block.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(gen)
    aux = {"patches": 0.1 * torch.randn(2, cfg.vision_seq or 1, cfg.d_model, generator=gen),
           "enc_out": 0.1 * torch.randn(2, cfg.encoder_seq, cfg.d_model, generator=gen)}
    x = torch.randn(2, 5, cfg.d_model, generator=gen)
    y, cache, _ = blocks.apply_block(cfg, btype, block, x, "train", aux=aux)
    assert y.shape == x.shape and bool(torch.isfinite(y).all()) and cache is None
    shapes = blocks.cache_shapes(cfg, btype, 2, 8)
    if shapes is None:  # the encoder block keeps no cache
        assert btype == "enc"
        return
    cache = {k: torch.zeros(shape, dtype=dtype) for k, (shape, dtype, _) in shapes.items()}
    with torch.no_grad():
        _, same, _ = blocks.apply_block(cfg, btype, block, x, "prefill", cache, aux=aux)
        assert same is cache and all(bool(v.any()) for v in cache.values())
        y1, _, _ = blocks.apply_block(cfg, btype, block, x[:, :1], "decode", cache, 5, aux)
    assert y1.shape == (2, 1, cfg.d_model) and bool(torch.isfinite(y1).all())


@pytest.mark.parametrize("arch", UNPORTED_ARCHS)
def test_unported_archs_raise_with_their_item(arch):
    """Every arch item 10b ported builds, with the reference's parameter
    count, and its cache tree has the reference's leaves, shapes and dtypes."""
    cfg = reduced_config(get_config(arch))
    jcfg = jreduce(jget(arch))
    assert transformer.count_params(cfg) == jt.count_params(jcfg)
    model = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == jt.count_params(jcfg)
    got = transformer.init_cache(cfg, 1, 4, device="cpu")
    want = jt.init_cache(jcfg, 1, 4)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == sum(len(leaves) for g in got.values() if g for leaves in g.values())
    for path, leaf in flat:
        group, slot, name = (str(getattr(k, "key", k)) for k in path)
        tensor = got[group][slot][name]
        assert tuple(tensor.shape) == leaf.shape and not tensor.any()
        assert str(tensor.dtype).removeprefix("torch.") == str(leaf.dtype)
