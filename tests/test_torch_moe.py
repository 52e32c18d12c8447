"""The port's MoE (``repro_torch.models.moe``) and its block against the JAX
package's on the CPU: the sort-based capacity dispatch, its routing and its
Switch aux loss at 1e-5·max (the routing's (T, k) expert ids equal), the
chunking and the capacity drops, and the reference's own MoE property."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced_config as jreduce
from repro.configs.base import ModelConfig as JModelConfig
from repro.distributed.sharding import init_from_specs
from repro.models import blocks as jb
from repro.models import moe as jmoe

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks, moe

from test_torch_models import close, t

MODULE_RTOL = 1e-5  # per module: 1e-5·max|reference|


def load_tree(module, tree):
    """Copy a reference parameter tree (nested dicts of arrays) into
    ``module``, whose parameter names are the tree's paths."""
    params = dict(module.named_parameters())
    flat = {path: leaf for path, leaf in _flatten(tree)}
    assert set(params) == set(flat), (sorted(params), sorted(flat))
    with torch.no_grad():
        for name, param in params.items():
            param.copy_(torch.as_tensor(np.array(flat[name])))
    return module


def _flatten(tree, prefix=""):
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for key, value in tree.items():
        yield from _flatten(value, f"{prefix}.{key}" if prefix else key)


def spec_params(spec, seed):
    """The reference's init of ``spec``, with every constant-initialised
    leaf (zeros, ones) moved by 0.05·N(0, 1) so it counts."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, init_from_specs(spec, jax.random.PRNGKey(seed)))

    def move(x):
        if np.all(x == 0) or np.all(x == 1):
            return (x + 0.05 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x

    return jax.tree.map(move, tree)


def configs(**over):
    """The reference's and the port's reduced deepseek-moe-16b config (8
    experts, top-2, 2 shared) with ``over`` applied."""
    return (dataclasses.replace(jreduce(jget("deepseek-moe-16b")), **over),
            dataclasses.replace(reduced_config(get_config("deepseek-moe-16b")), **over))


def jax_routing(p, x_flat, cfg):
    """The reference's router lines (``moe._dispatch_combine``): top-k of the
    f32 softmax, and the probabilities."""
    probs = jax.nn.softmax((x_flat @ p["router"]).astype(jnp.float32), axis=-1)
    _, eidx = jax.lax.top_k(probs, cfg.moe_top_k)
    return np.asarray(eidx), np.asarray(probs)


@pytest.mark.parametrize("shape,seq_chunk,capacity_factor", [
    ((2, 16), 64, 1.25),  # one chunk at cap 8
    ((2, 48), 32, 1.25),  # three chunks of 32 tokens
    ((3, 7), 8, 1.25),  # 21 tokens do not divide by 8: one dispatch
    ((4, 64), 256, 0.5),  # 256 tokens at cap 32 for 64 slots: drops
])
def test_apply_moe_matches_reference(shape, seq_chunk, capacity_factor):
    jcfg, tcfg = configs(moe_seq_chunk=seq_chunk, capacity_factor=capacity_factor)
    p = spec_params(jmoe.moe_spec(jcfg), 0)
    mod = load_tree(moe.MoE(tcfg, "cpu"), p)
    x = np.random.default_rng(1).standard_normal(shape + (jcfg.d_model,)).astype(np.float32)
    want_y, want_aux = jmoe.apply_moe(p, jnp.asarray(x), jcfg)
    got_y, got_aux = mod(t(x))
    close(got_y, want_y, MODULE_RTOL)
    assert float(got_aux) == pytest.approx(float(want_aux), rel=1e-5)
    # routing, chunk by chunk as apply_moe dispatches: equal (T, k) ids
    eidx, probs, dropped = moe.routing(mod, t(x), tcfg)
    flat = x.reshape(-1, jcfg.d_model)
    t_all = flat.shape[0]
    chunk = min(seq_chunk, t_all) if t_all % min(seq_chunk, t_all) == 0 else t_all
    want_drop = 0
    for start in range(0, t_all, chunk):
        want_e, want_p = jax_routing(p, flat[start:start + chunk], jcfg)
        np.testing.assert_array_equal(eidx[start:start + chunk].numpy(), want_e)
        close(probs[start:start + chunk], want_p, MODULE_RTOL)
        counts = np.bincount(want_e.reshape(-1), minlength=jcfg.num_experts)
        cap = max(8, int(round(chunk * jcfg.moe_top_k / jcfg.num_experts * capacity_factor)))
        assert moe.capacity(chunk, tcfg) == cap
        want_drop += int(np.maximum(counts - cap, 0).sum())
    assert dropped == want_drop
    assert dropped > 0 or capacity_factor > 1


def test_routing_helper_leaves_the_output_alone():
    """``routing`` reads what ``apply_moe`` routes; calling it between two
    forwards changes nothing, and a dispatch with drops differs from one
    without (capacity is per chunk)."""
    _, tcfg = configs(moe_seq_chunk=256, capacity_factor=0.5)
    mod = load_tree(moe.MoE(tcfg, "cpu"), spec_params(jmoe.moe_spec(configs()[0]), 0))
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((4, 64, 64)),
                        dtype=torch.float32)
    y1, _ = mod(x)
    _, _, dropped = moe.routing(mod, x, tcfg)
    y2, _ = mod(x)
    assert torch.equal(y1, y2) and dropped > 0
    wide = dataclasses.replace(tcfg, capacity_factor=8.0)
    assert moe.routing(mod, x, wide)[2] == 0
    assert not torch.equal(moe.apply_moe(mod, x, wide)[0], y1)


def test_moe_routes_to_multiple_experts():
    """The reference's property (tests/test_model_properties.py): the router
    spreads load (Switch aux loss near-balanced ~1.0 for random inputs) and
    the output is finite."""
    cfg = ModelConfig(
        name="m", family="moe", num_layers=1, d_model=32, num_heads=2,
        num_kv_heads=2, d_ff=0, vocab_size=64, num_experts=8,
        num_shared_experts=1, moe_top_k=2, moe_d_ff=16, moe_seq_chunk=64,
    )
    jcfg = JModelConfig(**dataclasses.asdict(cfg))
    p = jax.tree.map(np.asarray, init_from_specs(jmoe.moe_spec(jcfg), jax.random.PRNGKey(0)))
    mod = load_tree(moe.MoE(cfg, "cpu"), p)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 32, 32)))
    y, aux = mod(t(x))
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert 0.8 < float(aux) < 1.6
    eidx, _, _ = moe.routing(mod, t(x), cfg)
    assert len(torch.unique(eidx)) > cfg.moe_top_k
    want_y, want_aux = jmoe.apply_moe(p, jnp.asarray(x), jcfg)
    close(y, want_y, MODULE_RTOL)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_moe_block_matches_reference(mode):
    """The ``moe`` block (attention + MoE) in each mode: output and aux loss
    at 1e-5, the bf16 KV cache within one bf16 ulp."""
    jcfg, tcfg = configs()
    p = spec_params(jb.moe_block_spec(jcfg), 3)
    block = load_tree(blocks.make_block(tcfg, "moe", "cpu"), p)
    rng = np.random.default_rng(4)
    s = 1 if mode == "decode" else 6
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    cache = None
    if mode != "train":
        shapes = jb.cache_shapes(jcfg, "moe", 2, 8)
        cache = {k: rng.standard_normal(shape).astype(np.float32) * (mode == "decode")
                 for k, (shape, _, _) in shapes.items()}
        jcache = {k: jnp.asarray(v, jnp.bfloat16) for k, v in cache.items()}
        cache = {k: torch.as_tensor(np.array(v.astype(jnp.float32))).bfloat16()
                 for k, v in jcache.items()}
    else:
        jcache = None
    want, want_cache, want_aux = jb.moe_apply(jcfg, p, jnp.asarray(x), mode, jcache, 3, None)
    got, got_cache, got_aux = blocks.apply_block(tcfg, "moe", block, t(x), mode, cache, 3)
    close(got, want, MODULE_RTOL)
    assert float(got_aux) == pytest.approx(float(want_aux), rel=1e-5)
    if cache is not None:
        assert got_cache is cache
        for k in cache:
            a = np.asarray(want_cache[k].astype(jnp.float32))
            b = cache[k].float().numpy()
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 1e-30))) - 7)
            assert (np.abs(a - b) <= ulp).all(), k
