"""The port's recurrent mixers against the JAX package's on the CPU, at
1e-5·max of the reference: Mamba2's chunked SSD (``apply_mamba2``, its
prefill state and raw conv cache, ``mamba2_decode``), mLSTM (chunked, and
its decode) and sLSTM (the time loop, and its decode). Every decode writes
its states into the cache in place, in the dtypes the cache declares."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced_config as jreduce
from repro.models import blocks as jb
from repro.models import ssm as jssm
from repro.models import xlstm as jx

from repro_torch.configs import get_config, reduced_config
from repro_torch.models import blocks, ssm, xlstm

from test_torch_models import close, t
from test_torch_moe import MODULE_RTOL, load_tree, spec_params


def configs(arch, **over):
    return (dataclasses.replace(jreduce(jget(arch)), **over),
            dataclasses.replace(reduced_config(get_config(arch)), **over))


def random_cache(shapes, seed):
    """A nonzero f32 cache for each declared leaf: (reference's, port's)."""
    rng = np.random.default_rng(seed)
    arrays = {k: (0.3 * rng.standard_normal(shape)).astype(np.float32)
              for k, (shape, _, _) in shapes.items()}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: t(v) for k, v in arrays.items()})


def check_cache(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == v.shape, k
        close(got[k], v, MODULE_RTOL)


# (sequence length, chunk): several chunks with padding, one whole chunk, a
# prompt shorter than the conv window (its conv cache is zero-padded)
LENGTHS = [(20, 8), (16, 16), (2, 128)]


@pytest.mark.parametrize("s,chunk", LENGTHS)
def test_mamba2_matches_reference(s, chunk):
    jcfg, tcfg = configs("zamba2-7b")
    p = spec_params(jssm.mamba2_spec(jcfg), 0)
    mod = load_tree(ssm.Mamba2(tcfg, "cpu"), p)
    x = np.random.default_rng(1).standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    close(ssm.apply_mamba2(mod, t(x), tcfg, chunk=chunk),
          jssm.apply_mamba2(p, jnp.asarray(x), jcfg, chunk=chunk), MODULE_RTOL)
    want_y, want_c = jssm.apply_mamba2(p, jnp.asarray(x), jcfg, chunk=chunk, return_state=True)
    cache = {k: torch.full(shape, 9.0, dtype=dtype)
             for k, (shape, dtype, _) in ssm.mamba2_cache_shapes(tcfg, 2).items()}
    close(ssm.apply_mamba2(mod, t(x), tcfg, chunk=chunk, cache=cache), want_y, MODULE_RTOL)
    check_cache(cache, want_c)
    if s < tcfg.conv_kernel - 1:
        assert not cache["conv"][:, : tcfg.conv_kernel - 1 - s].any()


def test_mamba2_decode_matches_reference():
    jcfg, tcfg = configs("zamba2-7b")
    p = spec_params(jssm.mamba2_spec(jcfg), 2)
    mod = load_tree(ssm.Mamba2(tcfg, "cpu"), p)
    jcache, cache = random_cache(jssm.mamba2_cache_shapes(jcfg, 3), 3)
    state, conv = cache["state"], cache["conv"]
    x = np.random.default_rng(4).standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    want_y, want_c = jssm.mamba2_decode(p, jnp.asarray(x), jcache, jcfg)
    y, same, _ = blocks.apply_block(tcfg, "mamba2", mod, t(x), "decode", cache)
    close(y, jnp.asarray(x) + want_y, MODULE_RTOL)
    assert same is cache and cache["state"] is state and cache["conv"] is conv
    check_cache(cache, want_c)


@pytest.mark.parametrize("s,chunk", LENGTHS)
def test_mlstm_matches_reference(s, chunk):
    jcfg, tcfg = configs("xlstm-1.3b")
    p = spec_params(jx.mlstm_spec(jcfg), 5)
    mod = load_tree(xlstm.MLSTM(tcfg, "cpu"), p)
    x = np.random.default_rng(6).standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    want_y, want_c = jx.apply_mlstm(p, jnp.asarray(x), jcfg, chunk=chunk, return_state=True)
    cache = {k: torch.full(shape, 9.0, dtype=dtype)
             for k, (shape, dtype, _) in xlstm.mlstm_cache_shapes(tcfg, 2).items()}
    close(xlstm.apply_mlstm(mod, t(x), tcfg, chunk=chunk), want_y, MODULE_RTOL)
    close(xlstm.apply_mlstm(mod, t(x), tcfg, chunk=chunk, cache=cache), want_y, MODULE_RTOL)
    check_cache(cache, want_c)


def test_mlstm_decode_matches_reference():
    jcfg, tcfg = configs("xlstm-1.3b")
    p = spec_params(jx.mlstm_spec(jcfg), 7)
    mod = load_tree(xlstm.MLSTM(tcfg, "cpu"), p)
    jcache, cache = random_cache(jx.mlstm_cache_shapes(jcfg, 3), 8)
    x = np.random.default_rng(9).standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    want_y, want_c = jx.mlstm_decode(p, jnp.asarray(x), jcache, jcfg)
    y, same, _ = blocks.apply_block(tcfg, "mlstm", mod, t(x), "decode", cache)
    close(y, jnp.asarray(x) + want_y, MODULE_RTOL)
    assert same is cache
    check_cache(cache, want_c)


@pytest.mark.parametrize("s", [1, 9])
def test_slstm_matches_reference(s):
    jcfg, tcfg = configs("xlstm-1.3b")
    p = spec_params(jx.slstm_spec(jcfg), 10)
    mod = load_tree(xlstm.SLSTM(tcfg, "cpu"), p)
    x = np.random.default_rng(11).standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    want_y, want_c = jx.apply_slstm(p, jnp.asarray(x), jcfg, return_state=True)
    cache = {k: torch.full(shape, 9.0, dtype=dtype)
             for k, (shape, dtype, _) in xlstm.slstm_cache_shapes(tcfg, 2).items()}
    close(xlstm.apply_slstm(mod, t(x), tcfg), want_y, MODULE_RTOL)
    y, _, _ = blocks.apply_block(tcfg, "slstm", mod, t(x), "prefill", cache)
    close(y, jnp.asarray(x) + want_y, MODULE_RTOL)
    check_cache(cache, want_c)


def test_slstm_decode_matches_reference():
    """From a cache with a nonzero stabiliser ``m``: the reference's cell."""
    jcfg, tcfg = configs("xlstm-1.3b")
    p = spec_params(jx.slstm_spec(jcfg), 12)
    mod = load_tree(xlstm.SLSTM(tcfg, "cpu"), p)
    jcache, cache = random_cache(jx.slstm_cache_shapes(jcfg, 3), 13)
    x = np.random.default_rng(14).standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    want_y, want_c = jx.slstm_decode(p, jnp.asarray(x), jcache, jcfg)
    y, same, _ = blocks.apply_block(tcfg, "slstm", mod, t(x), "decode", cache)
    close(y, jnp.asarray(x) + want_y, MODULE_RTOL)
    assert same is cache
    check_cache(cache, want_c)


@pytest.mark.parametrize("btype", ["mamba2", "mlstm", "slstm"])
def test_prefill_then_decode_equals_the_longer_forward(btype):
    """Within the port, at the module level: prefill's state continued by
    decode steps gives what a train-mode pass over the whole sequence gives
    (the states are written in place, so losing one would show here)."""
    arch = "zamba2-7b" if btype == "mamba2" else "xlstm-1.3b"
    jcfg, tcfg = configs(arch)
    spec = jb.block_spec(jcfg, btype)
    mod = load_tree(blocks.make_block(tcfg, btype, "cpu"), spec_params(spec, 15))
    x = t(np.random.default_rng(16).standard_normal((2, 10, jcfg.d_model)).astype(np.float32))
    full, _, _ = blocks.apply_block(tcfg, btype, mod, x, "train")
    cache = {k: torch.zeros(shape, dtype=dtype)
             for k, (shape, dtype, _) in blocks.cache_shapes(tcfg, btype, 2, 10).items()}
    pre, _, _ = blocks.apply_block(tcfg, btype, mod, x[:, :6], "prefill", cache)
    steps = [blocks.apply_block(tcfg, btype, mod, x[:, i:i + 1], "decode", cache, i)[0]
             for i in range(6, 10)]
    close(torch.cat([pre] + steps, 1), full, MODULE_RTOL)
