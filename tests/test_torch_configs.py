"""The port's config registry, parameter declarations and cost model against
the JAX package's: every arch, every field, exact integers (and the cost
model's floats at rtol 1e-12). Nothing here builds a model."""
import dataclasses
import math

import numpy as np
import pytest

import repro.configs as jcfg
import repro.models.costs as jcosts
from repro.models import transformer as jt
from repro.distributed.sharding import ParamSpec as JParamSpec

import repro_torch.configs as tcfg
import repro_torch.models.costs as tcosts
from repro_torch.models import transformer as tt
from repro_torch.models.spec import iter_specs

ARCHS = jcfg.list_archs()


def _ref_specs(tree, prefix=""):
    if isinstance(tree, JParamSpec):
        return {prefix: tree}
    out = {}
    for key, value in tree.items():
        out.update(_ref_specs(value, f"{prefix}/{key}" if prefix else key))
    return out


def test_registry_equal():
    assert tcfg.list_archs() == ARCHS and len(ARCHS) == 10
    assert tcfg.ARCHS == jcfg.ARCHS
    with pytest.raises(KeyError, match="unknown arch"):
        tcfg.get_config("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal(arch):
    want, got = jcfg.get_config(arch), tcfg.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(tcfg.reduced_config(got)) == dataclasses.asdict(
        jcfg.reduced_config(want))
    for prop in ("head_dim_actual", "padded_vocab", "types", "ssm_inner", "ssm_heads",
                 "is_encdec", "supports_long_context"):
        assert getattr(got, prop) == getattr(want, prop), prop
    got.validate()


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_and_applicability_equal(arch):
    assert {k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()}
    for name in jcfg.SHAPES:
        assert tcfg.applicable(tcfg.get_config(arch), tcfg.SHAPES[name]) == jcfg.applicable(
            jcfg.get_config(arch), jcfg.SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal(arch):
    want, got = jcfg.get_config(arch), tcfg.get_config(arch)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert tt.count_params(got, active_only=True) == jt.count_params(want, active_only=True)
    red_w, red_g = jcfg.reduced_config(want), tcfg.reduced_config(got)
    assert tt.count_params(red_g) == jt.count_params(red_w)
    assert tt.count_params(red_g, active_only=True) == jt.count_params(red_w, active_only=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal(arch):
    """Every leaf: the same path, shape, logical axes and init rule."""
    for want_cfg, got_cfg in ((jcfg.get_config(arch), tcfg.get_config(arch)),
                              (jcfg.reduced_config(jcfg.get_config(arch)),
                               tcfg.reduced_config(tcfg.get_config(arch)))):
        want = _ref_specs(jt.param_specs(want_cfg))
        got = dict(iter_specs(tt.param_specs(got_cfg)))
        assert list(got) == sorted(want)
        for path, spec in got.items():
            ref = want[path]
            assert (spec.shape, spec.axes, spec.init, spec.scale) == (
                ref.shape, ref.axes, ref.init, ref.scale), path


def test_factor_pattern_equal():
    rng = np.random.default_rng(0)
    kinds = ("dense", "moe", "mamba2", "zamba_attn", "mlstm", "slstm")
    for _ in range(300):
        period = tuple(rng.choice(kinds, size=rng.integers(1, 9)))
        reps = int(rng.integers(1, 7))
        tail = (str(rng.choice(kinds)),) * int(rng.integers(0, 4))
        types = tuple(map(str, period)) * reps + tail
        if rng.random() < 0.3:  # arbitrary sequences too
            types = tuple(map(str, rng.choice(kinds, size=rng.integers(1, 30))))
        want, got = jt.factor_pattern(types), tt.factor_pattern(types)
        assert (got.period, got.num_periods, got.tail) == (
            want.period, want.num_periods, want.tail)
        assert got.period * got.num_periods + got.tail == types


@pytest.mark.parametrize("arch", ARCHS)
def test_costs_equal(arch):
    want_cfg, got_cfg = jcfg.get_config(arch), tcfg.get_config(arch)

    def close(got, want):
        assert got == pytest.approx(want, rel=1e-12, abs=0)

    for b, s in ((1, 1), (4, 128), (32, 4096)):
        for mode in ("train", "prefill", "decode"):
            close(tcosts.forward_flops(got_cfg, b, s, mode),
                  jcosts.forward_flops(want_cfg, b, s, mode))
        close(tcosts.forward_flops(got_cfg, b, 1, "decode", s_ctx=s),
              jcosts.forward_flops(want_cfg, b, 1, "decode", s_ctx=s))
        for active in (True, False):
            close(tcosts.model_flops_6nd(got_cfg, b, s, active),
                  jcosts.model_flops_6nd(want_cfg, b, s, active))
    meshes = ((1, {}), (256, {"data": 16, "model": 16}), (512, {"pod": 2, "data": 16, "model": 16}))
    for name in jcfg.SHAPES:
        for devices, mesh in meshes:
            for remat in (True, False):
                got = tcosts.step_cost(got_cfg, tcfg.SHAPES[name], devices, mesh, remat)
                want = jcosts.step_cost(want_cfg, jcfg.SHAPES[name], devices, mesh, remat)
                for field in ("flops", "hbm_bytes", "coll_bytes"):
                    close(getattr(got, field), getattr(want, field))
                assert set(got.notes) == set(want.notes)
                for key, value in want.notes.items():
                    close(got.notes[key], value)


def test_cache_bytes_count_bf16_as_two_and_every_other_type_as_four():
    """The reference's rule, fp8 included (its byte count is a property of
    the cost model, not of the dtype)."""
    for arch in ("granite-3-2b", "deepseek-v2-236b", "zamba2-7b", "xlstm-1.3b",
                 "whisper-small", "llama-3.2-vision-90b"):
        cfg = tcfg.get_config(arch)
        assert tcosts._cache_bytes_global(cfg, 2, 64) == jcosts._cache_bytes_global(
            jcfg.get_config(arch), 2, 64)
    fp8 = dataclasses.replace(tcfg.get_config("granite-3-2b"), cache_dtype="float8_e4m3fn")
    ref8 = dataclasses.replace(jcfg.get_config("granite-3-2b"), cache_dtype="float8_e4m3fn")
    assert tcosts._cache_bytes_global(fp8, 2, 64) == jcosts._cache_bytes_global(ref8, 2, 64)


def test_roofline_reads_the_h100_constants():
    assert (tcosts.PEAK_FLOPS, tcosts.PEAK_FLOPS_F32, tcosts.HBM_BW, tcosts.LINK_BW) == (
        989e12, 67e12, 3.35e12, 450e9)
    assert tcosts.PEAK_FLOPS_BY_TYPE == {"float32": 67e12, "float64": 67e12,
                                         "bfloat16": 989e12, "float32_3xtf32": 165e12}
    cost = tcosts.StepCost(flops=4 * 989e12, hbm_bytes=3.35e12, coll_bytes=450e9 / 2, notes={})
    terms = tcosts.roofline_terms(cost, 2)
    assert terms["compute_s"] == pytest.approx(2.0)
    assert terms["memory_s"] == pytest.approx(1.0)
    assert terms["collective_s"] == pytest.approx(0.5)
    assert terms["dominant"] == "compute" and terms["roofline_fraction"] == pytest.approx(1.0)
    # the full-width granite-3-2b serving bounds the card run prints
    cfg = tcfg.get_config("granite-3-2b")
    assert cfg.param_count() == 2_534_049_792
    assert cfg.param_count() * 4 / tcosts.HBM_BW == pytest.approx(3.0257e-3, rel=1e-4)
    flops = tcosts.forward_flops(cfg, 4, 128, "prefill")
    assert math.isclose(flops, jcosts.forward_flops(jcfg.get_config("granite-3-2b"), 4, 128,
                                                    "prefill"), rel_tol=1e-12)
    assert 2.4e12 < flops < 2.8e12
