"""The port's training substrate (``repro_torch.training``,
``repro_torch.distributed``): the eleven tests of the JAX package's
``tests/test_training.py`` on the port, plus cross-package cases on the
CPU, inputs made by numpy from a seed:

- ``lr_at`` and one ``adamw_update`` on equal grads: 1e-6 relative;
- ``compress_tree`` on equal input: equal int8 codes and scales;
- a train checkpoint the JAX package wrote restores in the port, and one
  the port wrote restores in the JAX package, bit for bit;
- the exact-restart test holds equal bits (the reference's holds 1e-6);
- the whole train state of reduced deepseek-moe-16b round-trips a
  checkpoint (``tests/test_model_properties.py``'s case).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.distributed import compression as jcompression
from repro.training import checkpoint as jckpt
from repro.training import data as jdata
from repro.training import train_loop as jtl
from repro.training.optimizer import OptConfig as JOptConfig
from repro.training.optimizer import adamw_update as j_adamw
from repro.training.optimizer import init_opt_state as j_init_opt
from repro.training.optimizer import lr_at as j_lr_at

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import compression
from repro_torch.models.convert import load_reference
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.checkpoint import flatten
from repro_torch.training import data as data_lib
from repro_torch.training import train_loop
from repro_torch.training.optimizer import OptConfig, adamw_update, init_opt_state, lr_at

from test_torch_train_parity import TINY, reference_batches


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small ops: one intra-op thread keeps them fast when parallel
    test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tiny_cfg(**kw):
    return ModelConfig(**{**TINY, **kw})


def trees_equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert set(fa) == set(fb)
    for key in fa:
        x, y = np.asarray(fa[key]), np.asarray(fb[key])
        assert x.dtype == y.dtype and x.shape == y.shape, key
        np.testing.assert_array_equal(x, y, err_msg=key)


# -- the reference's eleven tests, on the port --------------------------------


def test_lr_schedule():
    oc = OptConfig(learning_rate=1.0, warmup_steps=10, total_steps=100)
    assert float(lr_at(oc, 0)) == 0.0
    assert abs(float(lr_at(oc, 10)) - 1.0) < 1e-6
    assert float(lr_at(oc, 100)) == pytest.approx(oc.min_lr_ratio, rel=1e-5)


def test_adamw_moves_params_and_clips():
    params = {"w": torch.ones((4, 4))}
    grads = {"w": 100.0 * torch.ones((4, 4))}
    oc = OptConfig(grad_clip=1.0, warmup_steps=0, learning_rate=1e-2)
    state = init_opt_state(params)
    new_p, new_s, m = adamw_update(oc, params, grads, state)
    assert float(m["grad_norm"]) == pytest.approx(400.0)
    assert not np.allclose(new_p["w"].numpy(), 1.0)
    assert int(new_s["step"]) == 1


def test_data_deterministic_and_shaped():
    dc = data_lib.DataConfig(vocab_size=64, seq_len=16, global_batch=4, seed=3)
    b1, b2 = data_lib.make_batch(dc, 7, "cpu"), data_lib.make_batch(dc, 7, "cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    b3 = data_lib.make_batch(dc, 8, "cpu")
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert tuple(b1["tokens"].shape) == (4, 16)
    assert int(b1["tokens"].max()) < 64
    assert torch.equal(b1["targets"][:, :-1], b1["tokens"][:, 1:])
    it = data_lib.host_iterator(dc, start_step=7, device="cpu")
    assert torch.equal(next(it)["tokens"], b1["tokens"])
    assert torch.equal(next(it)["tokens"], b3["tokens"])


def test_loss_decreases(monkeypatch):
    """The reference's gate (the last logged loss 0.3 below the first) on
    the reference's weights and batches, where the port's trajectory is the
    reference's (``test_torch_train_parity``); then on the port's own draws,
    where single-batch losses are noisier than the gate (seed 0: 3.799 at
    step 10, 3.544 at 100), the mean of the last ten steps' losses 0.3 below
    the first ten's (3.954 to 3.602; the reference's own draws: 3.952 to
    3.623)."""
    cfg = tiny_cfg()
    opt = OptConfig(learning_rate=1e-2, warmup_steps=5, total_steps=100)
    own = data_lib.DataConfig(cfg.vocab_size, 16, 8, seed=0, repeat_prob=0.75)
    _, hist = train_loop.train(cfg, train_loop.TrainConfig(opt=opt, num_steps=100, log_every=1),
                               own, device="cpu")
    losses = np.array([h["loss"] for h in hist])
    assert losses[-10:].mean() < losses[:10].mean() - 0.3, losses

    tcfg = train_loop.TrainConfig(opt=opt, num_steps=100, log_every=10)
    state = train_loop.init_state(cfg, torch.Generator().manual_seed(0), tcfg)
    jcfg = JModelConfig(**TINY)
    init = jtl.init_state(jcfg, jax.random.PRNGKey(0), jtl.TrainConfig())
    load_reference(state["params"], jax.tree.map(np.asarray, init["params"]))
    reference_batches(monkeypatch, jdata.DataConfig(cfg.vocab_size, 16, 8, seed=0,
                                                    repeat_prob=0.75))
    _, hist = train_loop.train(cfg, tcfg, None, state=state)
    first, last = hist[0]["loss"], hist[-1]["loss"]
    assert last < first - 0.3, (first, last)


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.int32)}}
    ckpt_lib.save(str(tmp_path), 5, tree)
    assert ckpt_lib.latest_step(str(tmp_path)) == 5
    like = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4, dtype=torch.int32)}}
    back = ckpt_lib.restore(str(tmp_path), 5, like, device="cpu")
    assert torch.equal(back["a"], tree["a"]) and torch.equal(back["b"]["c"], tree["b"]["c"])


def test_checkpoint_retention_and_atomicity(tmp_path):
    tree = {"a": torch.ones((2,))}
    for s in (1, 2, 3, 4):
        ckpt_lib.save(str(tmp_path), s, tree, keep=2)
    assert ckpt_lib.all_steps(str(tmp_path)) == [3, 4]
    # a partial dir without manifest must be ignored
    os.makedirs(tmp_path / "step_99")
    assert ckpt_lib.latest_step(str(tmp_path)) == 4
    assert not any(name.startswith(".tmp") for name in os.listdir(tmp_path))


def test_failure_restart_is_exact(tmp_path):
    """Crash at step 7, restart, and the final state must equal an
    uninterrupted run's bit for bit (deterministic data, exact restore)."""
    cfg = tiny_cfg()
    opt = OptConfig(learning_rate=1e-3, warmup_steps=2, total_steps=12)
    dcfg = data_lib.DataConfig(cfg.vocab_size, 16, 4, seed=1)

    t_plain = train_loop.TrainConfig(opt=opt, num_steps=12, log_every=4)
    state_ref, hist_ref = train_loop.train(cfg, t_plain, dcfg, device="cpu")

    ck = str(tmp_path / "ck")
    t_ck = train_loop.TrainConfig(opt=opt, num_steps=12, ckpt_dir=ck, ckpt_every=5, log_every=4)
    with pytest.raises(RuntimeError, match="simulated node failure"):
        train_loop.train(cfg, t_ck, dcfg, fail_at_step=7, device="cpu")
    assert ckpt_lib.latest_step(ck) == 5
    state_resumed, hist = train_loop.train(cfg, t_ck, dcfg, device="cpu")  # auto-resume
    trees_equal(train_loop.state_tree(state_resumed), train_loop.state_tree(state_ref))
    assert hist[-1]["loss"] == hist_ref[-1]["loss"]


def test_restore_onto_another_device(tmp_path):
    """``restore(..., device=)`` places every leaf on the device asked for:
    the ``meta`` device here (shapes only), the CPU with the values."""
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    ckpt_lib.save(str(tmp_path), 1, tree)
    meta = ckpt_lib.restore(str(tmp_path), 1, tree, device="meta")
    assert meta["w"].device.type == "meta" and tuple(meta["w"].shape) == (4, 4)
    back = ckpt_lib.restore(str(tmp_path), 1, tree, device="cpu")
    assert torch.equal(back["w"], tree["w"])
    with pytest.raises(ValueError, match="checkpoint shape"):
        ckpt_lib.restore(str(tmp_path), 1, {"w": torch.zeros(2, 8)}, device="cpu")


def test_compression_roundtrip_and_error_feedback():
    g = {"w": torch.tensor([[0.1, -2.0], [3.0, 0.004]])}
    res = compression.init_residuals(g)
    q, new_res = compression.compress_tree(g, res)
    deq = compression.decompress_tree(q)
    # coarse reconstruction plus residual equals original exactly
    np.testing.assert_allclose((deq["w"] + new_res["w"]).numpy(), g["w"].numpy(), atol=1e-6)
    assert q["w"][0].dtype == torch.int8


def test_compressed_training_converges():
    """int8 error-feedback compression must track the uncompressed loss
    trajectory (the reference's gate)."""
    cfg = tiny_cfg()
    opt = OptConfig(learning_rate=3e-3, warmup_steps=5, total_steps=60)
    dcfg = data_lib.DataConfig(cfg.vocab_size, 16, 8, seed=0)
    hists = {}
    for comp in (False, True):
        t_c = train_loop.TrainConfig(opt=opt, num_steps=60, compress_grads=comp, log_every=10)
        _, hists[comp] = train_loop.train(cfg, t_c, dcfg, device="cpu")
    assert hists[True][-1]["loss"] < hists[True][0]["loss"]
    assert hists[True][-1]["loss"] < hists[False][-1]["loss"] + 0.05


def test_generate_greedy():
    from repro_torch.models import transformer
    from repro_torch.serving.decode import generate

    cfg = tiny_cfg()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    prompts = torch.zeros((2, 3), dtype=torch.int64)
    out = generate(params, cfg, prompts, max_new=5)
    assert tuple(out.shape) == (2, 5)
    assert int(out.max()) < cfg.vocab_size


# -- across the packages ------------------------------------------------------


def test_lr_and_adamw_match_reference():
    oc = dict(learning_rate=3e-3, warmup_steps=5, total_steps=40, grad_clip=0.5)
    for step in (0, 3, 5, 17, 40, 55):
        assert float(lr_at(OptConfig(**oc), step)) == pytest.approx(
            float(j_lr_at(JOptConfig(**oc), step)), rel=1e-6)
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
    jstate = j_init_opt(jax.tree.map(jnp.asarray, params))
    jstate = dict(jstate, mu=jax.tree.map(lambda g: 0.3 * jnp.asarray(g), grads),
                  nu=jax.tree.map(lambda g: 0.2 * jnp.asarray(g) ** 2, grads),
                  step=jnp.int32(3))
    want_p, want_s, want_m = j_adamw(JOptConfig(**oc), jax.tree.map(jnp.asarray, params),
                                     jax.tree.map(jnp.asarray, grads), jstate)
    tp = {k: torch.as_tensor(v.copy()) for k, v in params.items()}
    tstate = {"mu": {k: torch.as_tensor(np.asarray(v)) for k, v in jstate["mu"].items()},
              "nu": {k: torch.as_tensor(np.asarray(v)) for k, v in jstate["nu"].items()},
              "step": torch.tensor(3, dtype=torch.int32)}
    got_p, got_s, got_m = adamw_update(OptConfig(**oc), tp, {k: torch.as_tensor(v) for k, v in
                                                           grads.items()}, tstate)
    assert int(got_s["step"]) == int(want_s["step"]) == 4
    for key in ("grad_norm", "lr"):
        assert float(got_m[key]) == pytest.approx(float(want_m[key]), rel=1e-6)
    for name in params:
        for got, want in ((got_p[name], want_p[name]), (got_s["mu"][name], want_s["mu"][name]),
                          (got_s["nu"][name], want_s["nu"][name])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_compress_tree_matches_reference_codes():
    rng = np.random.default_rng(1)
    grads = {"a": rng.standard_normal((8, 9)).astype(np.float32),
             "b": (1e-3 * rng.standard_normal(5)).astype(np.float32)}
    res = {k: (1e-2 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in grads.items()}
    jq, jres = jcompression.compress_tree(jax.tree.map(jnp.asarray, grads),
                                          jax.tree.map(jnp.asarray, res))
    tq, tres = compression.compress_tree({k: torch.as_tensor(v) for k, v in grads.items()},
                                         {k: torch.as_tensor(v) for k, v in res.items()})
    for name in grads:
        np.testing.assert_array_equal(tq[name][0].numpy(), np.asarray(jq[name][0]))
        assert float(tq[name][1]) == float(jq[name][1])
        np.testing.assert_array_equal(tres[name].numpy(), np.asarray(jres[name]))


def test_train_checkpoints_interchange_with_reference(tmp_path):
    """A directory the JAX package's train loop wrote resumes in the port's,
    and one the port's wrote restores in the JAX package, bit for bit, with
    the same leaf names (params, opt/mu, opt/nu, opt/step, residuals)."""
    jcfg, cfg = JModelConfig(**TINY), tiny_cfg()
    dcfg = jdata.DataConfig(64, 16, 4, seed=0)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    opt = dict(learning_rate=1e-3, warmup_steps=2, total_steps=3)
    jstate, _ = jtl.train(jcfg, jtl.TrainConfig(opt=JOptConfig(**opt), num_steps=3, ckpt_dir=jdir,
                                                compress_grads=True), dcfg)
    tcfg = train_loop.TrainConfig(opt=OptConfig(**opt), num_steps=3, ckpt_dir=tdir,
                                  compress_grads=True)
    tstate, _ = train_loop.train(cfg, tcfg, data_lib.DataConfig(64, 16, 4), device="cpu")
    with open(os.path.join(jdir, "step_3", "manifest.json")) as f:
        jnames = f.read()
    with open(os.path.join(tdir, "step_3", "manifest.json")) as f:
        tnames = f.read()
    assert jnames == tnames  # same leaves, shapes, dtypes, in the same order

    # the JAX package's checkpoint, restored by the port
    ported = train_loop.init_state(cfg, torch.Generator().manual_seed(5), tcfg)
    train_loop.load_state(ported, ckpt_lib.restore(jdir, 3, train_loop.state_tree(ported), "cpu"))
    trees_equal(train_loop.state_tree(ported), jax.tree.map(np.asarray, jstate))
    # the port's checkpoint, restored by the JAX package
    like = jtl.init_state(jcfg, jax.random.PRNGKey(1), jtl.TrainConfig(compress_grads=True))
    back = jckpt.restore(tdir, 3, like)
    trees_equal(jax.tree.map(np.asarray, back), train_loop.state_tree(tstate))


def test_full_train_state_checkpoint_roundtrip(tmp_path):
    """Checkpoint the ENTIRE train state of a reduced MoE arch (params +
    AdamW moments + step) and restore it exactly into a fresh state."""
    cfg = reduced_config(get_config("deepseek-moe-16b"))
    tcfg = train_loop.TrainConfig(opt=OptConfig(total_steps=4), num_steps=4)
    state = train_loop.init_state(cfg, torch.Generator().manual_seed(0), tcfg)
    for moment in ("mu", "nu"):  # nonzero moments, so they count
        for t_ in state["opt"][moment].values():
            t_.normal_(generator=torch.Generator().manual_seed(3))
    state["opt"]["step"].fill_(7)
    ckpt_lib.save(str(tmp_path), 1, train_loop.state_tree(state))
    fresh = train_loop.init_state(cfg, torch.Generator().manual_seed(1), tcfg)
    train_loop.load_state(fresh, ckpt_lib.restore(str(tmp_path), 1, train_loop.state_tree(fresh),
                                                  "cpu"))
    trees_equal(train_loop.state_tree(fresh), train_loop.state_tree(state))


def test_resume_restores_on_the_host_through_a_shape_only_like_tree(tmp_path, monkeypatch):
    """The loop resumes without copying the state off its device:
    ``state_like`` gives ``state_tree``'s leaves and shapes as ``meta``
    tensors, the checkpoint is restored on the host, and ``load_state``
    copies it into the live state (bit for bit)."""
    cfg = reduced_config(get_config("deepseek-moe-16b"))
    tcfg = train_loop.TrainConfig(opt=OptConfig(total_steps=4), num_steps=4, compress_grads=True)
    state = train_loop.init_state(cfg, torch.Generator().manual_seed(0), tcfg)
    like, full = flatten(train_loop.state_like(state)), flatten(train_loop.state_tree(state))
    assert set(like) == set(full)
    for key, leaf in like.items():
        assert leaf.device.type == "meta" and tuple(leaf.shape) == full[key].shape, key

    small = tiny_cfg()
    dcfg = data_lib.DataConfig(small.vocab_size, 16, 4, seed=1)
    ck = str(tmp_path / "ck")
    t_ck = train_loop.TrainConfig(opt=OptConfig(learning_rate=1e-3, warmup_steps=2, total_steps=6),
                                  num_steps=6, ckpt_dir=ck, ckpt_every=3, log_every=1)
    with pytest.raises(RuntimeError, match="simulated node failure"):
        train_loop.train(small, t_ck, dcfg, fail_at_step=4, device="cpu")
    calls, restore = [], ckpt_lib.restore

    def spy(ckpt_dir, step, like_tree, device=None):
        calls.append((step, {leaf.device.type for leaf in flatten(like_tree).values()}, device))
        return restore(ckpt_dir, step, like_tree, device)

    monkeypatch.setattr(ckpt_lib, "restore", spy)
    resumed, hist = train_loop.train(small, t_ck, dcfg, device="cpu")
    assert calls == [(3, {"meta"}, "cpu")]
    assert hist[0]["step"] == 4
    plain, _ = train_loop.train(small, dataclasses.replace(t_ck, ckpt_dir=""), dcfg, device="cpu")
    trees_equal(train_loop.state_tree(resumed), train_loop.state_tree(plain))
