"""Factor checkpoints across the two packages, and the port's own store
against ``tests/test_serving_qos.py``'s checkpoint cases.

One directory serves both packages: ``matrix_fingerprint`` and
``prepare_key`` are the reference's, the format is the reference's
(``FORMAT_VERSION`` 2), and ``device`` places a state without entering its
key. So a store the JAX package's ``CheckpointStore`` wrote (dense QR,
matrix-free with the direct and the PCG Gram solver) restores through the
port's store and pool without a ``prepare`` and solves to the reference's
answer at 1e-4; the port's store restores in the reference the same way.
Within the port, a restore solves bit for bit as the solver it saved.

Small sizes: n = 64, m = 256 dense; n = 192 at 99.8% sparsity matrix-free.
"""
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.serving import checkpoint as jcheckpoint
from repro.serving import queue as jqueue
from repro.sparse import matrix as jmatrix
from repro_torch.core import prepare
from repro_torch.serving import checkpoint as tcheckpoint
from repro_torch.serving.checkpoint import FORMAT_VERSION, CheckpointStore, prepare_key
from repro_torch.serving.queue import PreparedPool, matrix_fingerprint
from repro_torch.sparse import generate_schenk_like, make_problem

PREP_KW = dict(num_blocks=8, materialize_p=False)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small solves of many tiny ops: one intra-op thread keeps them fast
    when parallel test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def dense_prob():
    return make_problem(n=64, m=256, seed=31, dtype=np.float32)


def _system(case):
    """(port matrix, reference matrix, prepare kwargs, a right-hand side
    batch, epochs, solve kwargs) of one checkpointed configuration."""
    if case == "dense":
        prob = make_problem(n=64, m=256, seed=31, dtype=np.float32)
        B = prob.A @ np.random.default_rng(1).standard_normal((64, 3)).astype(np.float32)
        return prob.A, prob.A, dict(PREP_KW), B, 40, {}
    coo = generate_schenk_like(192, seed=41 if case == "matfree" else 43)
    jcoo = jmatrix.COOMatrix(coo.rows, coo.cols, coo.vals, coo.shape)
    B = coo.to_dense() @ np.random.default_rng(2).standard_normal((192, 3)).astype(np.float32)
    kw = dict(mode="matfree", num_blocks=8, method="dapc")
    if case == "matfree_pcg":
        kw["gram_solver"] = "pcg"
    return coo, jcoo, kw, B, 40, dict(gamma=2.0, eta=1.9)


CASES = ["dense", "matfree", "matfree_pcg"]


def test_format_and_keys_match_the_reference():
    assert FORMAT_VERSION == jcheckpoint.FORMAT_VERSION == 2
    for kw in (PREP_KW, dict(mode="matfree", num_blocks=8, gram_solver="pcg"),
               dict(PREP_KW, use_kernels=True)):
        assert prepare_key(kw) == jcheckpoint.prepare_key(kw)
        # device places the state, it does not change it: never in the key
        assert prepare_key(dict(kw, device="cpu")) == prepare_key(kw)
        assert prepare_key(dict(kw, device="cuda")) == jcheckpoint.prepare_key(kw)
        assert prepare_key(dict(kw, mesh=None)) == prepare_key(kw)
    assert prepare_key(dict(PREP_KW, num_blocks=4)) != prepare_key(PREP_KW)


@pytest.mark.parametrize("case", CASES)
def test_reference_store_restores_in_the_port(tmp_path, case):
    """The JAX package saves; the port's pool restores (no prepare) onto
    the CPU and solves to the reference's answer."""
    A, jA, kw, B, epochs, solve_kw = _system(case)
    jprep = jcore.prepare(jA, **kw)
    fp = jqueue.matrix_fingerprint(jA)
    assert fp == matrix_fingerprint(A)
    assert jcheckpoint.CheckpointStore(tmp_path).save(fp, jprep, kw)
    pool = PreparedPool(max_size=2, checkpoint=str(tmp_path), **dict(kw, device="cpu"))
    assert pool.register(A) == fp
    prep = pool.get(fp)
    assert pool.stats.restores == 1 and pool.stats.prepares == 0
    assert prep.path == jprep.path and str(prep.device) == "cpu"
    got = prep.solve(B, num_epochs=epochs, **solve_kw)
    want = jprep.solve(B, num_epochs=epochs, **solve_kw)
    np.testing.assert_allclose(got.x, np.asarray(want.x), atol=1e-4, rtol=1e-4)
    if case == "matfree_pcg":
        assert prep.gram_solver == "pcg"
        np.testing.assert_array_equal(got.history["inner_iters"],
                                      np.asarray(want.history["inner_iters"]))


@pytest.mark.parametrize("case", CASES)
def test_port_store_restores_in_the_reference(tmp_path, case):
    A, jA, kw, B, epochs, solve_kw = _system(case)
    prep = prepare(A, **dict(kw, device="cpu"))
    fp = matrix_fingerprint(A)
    assert CheckpointStore(tmp_path).save(fp, prep, dict(kw, device="cpu"))
    store = jcheckpoint.CheckpointStore(tmp_path)
    jprep = store.load(fp, kw)
    assert jprep is not None and store.load_misses == 0 and jprep.path == prep.path
    got = prep.solve(B, num_epochs=epochs, **solve_kw)
    want = jprep.solve(B, num_epochs=epochs, **solve_kw)
    np.testing.assert_allclose(got.x, np.asarray(want.x), atol=1e-4, rtol=1e-4)


# -- the port's own round trips (tests/test_serving_qos.py) --------------------


@pytest.mark.parametrize("kw", [
    PREP_KW,
    dict(num_blocks=4, method="apc"),
    dict(num_blocks=4, method="dgd"),
    dict(num_blocks=4, method="cgnr"),
    dict(mode="matfree", num_blocks=8, method="dapc"),
    dict(mode="matfree", num_blocks=8, method="dapc", gram_solver="pcg"),
], ids=["dense_qr", "apc", "dgd", "cgnr", "matfree", "matfree_pcg"])
def test_checkpoint_roundtrip_is_bit_identical(tmp_path, dense_prob, kw):
    if kw.get("mode") == "matfree":
        A = generate_schenk_like(192, seed=41)
        b = A.to_dense() @ np.ones(192, np.float32)
    else:
        A, b = dense_prob.A, dense_prob.b
    kw = dict(kw, device="cpu")
    store = CheckpointStore(tmp_path)
    prep = prepare(A, **kw)
    fp = matrix_fingerprint(A)
    assert store.save(fp, prep, kw) and fp in store
    restored = store.load(fp, kw)
    assert type(restored) is type(prep) and str(restored.device) == "cpu"
    ref, got = prep.solve(b, num_epochs=20), restored.solve(b, num_epochs=20)
    assert np.array_equal(ref.x, got.x)
    for key, h in ref.history.items():
        assert np.array_equal(np.asarray(h), np.asarray(got.history[key]))
    assert restored.memory_bytes == prep.memory_bytes


def test_checkpoint_misses_are_safe(tmp_path, dense_prob):
    kw = dict(PREP_KW, device="cpu")
    store = CheckpointStore(tmp_path)
    prep = prepare(dense_prob.A, **kw)
    fp = matrix_fingerprint(dense_prob.A)
    assert store.load(fp, kw) is None
    assert store.save(fp, prep, kw)
    assert store.load(fp, dict(kw, num_blocks=4)) is None
    assert store.load(fp, {**kw, "mesh": object()}) is None
    assert not store.save(fp, prep, {**kw, "mesh": object()})
    store.path(fp).write_bytes(b"not an npz file at all")
    assert store.load(fp, kw) is None
    assert store.load_misses >= 2
    assert store.save(fp, prep, kw) and store.load(fp, kw) is not None
    assert tcheckpoint._solver_class("sharded") is None
