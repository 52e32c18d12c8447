"""The harness's ``"coo"`` form on the CPU: a square sparse configuration
reaches the program as its ``COOMatrix``, is prepared on the matrix-free
path and never densified, and its runs are judged by the test reference;
the dense form's inputs stay those of the benchmark's cells, to the bit."""
import hashlib
import json
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.harness import cell as cell_mod
from perfbench.harness import problem
from perfbench.tests import matfree_ref, tiny

SEED = 2 ** 33 + 23  # seeds run beyond 32 bits; tiny.COO_CONFIG's matrix_seed too
MF2327 = Path(__file__).resolve().parent / "mf2327.json"


@pytest.fixture(autouse=True)
def route_the_test_reference(monkeypatch):
    """``"reference": "matfree_ref"`` names the test reference beside this
    file; every other name is the benchmark's own."""
    real = cell_mod.load_reference
    monkeypatch.setattr(cell_mod, "load_reference",
                        lambda config: matfree_ref if config["reference"] == "matfree_ref"
                        else real(config))


def _run(kind, trace=False, seconds=0.6):
    return cell_mod.run_cell(tiny.cell(kind, tiny.COO_CONFIG), SEED, seconds, trace, "cpu",
                             time.perf_counter())


@pytest.mark.parametrize("kind", ["closed", "tol", "served"])
def test_coo_sound_run_is_correct(kind):
    out = _run(kind)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    want = {"x_gap", "resid_gap"} | ({"stop_gap"} if kind != "closed" else set())
    assert set(out["compared"]) == want
    for c in out["compared"].values():
        assert 0.0 <= c["value"] <= c["limit"]
    e2e = "served_p95_ms" if kind == "served" else "solve_ms"
    assert {e2e, "peak_mem_gb", "setup_s"} <= set(out["metrics"])


def _perturb(monkeypatch):
    """One answer of every solve changed where it is produced."""
    from repro_torch.core import matfree

    orig = matfree.MatrixFreePreparedSolver.solve

    def solve(self, b, *args, **kwargs):
        res = orig(self, b, *args, **kwargs)
        x = np.array(res.x, copy=True)
        col = x if x.ndim == 1 else x[:, 0]
        col[0] += 0.01 * np.linalg.norm(col)
        return matfree.dataclasses.replace(res, x=x)

    monkeypatch.setattr(matfree.MatrixFreePreparedSolver, "solve", solve)


@pytest.mark.parametrize("kind", ["closed", "served"])
def test_coo_perturbed_answer_is_not_correct(monkeypatch, kind):
    _perturb(monkeypatch)
    out = _run(kind)
    assert out["correct"] is False, out["compared"]
    assert out["compared"]["x_gap"]["value"] > out["compared"]["x_gap"]["limit"]


def test_coo_run_allocates_no_dense_matrix(monkeypatch):
    """Neither the harness nor the program densifies the matrix: the dense
    builders raise, and the program is handed its COOMatrix and prepares the
    matrix-free solver."""
    from repro_torch.core import prepared
    from repro_torch.sparse.matrix import COOMatrix

    def refuse(*args, **kwargs):
        raise AssertionError("densified")

    for owner, name in ((problem, "dense_core"), (problem, "augment"),
                        (COOMatrix, "to_dense"), (COOMatrix, "row_block")):
        monkeypatch.setattr(owner, name, refuse)
    seen = []
    real_prepare = prepared.prepare

    def prepare(A, *args, **kwargs):
        prep = real_prepare(A, *args, **kwargs)
        seen.append((type(A).__name__, prep.path))
        return prep

    monkeypatch.setattr("repro_torch.core.prepare", prepare)
    out = _run("closed")
    assert out["correct"] is True
    assert seen == [("COOMatrix", "matfree")]


def test_coo_readers_of_dense_counts_read_none():
    """A traced matrix-free run reports the cell's other per-layer metrics
    and none of those computed from the dense solver's counts."""
    c = tiny.cell("closed", tiny.COO_CONFIG)
    dense_counts = ["consensus_update_roofline.solve", "trisolve_roofline.solve", "mfu.solve",
                    "update_calls_per_solve"]
    c.per_layer = ["prepare_s", "idle_share.solve"] + dense_counts
    c.units.update({n: "u" for n in c.per_layer})
    out = cell_mod.run_cell(c, SEED, 1.0, True, "cpu", time.perf_counter())
    assert out["correct"] is True
    assert "prepare_s" in out["metrics"]
    assert not set(dense_counts) & set(out["metrics"])


def _trace(kernels):
    return types.SimpleNamespace(
        count=lambda name: kernels.get(name, (0, 0.0))[0],
        device_seconds=lambda name: kernels.get(name, (0, 0.0))[1])


@pytest.mark.parametrize("name", ["consensus_update_roofline.solve",
                                  "trisolve_roofline.solve", "mfu.solve",
                                  "update_calls_per_solve"])
def test_dense_count_readers_follow_the_path(name):
    """The same context reads a number on the dense path and None on the
    matrix-free one."""
    window = types.SimpleNamespace(latencies_ms=None, clean_solves=2, clean_seconds=0.1,
                                   needed_epochs=[80, 80], traced_solves=1)
    trace = _trace({"wv_kernel": (80, 0.004), "update_kernel": (80, 0.008),
                    "trisolve_kernel": (1, 0.001)})
    ctx = types.SimpleNamespace(window=window, trace=trace, J=8, p=1164, n=2327, k=32,
                                path="dense")
    read = cell_mod.reader("metrics", name)
    assert read(ctx) > 0
    ctx.path = "matfree"
    assert read(ctx) is None


def test_solve_shape_knows_both_solvers():
    from repro_torch.core import prepare

    s = problem.make_system(tiny.COO_CONFIG["problem"], SEED, "cpu")
    A = cell_mod.program_matrix(s.host())
    kw = {**tiny.COO_CONFIG["prepare"], "device": "cpu"}
    mf = prepare(A, **kw)
    assert mf.path == "matfree" and not hasattr(mf, "blocks")
    assert cell_mod.solve_shape(mf) == (8, 32, 256)
    dense = prepare(A.to_dense(), **{**kw, "mode": "wide", "materialize_p": False})
    assert dense.path == "dense"
    assert cell_mod.solve_shape(dense) == tuple(dense.blocks.shape)


def test_coo_form_is_the_dense_forms_core():
    """The coordinates are the square dense form's A, and B = A·X from the
    sparse product is the dense product's, up to the order of its sums."""
    p = dict(tiny.COO_CONFIG["problem"])
    assert p.pop("matrix_seed") == SEED
    coo = problem.make_system({**p, "matrix_seed": SEED}, SEED, "cpu")
    dense = problem.make_system({**p, "form": "dense"}, SEED, "cpu")
    c = coo.A
    assert isinstance(c, problem.Coords) and c.vals.dtype == np.float32
    got = np.zeros(c.shape, np.float32)
    got[c.rows, c.cols] = c.vals
    np.testing.assert_array_equal(got, dense.A.numpy())
    for purpose in (0, 200):
        np.testing.assert_allclose(coo.rhs(4, purpose).numpy(),
                                   dense.rhs(4, purpose).numpy(), rtol=1e-6, atol=1e-4)
    assert torch.equal(coo.rhs(4, 0), coo.rhs(4, 0))


def test_coo_form_needs_a_square_matrix():
    p = {**tiny.COO_CONFIG["problem"], "m": 300}
    with pytest.raises(ValueError, match="m = n"):
        problem.make_system(p, 0, "cpu")
    with pytest.raises(ValueError, match="form"):
        problem.make_system({**p, "form": "csr"}, 0, "cpu")


def _coo_problem(matrix_seed=SEED) -> dict:
    return {**tiny.COO_CONFIG["problem"], "matrix_seed": matrix_seed}


def _same_coords(a, b) -> bool:
    return a.shape == b.shape and all(np.array_equal(getattr(a, f), getattr(b, f))
                                      for f in ("rows", "cols", "vals"))


def test_coo_matrix_follows_its_matrix_seed_and_the_rhs_the_run_seed():
    """Two run seeds under one matrix_seed solve one matrix with their own
    right-hand sides; another matrix_seed draws another matrix."""
    a, b = (problem.make_system(_coo_problem(), s, "cpu") for s in (SEED, SEED + 1))
    assert (a.seed, b.seed) == (SEED, SEED + 1)
    assert _same_coords(a.A, b.A)
    assert not torch.equal(a.rhs(4, 0), b.rhs(4, 0))
    other = problem.make_system(_coo_problem(SEED + 1), SEED, "cpu")
    assert not _same_coords(a.A, other.A)


# sha256 (first 16 hex digits) of the "coo" form's rows, cols and vals and of
# rhs(4, 0) for tiny.COO_CONFIG's problem, as the generator drew them from the
# run's seed alone before a coo problem named its matrix_seed
COO_DIGESTS = {
    SEED: (("d86a7e7c1309d5fd", "94ebddab16926e92", "c562eb5aec5c2e28"), "e4ba056981882c46"),
    5: (("6fe4892f999c1d6e", "7a063d9d4264d131", "0119a20ea0b69221"), "748c81b4b48ac485"),
}


def _digest(a) -> str:
    a = a.numpy() if isinstance(a, torch.Tensor) else a
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("seed", sorted(COO_DIGESTS))
def test_coo_matrix_seed_equal_to_the_run_seed_draws_the_former_system(seed):
    s = problem.make_system(_coo_problem(seed), seed, "cpu")
    got = tuple(_digest(getattr(s.A, f)) for f in ("rows", "cols", "vals"))
    assert (got, _digest(s.rhs(4, 0))) == COO_DIGESTS[seed]


_MISSING = object()


@pytest.mark.parametrize("matrix_seed", [_MISSING, None, -1, 1.5, "7", True],
                         ids=["missing", "none", "negative", "float", "str", "bool"])
def test_coo_problem_must_name_its_matrix(matrix_seed):
    p = dict(tiny.COO_CONFIG["problem"])
    del p["matrix_seed"]
    if matrix_seed is not _MISSING:
        p["matrix_seed"] = matrix_seed
    with pytest.raises(ValueError, match="matrix_seed"):
        problem.make_system(p, SEED, "cpu")


def test_dense_problem_takes_no_matrix_seed():
    with pytest.raises(ValueError, match="matrix_seed"):
        problem.make_system({**tiny.CONFIG["problem"], "matrix_seed": 0}, 0, "cpu")


def test_mf2327_prepared_bytes_repeat_across_run_seeds():
    """The matrix-free solver's bytes follow the sparsity pattern (its ELL
    width, the transposed shards, the Gram inverses). At the card
    configuration's size, three run seeds under its matrix_seed prepare
    the same bytes; each drawn from its run's seed, the three read
    11.89-12.27 MB."""
    from repro_torch.core import prepare

    config = json.loads(MF2327.read_text())["config"]
    kw = {**config["prepare"], "device": "cpu"}
    read = []
    for seed in (2900000901, 2900000902, 2900000903):
        s = problem.make_system(config["problem"], seed, "cpu")
        read.append(prepare(cell_mod.program_matrix(s.host()), **kw).memory_bytes)
    assert read == [read[0]] * 3, read


# sha256 (first 16 hex digits) of the dense form's A, B = rhs(4, 0) and
# rhs(3, 200) for tiny.CONFIG, as the generator made them before the "coo"
# form was added: the benchmark's cells receive the same inputs
DIGESTS = {
    0: ("a5fe4371581cf1ea", "8001afbfd02efb9e", "180f81a774db1bb1"),
    1: ("2e1813e375bd7e73", "44550c14b0029f08", "cc83b753bff49f37"),
    2: ("afd8b8612348df89", "09fb12248f6e4fbf", "270f074bf14204b0"),
}


@pytest.mark.parametrize("seed", sorted(DIGESTS))
def test_dense_form_inputs_are_unchanged(seed):
    def digest(t):
        return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]

    s = problem.make_system(tiny.CONFIG["problem"], seed, "cpu")
    assert s.A.dtype == torch.float32
    assert (digest(s.A), digest(s.rhs(4, 0)), digest(s.rhs(3, 200))) == DIGESTS[seed]


def test_matfree_reference_converges_to_the_solution():
    """On a small square well-conditioned sparse system the reference's
    consensus, over the matrix-free solver's row blocks (the last one
    short), reaches the float64 solution, and its residual falls to
    rounding."""
    rng = np.random.default_rng(7)
    n = 48
    A = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.2) + 8.0 * np.eye(n)
    rows, cols = np.nonzero(A)
    coords = types.SimpleNamespace(rows=rows, cols=cols, vals=A[rows, cols], shape=(n, n))
    X = rng.standard_normal((n, 3))
    ref = matfree_ref.MatfreeReference(coords, 5, 1.0, 0.9)
    hist, x = ref.run(A @ X, 600)
    assert np.abs(x.numpy() - X).max() < 1e-9
    h = hist.numpy()
    assert (h[-1] / h[0]).max() < 1e-20
    assert ref.bounds == [(0, 10), (10, 20), (20, 30), (30, 40), (40, 48)]
