"""The multi-device path on several ranks: 4 ``gloo`` ranks on the CPU,
spawned once for the module through the port's own launcher
(``run_ranks(run_commands, 4, ...)``), each running the command lines'
rank bodies in turn; rank 0 writes each run's record and solution to an
``.npz``, which the tests compare here:

  * ``launch.solve --mode matfree --mesh 4`` (direct and PCG Gram solvers):
    x within 1e-5·max|x| of the port's unsharded solver and 1e-4·max|x| of
    the JAX package's single-host solver; every rank holds at most 1.15/4 of
    the unsharded solver's bytes, and the ranks together hold exactly them;
    the audited epoch pays the JAX package's collectives;
  * ``launch.sharded_solve`` on ``("data",) = 4``: synchronous (x at 1e-5 of
    the single-host dapc), straggling (the reference's convergence gates;
    every rank draws a different drop mask) and bf16-delta; and on a
    (2, 2) ``("data", "model")`` mesh, the 2-D TSQR solver at 1e-4;
  * ``launch.serve_solver --mesh 2`` to its end under a fault plan: rank 0
    serves, rank 1 follows its prepares and solves.
"""
import json

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import dapc as jdapc
from repro.core import partition_system as jpartition
from repro.obs import convergence as jconv
from repro.sparse import make_problem as jmake_problem
from repro_torch.core import prepare
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve_solver
from repro_torch.sparse import make_problem

N, K = 256, 4
MATFREE = ["--n", str(N), "--m", str(N), "--blocks", "8", "--mode", "matfree",
           "--rhs", str(K), "--epochs", "120", "--gamma", "2.0", "--eta", "1.9",
           "--mesh", "4", "--audit", "--device", "cpu"]
DENSE = ["--n", "64", "--m", "256", "--blocks", "8", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small solves of many tiny ops: one intra-op thread (also for the
    spawned ranks, which split the launcher's) keeps them fast when
    parallel test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    commands = {
        "direct": ("repro_torch.launch.solve", MATFREE + ["--gram-solver", "direct"]),
        "pcg": ("repro_torch.launch.solve", MATFREE + ["--gram-solver", "pcg"]),
        "sync": ("repro_torch.launch.sharded_solve", DENSE + ["--mesh", "4", "--epochs", "250"]),
        "straggler": ("repro_torch.launch.sharded_solve",
                      DENSE + ["--mesh", "4", "--epochs", "250", "--straggler", "0.3"]),
        "bf16": ("repro_torch.launch.sharded_solve",
                 DENSE + ["--mesh", "4", "--epochs", "150", "--rhs", "4",
                          "--compress", "bf16_delta"]),
        "2d": ("repro_torch.launch.sharded_solve",
               DENSE + ["--mesh", "2", "--model", "2", "--epochs", "120", "--rhs", "4"]),
    }
    todo = [(module, argv + ["--out", str(out / f"{key}.npz")])
            for key, (module, argv) in commands.items()]
    tmesh.run_ranks(tmesh.run_commands, 4, "gloo", "cpu", (todo,))
    loaded = {}
    for key in commands:
        with np.load(out / f"{key}.npz") as z:
            loaded[key] = {name: z[name] for name in z.files}
        loaded[key]["record"] = json.loads(str(loaded[key]["record"]))
    return loaded


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("gram_solver", ["direct", "pcg"])
def test_matfree_on_4_ranks(runs, gram_solver):
    run = runs[gram_solver]
    record = run["record"]
    assert record["path"] == "matfree_sharded" and record["mesh_devices"] == 4
    assert record["backend"] == "gloo" and len(record["ranks"]) == 4
    prob = make_problem(n=N, m=N, seed=0, dtype=np.float32)
    xs = np.random.default_rng(1).standard_normal((N, K)).astype(np.float32)
    B = prob.A @ xs
    single = prepare(prob.coo, mode="matfree", num_blocks=8, gram_solver=gram_solver,
                     gamma=2.0, eta=1.9, device="cpu")
    want = single.solve(B, num_epochs=120)
    assert _rel(run["x"], want.x) <= 1e-5
    np.testing.assert_allclose(run["residual_sq"], want.history["residual_sq"], rtol=1e-3,
                               atol=1e-9 * float(np.max(np.sum(B.astype(np.float64) ** 2, 0))))
    jprob = jmake_problem(n=N, m=N, seed=0, dtype=np.float32)
    ref = jcore.prepare(jprob.coo, mode="matfree", num_blocks=8, gram_solver=gram_solver)
    assert _rel(run["x"], np.asarray(ref.solve(B, num_epochs=120, gamma=2.0, eta=1.9).x)) <= 1e-4
    # one contiguous group of J/D blocks per rank: ~1/4 of the bytes each
    per_rank = [r["device_bytes"] for r in record["ranks"]]
    assert max(per_rank) <= 1.15 / 4 * single.memory_bytes
    assert sum(per_rank) == single.memory_bytes
    assert record["per_device_mb"] == round(max(per_rank) / 1e6, 3)
    # every rank's epoch pays the JAX package's collectives
    jsh = jcore.prepare(jprob.coo, mode="matfree", num_blocks=8, mesh=jax.make_mesh((1,), ("data",)),
                        gram_solver=gram_solver)
    for tag, tol in (("audit", None), ("audit_tol", 1.0)):
        want_audit = jconv.audit_epoch_collectives(jsh, B, num_epochs=4, tol=tol)
        for r in record["ranks"]:
            assert r[tag] == {"ops": want_audit["ops"], "payload_elems": want_audit["payload_elems"]}
    assert record["ranks"][0]["audit"]["payload_elems"] == N * K + (gram_solver == "pcg") * K


def _single_host(epochs, rhs=None):
    prob = jmake_problem(n=64, m=256, seed=0, dtype=np.float32)
    if rhs is None:
        b, ref = prob.b, prob.x_true
    else:
        ref = np.random.default_rng(1).standard_normal((64, rhs)).astype(np.float32)
        b = prob.A @ ref
    part = jpartition(prob.A, b, 8)
    x, _ = jdapc.solve_dapc(part, 1.0, 0.9, epochs, materialize_p=False)
    return np.asarray(x), ref


def test_dense_sharded_on_4_ranks(runs):
    run = runs["sync"]
    assert run["record"]["mesh"] == [4, 1] and len(run["record"]["ranks"]) == 4
    x, ref = _single_host(250)
    np.testing.assert_allclose(run["x"], x, atol=1e-5)
    assert run["record"]["final_mse_max"] < 1e-9


def test_straggler_on_4_ranks(runs):
    run, sync = runs["straggler"], runs["sync"]
    assert float(run["mse"][-1]) < 1e-7
    assert float(sync["mse"][60]) <= float(run["mse"][60]) * 1.01
    masks = run["masks"]  # (ranks, epochs, local blocks): True = published
    assert masks.shape == (4, 250, 2)
    assert 0 < sum(r["dropped"] for r in run["record"]["ranks"]) < masks.size
    for i in range(4):
        for j in range(i + 1, 4):
            assert not np.array_equal(masks[i], masks[j]), (i, j)


def test_bf16_delta_on_4_ranks(runs):
    x, _ = _single_host(150, rhs=4)
    np.testing.assert_allclose(runs["bf16"]["x"], x, atol=1e-4)


def test_2d_on_2x2_mesh(runs):
    run = runs["2d"]
    assert run["record"]["mesh"] == [2, 2]
    assert sorted(map(tuple, (r["coords"] for r in run["record"]["ranks"]))) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    x, ref = _single_host(120, rhs=4)
    np.testing.assert_allclose(run["x"], x, atol=1e-4)
    assert run["record"]["final_mse_max"] < 1e-9


def test_serve_solver_mesh_to_its_end(tmp_path, capfd):
    """Rank 0 serves a Poisson replay through the sharded solver, rank 1
    follows; a one-shot injected solve error and a NaN-poisoned request on
    rank 0 leave no follower waiting in a collective."""
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"seed": 0, "rules": [
        {"site": "solve", "kind": "error", "times": 1, "after": 1},
        {"site": "solve", "kind": "nan", "request": 5},
    ]}))
    serve_solver.main(["--n", "96", "--m", "96", "--num-blocks", "8", "--mode", "matfree",
                       "--epochs", "40", "--requests", "12", "--rate", "400", "--max-batch", "4",
                       "--tol", "10", "--mesh", "2", "--device", "cpu",
                       "--fault-plan", str(plan)])
    out = capfd.readouterr().out.splitlines()
    assert any(line.startswith("replayed 12 requests") for line in out), out
    assert any("path=matfree_sharded" in line for line in out), out
    mesh = json.loads(next(line for line in out if line.startswith("mesh: "))[6:])
    assert mesh["ranks"] == 2 and mesh["backend"] == "gloo"
    assert mesh["answered"] == 11 and mesh["failed"] == 1  # the poisoned request
    assert mesh["worst_rel_diff_vs_direct"] <= 2.5e-4
    assert any(line.startswith("faults: 1/12 requests failed") for line in out), out
