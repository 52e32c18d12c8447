"""The port's examples and trace report against the JAX package's own
scripts: ``examples/{quickstart,solve_sparse,train_lm}_torch.py`` and
``tools/trace_report_torch.py`` beside ``examples/{quickstart,solve_sparse,
train_lm}.py`` and ``tools/trace_report.py``.

Each reference script runs unchanged in a child process on the CPU (its
printed lines, plus the numbers it printed at full precision). The port's
four scripts run in one child process in which ``jax``, ``jaxlib`` and
``repro`` cannot be imported, each through its ``main`` (``run`` for
train_lm, which leaves out the gate) with ``--device cpu``, where the
kernel wrappers take their plain versions. lm-100m's recipe is held step
by step at its width, cut to 2 layers. ~70–80 s on one process.
"""
import ast
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.training import checkpoint as jckpt

ROOT = Path(__file__).resolve().parent.parent

# the port's scripts run here with the packages the port must never need
# made unimportable; each entry is (label, script, function, argv) and the
# child prints {label: {"stdout", "result"}, "loaded": [...]} as JSON
PORT_CHILD = """
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None  # an import of any of them now raises ImportError
import contextlib, io, json, runpy
out = {}
for label, path, entry, argv in json.loads(sys.argv[1]):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = runpy.run_path(path)[entry](argv)
    out[label] = {"stdout": buf.getvalue(), "result": result}
out["loaded"] = sorted(m for m, mod in sys.modules.items()
                       if mod is not None and m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps(out, default=lambda v: v.tolist()))
"""

# a reference script run as ``python script argv`` in this child, which then
# prints, as its last line, the JSON of expressions evaluated in the
# script's globals (its unrounded numbers)
REFERENCE_CHILD = """
import json, runpy, sys
path, exprs, *argv = sys.argv[1:]
sys.argv = [path, *argv]
g = runpy.run_path(path, run_name="__main__")
print(json.dumps({k: eval(e, g) for k, e in json.loads(exprs).items()}))
"""


def child_env():
    # one intra-op thread: many small ops, and parallel test workers share the cores
    return {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src"),
            "OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """As in the other port tests: one intra-op thread keeps many small ops
    fast when parallel test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def run_reference(script, argv=(), exprs=None):
    """(stdout lines, the evaluated numbers) of the unchanged reference script."""
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE_CHILD, str(ROOT / script), json.dumps(exprs or {}),
         *argv],
        capture_output=True, text=True, env=child_env(), timeout=600,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    return lines[:-1], json.loads(lines[-1])


def history_lines(lines):
    return [ast.literal_eval(line) for line in lines if line.startswith("{'step'")]


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """One port serving replay exported in both formats (the sizes of
    ``test_torch_obs_serving.py``'s command-line test)."""
    from repro_torch.launch.serve_solver import main

    tmp = tmp_path_factory.mktemp("traces")
    paths = {"chrome": tmp / "serve.json", "jsonl": tmp / "serve.jsonl"}
    main(["--requests", "8", "--rate", "500", "--n", "48", "--m", "96",
          "--num-blocks", "4", "--epochs", "15", "--device", "cpu",
          "--trace-out", str(paths["chrome"]), "--trace-jsonl", str(paths["jsonl"])])
    return paths


TINY_TRAIN = ["--small", "--steps", "6", "--batch", "2", "--seq", "32"]


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory, traces):
    """The four port scripts at their smallest sizes, with ``--device cpu``,
    in one child process where jax, jaxlib and repro cannot be imported."""
    ckpt = tmp_path_factory.mktemp("port_ckpt")
    cpu = ["--device", "cpu"]
    runs = [
        ("quickstart", "examples/quickstart_torch.py", "main", cpu),
        ("quickstart_kernels", "examples/quickstart_torch.py", "main", ["--kernels", *cpu]),
        ("solve_sparse", "examples/solve_sparse_torch.py", "main", cpu),
        ("train_lm", "examples/train_lm_torch.py", "run",
         [*TINY_TRAIN, "--ckpt-dir", str(ckpt), *cpu]),
        ("train_lm_again", "examples/train_lm_torch.py", "run",
         [*TINY_TRAIN, "--ckpt-dir", str(ckpt), *cpu]),
        ("trace_report", "tools/trace_report_torch.py", "main", [str(traces["jsonl"]), *cpu]),
    ]
    runs = [(label, str(ROOT / path), entry, argv) for label, path, entry, argv in runs]
    out = subprocess.run([sys.executable, "-c", PORT_CHILD, json.dumps(runs)],
                         capture_output=True, text=True, env=child_env(), timeout=600)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    got = json.loads(out.stdout.splitlines()[-1])
    got["ckpt_dir"] = ckpt
    return got


def test_port_scripts_run_without_jax(port_runs):
    """Item 11's property: every counterpart runs where jax and the JAX
    package cannot be imported, and loads none of them."""
    assert port_runs["loaded"] == []
    for label in ("quickstart", "quickstart_kernels", "solve_sparse", "train_lm",
                  "train_lm_again", "trace_report"):
        assert port_runs[label]["stdout"].strip(), label
    assert port_runs["quickstart"]["stdout"].rstrip().endswith("OK")


@pytest.mark.parametrize("script, argv", [
    ("examples/quickstart_torch.py", []),
    ("examples/solve_sparse_torch.py", []),
    ("examples/train_lm_torch.py", TINY_TRAIN),
    ("tools/trace_report_torch.py", ["unused.json"]),
])
def test_scripts_default_to_the_card(script, argv):
    """Without ``--device`` each script asks for the card, and raises on a
    machine without one before it does any work."""
    spec = importlib.util.spec_from_file_location(Path(script).stem, ROOT / script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)


def test_quickstart_matches_reference(port_runs):
    ref_lines, ref = run_reference("examples/quickstart.py", exprs={
        "mode": "res.mode", "initial": "float(res.history['initial']['mse'])",
        "final": "float(res.final_mse)", "err": "float(err)"})
    port = port_runs["quickstart"]
    lines, got = port["stdout"].splitlines(), port["result"]
    assert lines[0] == ref_lines[0]  # the system line
    assert got["mode"] == ref["mode"] == "wide" and lines[1].startswith("mode=wide ")
    # the initial MSE at float32 agreement; the final ones are both float32
    # noise near 1.5e-13
    assert got["initial_mse"] == pytest.approx(ref["initial"], rel=1e-4)
    assert got["final_mse"] < 1e-10 and ref["final"] < 1e-10
    assert got["max_err"] < 1e-3 and ref["err"] < 1e-3  # the reference's gate
    assert lines[-1] == ref_lines[-1] == "OK"
    # the printed lines' words, the numbers held above (and wall seconds) masked
    assert len(lines) == len(ref_lines) == 5
    assert lines[2].split()[:2] == ref_lines[2].split()[:2] == ["initial", "MSE"]
    assert lines[2].split(" -> ")[0] == ref_lines[2].split(" -> ")[0]


def test_quickstart_kernels_flag_on_the_cpu(port_runs):
    """``--kernels`` on the CPU takes the kernels' plain versions: the same
    solution within the dense kernels-on/off gate, 1e-4·max(1, max|x|)."""
    off = np.asarray(port_runs["quickstart"]["result"]["x"])
    on = np.asarray(port_runs["quickstart_kernels"]["result"]["x"])
    assert np.abs(on - off).max() <= 1e-4 * max(1.0, np.abs(off).max())


def test_solve_sparse_matches_reference(port_runs):
    methods = ("apc", "dapc", "dgd")
    exprs = {f"{m}_{k}": e.format(m=m) for m in methods for k, e in (
        ("init", "float(results['{m}'].history['initial']['mse'])"),
        ("final", "float(np.asarray(results['{m}'].history['mse'])[-1])"))}
    exprs.update(mean="float(x.mean())", std="float(x.std())", err="float(err)")
    ref_lines, ref = run_reference("examples/solve_sparse.py", exprs=exprs)
    port = port_runs["solve_sparse"]
    lines, got = port["stdout"].splitlines(), port["result"]
    assert lines[0] == ref_lines[0]  # core matrix stats: host numpy, equal
    # the float32 floor of this system's block solves: (κ·u)²·mean(x²), with
    # κ the largest condition number of its four square blocks (1.46e4) and
    # u float32's unit roundoff; an MSE below it is rounding
    from repro_torch.sparse import make_problem

    prob = make_problem(n=1141, m=4564, sparsity=0.9985, seed=42, dtype=np.float32)
    blocks = prob.A.astype(np.float64).reshape(4, 1141, 1141)
    sv = np.linalg.svd(blocks, compute_uv=False)
    floor = (np.max(sv[:, 0] / sv[:, -1]) * np.finfo(np.float32).eps / 2) ** 2 \
        * np.mean(prob.x_true.astype(np.float64) ** 2)
    for m in methods:
        for k, key in (("init", "initial_mse"), ("final", "final_mse")):
            want, have = ref[f"{m}_{k}"], got["methods"][m][key]
            if m == "dgd" and k == "final":
                # the deliberate difference: dgd's step size comes from a power
                # iteration started at another vector (ROADMAP Queue 3, 0.6-11%);
                # measured here 1.0% (8.867e-02 against 8.955e-02)
                assert have == pytest.approx(want, rel=0.11)
            elif have < floor and want < floor:
                continue  # both at the float32 noise floor
            else:
                # the reference's own float32 agreement (~2e-4, Queue 3)
                assert have == pytest.approx(want, rel=2e-4), (m, k)
    assert got["mean"] == pytest.approx(ref["mean"], abs=1e-4)
    assert got["std"] == pytest.approx(ref["std"], abs=1e-4)
    assert got["batched_rel_err"] < 1e-3 and ref["err"] < 1e-3
    # the printed lines' shapes, wall seconds and the acceleration masked
    assert len(lines) == len(ref_lines)
    for mine, theirs in zip(lines, ref_lines):
        assert mine.split()[:1] == theirs.split()[:1]
        if mine.startswith("solution vector"):
            assert mine == theirs


def _reference_train_lm():
    spec = importlib.util.spec_from_file_location("reference_train_lm",
                                                  ROOT / "examples" / "train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("small, params", [(True, 4_983_040), (False, 128_404_224)])
def test_train_lm_config_equals_reference(small, params):
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import train_lm_torch
    finally:
        sys.path.remove(str(ROOT / "examples"))
    ref, port = _reference_train_lm().lm_config(small), train_lm_torch.lm_config(small)
    for field in dataclasses.fields(ref):
        assert getattr(port, field.name) == getattr(ref, field.name), field.name
    assert port.param_count() == ref.param_count() == params


def test_train_lm_logs_and_checkpoints_as_reference(port_runs, tmp_path):
    """The tiny run's history has the reference's keys and logged steps, and
    the same checkpoint steps are on disk. Losses are not compared: the
    port's batches come from numpy's generator (Queue 3). A second call
    with the same directory resumes from the reference's latest step; the
    reference's own second call raises (its ``hist[0]`` of an empty
    history), which the port reports instead."""
    ref_dir = tmp_path / "ref"
    ref_lines, _ = run_reference("examples/train_lm.py", [*TINY_TRAIN, "--ckpt-dir",
                                                          str(ref_dir)])
    ref_hist = history_lines(ref_lines)
    port = port_runs["train_lm"]
    hist = port["result"]["history"]
    assert port["result"]["resumed_from"] == 0
    assert [sorted(h) for h in hist] == [sorted(h) for h in ref_hist]
    assert [h["step"] for h in hist] == [h["step"] for h in ref_hist] == [5, 6]
    assert history_lines(port["stdout"].splitlines()) == hist
    assert ref_lines[0] == port["stdout"].splitlines()[0] == "model: lm-10m (5.0M params)"
    assert sorted(p.name for p in port_runs["ckpt_dir"].iterdir()) == \
        sorted(p.name for p in ref_dir.iterdir())

    again = port_runs["train_lm_again"]["result"]
    assert again["resumed_from"] == jckpt.latest_step(str(ref_dir)) == 6
    assert again["history"] == [] and "drop" not in again
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_lm.py"), *TINY_TRAIN, "--ckpt-dir",
         str(ref_dir)], capture_output=True, text=True, env=child_env(), timeout=600)
    assert out.returncode != 0 and "IndexError" in out.stderr


def test_train_lm_recipe_trajectory_matches_reference(monkeypatch):
    """lm-100m's width (d 768, 12 heads over 4, d_ff 3072, vocab 32000) at
    2 of its 12 layers, with the example's recipe for a 10-step run (AdamW at
    3e-3 after a 1-step warm-up, cosine), f32 compute, from the reference's
    weights on the reference's batches (2 x 32): losses within 1e-4 and
    gradient norms within 1e-3 relative (measured 4e-6 and 8e-5 over the 10
    steps). Both packages' losses climb above ln 32000 after step 2: the
    recipe's rate, not the port, is what makes lm-100m's loss rise on the
    card (PERF.md, ROADMAP Queue 3)."""
    import jax

    from repro.training import data as jdata
    from repro.training import train_loop as jtl
    from repro.training.optimizer import OptConfig as JOptConfig
    from repro_torch.models.convert import load_reference
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import OptConfig
    from test_torch_train_parity import reference_batches

    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import train_lm_torch
    finally:
        sys.path.remove(str(ROOT / "examples"))
    steps = 10
    jcfg = dataclasses.replace(_reference_train_lm().lm_config(False), num_layers=2,
                               dtype="float32")
    cfg = dataclasses.replace(train_lm_torch.lm_config(False), num_layers=2, dtype="float32")
    dcfg = jdata.DataConfig(jcfg.vocab_size, 32, 2, seed=0, repeat_prob=0.75)
    opt = dict(learning_rate=3e-3, warmup_steps=steps // 10, total_steps=steps)
    _, want = jtl.train(jcfg, jtl.TrainConfig(opt=JOptConfig(**opt), num_steps=steps,
                                              log_every=1), dcfg)
    tcfg = train_loop.TrainConfig(opt=OptConfig(**opt), num_steps=steps, log_every=1)
    state = train_loop.init_state(cfg, torch.Generator().manual_seed(0), tcfg)
    init = jtl.init_state(jcfg, jax.random.PRNGKey(0), jtl.TrainConfig())
    load_reference(state["params"], jax.tree.map(np.asarray, init["params"]))
    reference_batches(monkeypatch, dcfg)
    _, got = train_loop.train(cfg, tcfg, None, state=state)
    losses, ref_losses = [h["loss"] for h in got], [h["loss"] for h in want]
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-4)
    np.testing.assert_allclose([h["grad_norm"] for h in got], [h["grad_norm"] for h in want],
                               rtol=1e-3)
    assert max(ref_losses[2:]) > np.log(32000) and max(losses[2:]) > np.log(32000)


def _report(tool, argv, capsys):
    spec = importlib.util.spec_from_file_location(Path(tool).stem, ROOT / tool)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("fmt", ["chrome", "jsonl"])
@pytest.mark.parametrize("top", [1, 5, 50])
def test_trace_report_prints_the_reference_report(traces, fmt, top, capsys):
    path = str(traces[fmt])
    want = _report("tools/trace_report.py", [path, "--top", str(top)], capsys)
    got = _report("tools/trace_report_torch.py", [path, "--top", str(top), "--device", "cpu"],
                  capsys)
    assert got == want
    assert "queue" in got and "solve" in got and "batch sizes:" in got


def test_trace_report_formats_carry_the_same_durations(traces, port_runs, capsys):
    """Both exports give one report, so the card's gate may compare them; the
    counts ``main`` returns add up to the replay's requests."""
    chrome = _report("tools/trace_report_torch.py", [str(traces["chrome"]), "--device", "cpu"],
                     capsys)
    assert chrome == port_runs["trace_report"]["stdout"]
    counts = port_runs["trace_report"]["result"]
    assert counts["kinds"]["queue"] == counts["kinds"]["solve"] == 8
    assert sum(int(size) * n for size, n in counts["batch_sizes"].items()) == 8
