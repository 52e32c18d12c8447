"""What the command loads and opens: no module of jax, jaxlib, flax or the
JAX package ``repro`` (top-level names compared whole: ``repro_torch``
begins with ``repro`` and is the program), and no file under the JAX
package's ``benchmarks/`` folder. Also how the command refuses to run."""
import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

# a tiny cell run end to end in a child, with every opened path recorded
CHILD = r"""
import json, sys, time
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == "open" else None)
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import perfbench.run  # the command's own imports
from perfbench.harness import cell as cell_mod
from perfbench.tests import tiny
bench = json.loads(open(sys.argv[1] + "/BENCHMARK.json").read())
names = [m["name"] for m in bench["end_to_end"]] + [m["name"] for m in bench["per_layer"]]
for kind, name in [("e2e", m["name"]) for m in bench["end_to_end"]] + \
        [("metrics", m["name"]) for m in bench["per_layer"]]:
    cell_mod.reader(kind, name)
for kind in ("closed", "served"):
    cell_mod.run_cell(tiny.cell(kind), 3, 0.4, kind == "closed", "cpu", time.perf_counter())
print(json.dumps({"modules": sorted(sys.modules), "opened": opened}))
"""


def test_the_run_loads_no_jax_and_reads_no_benchmarks_folder():
    out = subprocess.run([sys.executable, "-c", CHILD, str(ROOT)], capture_output=True,
                         text=True, timeout=600, env={"PATH": "/usr/bin:/bin",
                                                      "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    bad = sorted(m for m in seen["modules"] if m.split(".", 1)[0] in FORBIDDEN)
    assert bad == []
    assert "repro_torch" in {m.split(".", 1)[0] for m in seen["modules"]}
    folder = (ROOT / "benchmarks").resolve()
    under = [p for p in seen["opened"]
             if not p.isdigit() and folder in Path(p).resolve().parents]
    assert under == []


def _literals(path: Path):
    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef, ast.AsyncFunctionDef)):
            doc = ast.get_docstring(node, clean=False)
            if doc is not None:
                docs.add(doc)
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value not in docs:
            yield node.value


def test_no_harness_source_names_the_benchmarks_folder():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.relative_to(BENCH).parts:
            continue  # the tests name it to check it
        for s in _literals(path):
            assert "benchmarks" not in s, (path, s)
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import benchmarks", "from benchmarks")), path
            assert not stripped.startswith(("import jax", "from jax", "import repro ",
                                            "from repro ", "from repro.", "import repro.")), path


def _command(cwd: Path, *extra):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "s5.batch", "--seed", "5",
         "--seconds", "1", *extra], cwd=cwd, capture_output=True, text=True, timeout=300)


def _no_result(out) -> bool:
    for line in out.stdout.splitlines():
        try:
            if "correct" in json.loads(line):
                return False
        except (ValueError, TypeError):
            continue
    return True


def test_the_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = _command(ROOT)
    assert out.returncode != 0 and _no_result(out)
    assert "CUDA" in out.stderr


def test_the_command_fails_with_only_its_own_files(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's folder
    has no program to measure."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and _no_result(out)
