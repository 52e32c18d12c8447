"""One run of one cell: set-up, the window, the check of its answers, and
the metrics, all found by the names in ``BENCHMARK.json``.

A cell names a configuration (its file under ``perfbench/configs/``), a
traffic mix (``perfbench/traffic/<mix>.json``) and has its limits in
``perfbench/limits/<cell>.json``. Each metric is a reader of its own:
``perfbench/e2e/<name>.py`` for an end-to-end metric,
``perfbench/metrics/<name>.py`` for a per-layer one, each with ``read(ctx)``
returning a number, or None when it finds nothing to read.

A configuration's matrix reaches the program in its ``problem``'s form (see
``harness/problem.py``): the dense array, or the port's ``COOMatrix`` of the
``"coo"`` form's coordinates; its ``prepare`` keys pick the solver (the
dense ``PreparedSolver``, or the ``MatrixFreePreparedSolver`` with
``"mode": "matfree"``). The reference is handed the plain matrix: the dense
array, or the coordinates (``problem.Coords``), never a type of the program.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from perfbench.harness import compare, drive, problem, traffic
from perfbench.harness.profiling import TraceWindow

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: dict
    end_to_end: list  # metric names
    per_layer: list
    units: dict  # metric name -> unit


def _applies(entry: dict, cell: str, e2e_of_cell: set | None = None) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return e2e_of_cell is None or entry["moves"] in e2e_of_cell


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files read."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{entry['traffic']}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())
    e2e = [m["name"] for m in bench["end_to_end"] if _applies(m, name)]
    layer = [m["name"] for m in bench["per_layer"] if _applies(m, name, set(e2e))]
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    return Cell(name, config, mix, limits, e2e, layer, units)


def reader(kind: str, name: str):
    """The ``read`` function of ``perfbench/<kind>/<name>.py``."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({k for k in list(sys.modules) if k.split(".", 1)[0] in FORBIDDEN})


@dataclasses.dataclass
class Context:
    """What the metric readers read."""

    cell: Cell
    setup_s: float
    prepare_s: float
    window: drive.Window
    trace: object  # profiling.TraceStats, or None without --trace 1
    J: int
    p: int
    n: int
    k: int  # width of each solve call
    path: str  # the solver read: "dense" or "matfree"


def program_matrix(plain):
    """The matrix as the program takes it: the dense array itself, or a
    ``COOMatrix`` of copies of the coordinates."""
    if isinstance(plain, problem.Coords):
        from repro_torch.sparse.matrix import COOMatrix

        return COOMatrix(plain.rows.copy(), plain.cols.copy(), plain.vals.copy(),
                         tuple(plain.shape))
    return plain


def solve_shape(prep) -> tuple[int, int, int]:
    """(J, p, n) of a prepared solver: its blocks' shape on the dense path,
    (num_blocks, block_rows, num_cols) on the matrix-free one."""
    blocks = getattr(prep, "blocks", None)
    if blocks is not None:
        return tuple(int(s) for s in blocks.shape)
    return int(prep.num_blocks), int(prep.block_rows), int(prep.num_cols)


def _prepare_kwargs(config: dict, device) -> dict:
    kw = dict(config["prepare"])
    kw["device"] = device
    return kw


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=sys.stderr) -> dict:
    """Run ``cell`` once; returns the result line's object (``metrics`` for
    the end-to-end metrics, or the per-layer ones with ``trace``)."""
    from repro_torch.core import prepare
    from repro_torch.core.prepared import SolveOptions

    device = torch.device(device)
    config, mix = cell.config, cell.mix
    tol = traffic.tolerance(mix, config)
    epochs = int(mix["epochs"])
    system = problem.make_system(config["problem"], seed, device)
    load = traffic.make_load(mix, system, seed, seconds)
    plain = system.host()
    del system
    A = program_matrix(plain)
    compare.free_device()

    tracer = None
    if trace:
        tracer = TraceWindow(torch)
        tracer.warm(device)
    t = time.perf_counter()
    if mix["kind"] == "closed_loop":
        prep = prepare(A, **_prepare_kwargs(config, device))
        _sync(device)
        prepare_s = time.perf_counter() - t
        k = int(mix["k"])
        options = SolveOptions(num_epochs=epochs, tol=tol)

        def run(mark):
            return drive.closed_loop(prep, load.pool, options, seconds, mark, tracer)
    else:
        from repro_torch.serving import SolveServer

        k = int(mix["max_batch"])
        server = SolveServer(max_batch=k, max_wait_ms=float(mix["max_wait_ms"]),
                             num_epochs=epochs, tol=tol, pool_size=1,
                             prepare_kwargs=_prepare_kwargs(config, device))
        fp = server.register(A)
        prep = server.pool.get(fp)
        _sync(device)
        prepare_s = time.perf_counter() - t
        drive.span_solves(prep)

        def run(mark):
            return drive.open_loop(server, fp, device, load.rhs, load.due_s, seconds,
                                   load.warm, mark, tracer)
    J, p, n = solve_shape(prep)
    path = prep.path
    setup = {}

    def mark():  # the warm-up before the window is set-up; the window starts here
        setup["seconds"] = time.perf_counter() - t_start

    window = run(mark)
    del prep, A
    server = None
    compare.free_device()

    # the check, once the window has closed and the program's state is freed
    ref_mod = load_reference(config)
    ref = ref_mod.build(plain, config, "float64", device)
    answers = window.answers
    if mix["kind"] == "open_poisson":
        answers = sample_answers(answers, seed, int(mix.get("sample", 256)))
    numbers = compare.judge(ref, answers, epochs, tol)
    del ref
    compare.free_device()
    ok, shown = compare.verdict(numbers, cell.limits)
    if window.failed:
        ok = False
    if mix["kind"] == "open_poisson":
        late = window.lateness_ms
        print(f"perfbench: generator lateness ms: p50 {float(np.median(late))} "
              f"p95 {float(np.percentile(late, 95))} max {float(late.max())}", file=log)

    ctx = Context(cell=cell, setup_s=setup["seconds"], prepare_s=prepare_s, window=window,
                  trace=tracer.stats if tracer else None, J=J, p=p, n=n, k=k,
                  path=path)
    names, kind = (cell.per_layer, "metrics") if trace else (cell.end_to_end, "e2e")
    metrics = {}
    for name in names:
        value = reader(kind, name)(ctx)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": cell.units[name]}
    out = {
        "correct": bool(ok), "attempted": int(window.attempted), "failed": int(window.failed),
        "metrics": metrics,
        "device": _device(device, window.peak_bytes),
    }
    if tracer is not None:
        st = tracer.stats
        out["device"]["busy_s"] = st.busy_ns / 1e9
        out["device"]["window_s"] = st.window_ns / 1e9
        out["breakdown"] = st.breakdown()
    out["compared"] = shown
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_reference(config: dict):
    path = BENCH / "reference" / f"{config['reference']}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_reference_{config['reference']}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sample_answers(answers, seed: int, size: int, by_epochs: bool = True):
    """A sample, drawn from the seed, of the served answers, with the one
    that ran the most epochs in it (``by_epochs``)."""
    if len(answers) <= size:
        return answers
    rng = np.random.default_rng(problem.sub_seed(seed, 3))
    pick = set(rng.choice(len(answers), size=size - 1, replace=False).tolist())
    if by_epochs:
        pick.add(int(np.argmax([int(a.iterations[0]) for a in answers])))
    return [answers[i] for i in sorted(pick)]


def _device(device, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}
