"""The program's phases and counters in the benchmark's device trace, on
the card (marked ``gpu``; skips without a CUDA device): at ``s5.batch``'s
shapes, every idle gap of the card inside a ``bench.solve`` span falls
under a ``solver.*`` host range, and the kernel counts the harness reads
are those of a trace without the ranges; in each cell that reads
``host_syncs_per_solve``, the solver's counters equal the synchronizations
and copies the profiler sees in one solve."""
import contextlib
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SEED = 3000000017
SOLVES = 3


_PREPARED = {}


def _prepared(name):
    """The cell's solver, one right-hand side of its pool and its solve
    options, warmed by two solves; built once per cell."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if name in _PREPARED:
        return _PREPARED[name]
    from perfbench.harness import cell as cell_mod
    from perfbench.harness import problem, traffic
    from repro_torch.core import prepare
    from repro_torch.core.prepared import SolveOptions

    torch.backends.cuda.matmul.allow_tf32 = False
    c = cell_mod.load_cell(ROOT, name)
    system = problem.make_system(c.config["problem"], SEED, "cuda")
    B = traffic.make_load(c.mix, system, SEED, 1.0).pool[0]
    A = system.A.cpu().numpy()
    del system
    prep = prepare(A, **{**c.config["prepare"], "device": "cuda"})
    options = SolveOptions(num_epochs=int(c.mix["epochs"]),
                           tol=traffic.tolerance(c.mix, c.config))
    for _ in range(2):
        prep.solve(B, options)
    _PREPARED[name] = prep, B, options
    return _PREPARED[name]


@pytest.fixture(scope="module")
def solver():
    return _prepared("s5.batch")


def _solves(prep, B, options):
    from torch.profiler import record_function

    for _ in range(SOLVES):
        with record_function("bench.solve"):
            prep.solve(B, options)


@pytest.mark.gpu
def test_every_idle_gap_inside_a_solve_falls_under_a_solver_range(solver):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from perfbench.harness.profiling import _label_gaps, _merge

    prep, B, options = solver
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _solves(prep, B, options)
        torch.cuda.synchronize()
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, end, name = e.start_ns(), e.start_ns() + e.duration_ns(), e.name()
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith("bench."):
                device.append((s, end))
                assert not name.startswith("solver."), "a range left a device-side event"
        else:
            host.append((s, end, name))
    busy = _merge(device)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)
            if busy[i + 1][0] > busy[i][1]]
    solves = [(s, e) for s, e, n in host if n == "bench.solve"]
    ranges = [(s, e) for s, e, n in host if n.startswith("solver.")]
    assert len(solves) == SOLVES
    inside = [(s, e) for s, e in gaps if any(a <= (s + e) // 2 <= b for a, b in solves)]
    assert inside
    for s, e in inside:
        mid = (s + e) // 2
        assert any(a <= mid <= b for a, b in ranges), (s, e)
    labels = _label_gaps(inside, host)
    assert not [lab for lab in labels if lab.endswith("/ python")]


@pytest.mark.gpu
def test_kernel_counts_are_those_of_a_trace_without_ranges(solver, monkeypatch):
    import torch

    from perfbench.harness.profiling import TraceWindow
    from repro_torch.obs import trace as obs_trace

    prep, B, options = solver
    per_epoch = {}
    for label in ("ranges", "none"):
        if label == "none":
            monkeypatch.setattr(obs_trace, "_host_range", lambda n: contextlib.nullcontext())
        window = TraceWindow(torch)
        window.warm("cuda")
        window.start()
        _solves(prep, B, options)
        window.stop()
        st = window.stats
        assert st.count("update_kernel") == SOLVES * options.num_epochs
        per_epoch[label] = st.kernels / st.count("update_kernel")
        named = sum(t for lab, t in st.gaps.items() if " / solver." in lab)
        assert (named > 0) == (label == "ranges")  # the harness's window sees them
    assert per_epoch["ranges"] == per_epoch["none"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["s5.batch", "t1.bulk", "s5.tol"])
def test_counters_equal_the_syncs_and_copies_the_profiler_sees(cell, tmp_path):
    """``solver_host_syncs_total`` grows by the stream and device
    synchronizations of one solve, and ``solver_copy_bytes_total`` by the
    bytes of its host-to-device and device-to-host copies: the tally kept
    beside ``solve``'s code is held to what the solve really does."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import metrics as obs_metrics

    prep, B, options = _prepared(cell)
    reg = obs_metrics.REGISTRY
    before = {d: reg.value("solver_copy_bytes_total", direction=d) for d in ("h2d", "d2h")}
    syncs = reg.value("solver_host_syncs_total")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prep.solve(B, options)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    (solve,) = [e for e in events if e["name"] == "solver.solve"]
    # the profiler's own synchronize at its exit lies outside the solve
    names = [e["name"] for e in events
             if solve["ts"] <= e["ts"] and e["ts"] + e["dur"] <= solve["ts"] + solve["dur"]]
    copied = {d: sum(int(e["args"]["bytes"]) for e in events
                     if e["name"].startswith(f"Memcpy {tag}"))
              for d, tag in (("h2d", "HtoD"), ("d2h", "DtoH"))}
    assert reg.value("solver_host_syncs_total") - syncs == (
        names.count("cudaStreamSynchronize") + names.count("cudaDeviceSynchronize"))
    assert {d: reg.value("solver_copy_bytes_total", direction=d) - before[d]
            for d in copied} == copied
    assert copied["h2d"] > 0 and copied["d2h"] > 0
