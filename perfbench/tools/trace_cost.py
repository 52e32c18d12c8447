"""What tracing the solve path costs per solve, on the card, at a closed
cell's shapes, in four states taken in turns:

- ``off``: no tracer, no profiler (one check per solve);
- ``tracer``: a ``repro_torch.obs.Tracer`` attached (spans on the host);
- ``profiler``: ``torch.profiler`` recording CPU and CUDA activity of every
  thread, as the benchmark's traced run does, with the program's host
  ranges;
- ``profiler_no_ranges``: the same profiler with the ranges taken out, so
  the ranges' own cost is ``profiler`` less this.

    python3 perfbench/tools/trace_cost.py --workload s5.batch --rounds 6 --solves 4

Prints one JSON line per state: the median and mean host-clock milliseconds
of a solve (the numpy result returned) over the rounds, and the state's
median less ``off``'s; then one line of the ``tracer`` state's spans: the
mean duration and the mean self time of each ``solver.*`` phase, in ms.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

STATES = ("off", "tracer", "profiler", "profiler_no_ranges")


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench.harness import cell as cell_mod
    from perfbench.harness import problem, traffic
    from repro_torch.core import prepare
    from repro_torch.core.prepared import SolveOptions
    from repro_torch.obs import trace as obs_trace

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=3000000021)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--solves", type=int, default=4, help="solves per state and round")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_cost: CUDA is not available; it measures on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    c = cell_mod.load_cell(ROOT, args.workload)
    if c.mix["kind"] != "closed_loop":
        ap.error("a closed-loop cell")
    system = problem.make_system(c.config["problem"], args.seed, device)
    load = traffic.make_load(c.mix, system, args.seed, 1.0)
    A = cell_mod.program_matrix(system.host())
    del system
    prep = prepare(A, **{**c.config["prepare"], "device": device})
    options = SolveOptions(num_epochs=int(c.mix["epochs"]), tol=traffic.tolerance(c.mix, c.config))
    B = load.pool[0]
    for _ in range(2):
        prep.solve(B, options)
    real_range = obs_trace._host_range
    tracer = obs_trace.Tracer()
    all_threads = {}
    try:  # as perfbench/harness/profiling.py starts it
        from torch._C._profiler import _ExperimentalConfig

        all_threads["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        pass

    @contextlib.contextmanager
    def state(name):
        prep.tracer = tracer if name == "tracer" else None
        if name == "profiler_no_ranges":
            obs_trace._host_range = lambda n: contextlib.nullcontext()
        try:
            if name.startswith("profiler"):
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             **all_threads):
                    yield
            else:
                yield
        finally:
            obs_trace._host_range = real_range
            prep.tracer = None

    times = {s: [] for s in STATES}
    for _ in range(args.rounds):
        for name in STATES:
            with state(name):
                for _ in range(args.solves):
                    t = time.perf_counter()
                    prep.solve(B, options)
                    times[name].append((time.perf_counter() - t) * 1e3)
    base = statistics.median(times["off"])
    gpu = torch.cuda.get_device_name(device)
    for name in STATES:
        med = statistics.median(times[name])
        print(json.dumps({"workload": args.workload, "state": name, "solves": len(times[name]),
                          "median_ms": med, "mean_ms": statistics.fmean(times[name]),
                          "over_off_ms": med - base, "device": gpu}), flush=True)
    records = [obs_trace._linked(r) for r in tracer._records()]
    selfs = obs_trace.self_us(records)
    phases = {}
    for r in records:
        phases.setdefault(r["name"], []).append((r["dur_us"] / 1e3, selfs[r["id"]] / 1e3))
    print(json.dumps({"workload": args.workload, "state": "tracer", "phases": {
        name: {"count": len(v), "mean_ms": statistics.fmean(d for d, _ in v),
               "mean_self_ms": statistics.fmean(x for _, x in v)}
        for name, v in sorted(phases.items())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
