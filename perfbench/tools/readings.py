"""The readings that a cell's limits are set from, in one process.

    python3 perfbench/tools/readings.py --workload s5.batch --seeds 101,102,... \
        --control-seeds 201,202,203 --seconds 4 [--out readings.jsonl]

For each of ``--seeds`` the program runs the cell as a benchmark run does
(a short window at the cell's own load) and its compared numbers are
printed: the lower readings. For each of ``--control-seeds`` the control —
the reference in the next precision below the configuration's (TF32 for
float32), put in the program's place — answers the same right-hand sides a
run sends (the whole pool of a closed loop; a sample of a served schedule as
large as a run's), and its numbers are printed: the upper readings. One JSON
line per run, on standard output and appended to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def control_numbers(cell, seed: int, seconds: float, device) -> dict:
    import numpy as np

    from perfbench.harness import cell as cell_mod
    from perfbench.harness import compare, problem, traffic

    config, mix = cell.config, cell.mix
    tol = traffic.tolerance(mix, config)
    epochs = int(mix["epochs"])
    system = problem.make_system(config["problem"], seed, device)
    load = traffic.make_load(mix, system, seed, seconds)
    plain = system.host()
    del system
    n = plain.shape[1]
    if mix["kind"] == "closed_loop":
        shells = [compare.Answer(b=b, x=np.zeros((n, b.shape[1])),
                                 iterations=None, history=None) for b in load.pool]
    else:
        shells = [compare.Answer(b=load.rhs[:, i:i + 1], x=np.zeros((n, 1)),
                                 iterations=None, history=None)
                  for i in range(load.rhs.shape[1])]
        shells = cell_mod.sample_answers(shells, seed, int(mix.get("sample", 256)),
                                         by_epochs=False)
    ref_mod = cell_mod.load_reference(config)
    lower = ref_mod.build(plain, config, "tf32", device)
    answers = compare.control_answers(lower, shells, epochs, tol)
    del lower
    compare.free_device()
    ref = ref_mod.build(plain, config, "float64", device)
    return compare.judge(ref, answers, epochs, tol)


def main(argv=None) -> int:
    import torch

    from perfbench.harness import cell as cell_mod

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = cell_mod.load_cell(ROOT, args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    try:
        for who, seed_list in (("program", seeds), ("control", controls)):
            for seed in seed_list:
                t = time.perf_counter()
                if who == "program":
                    res = cell_mod.run_cell(cell, seed, args.seconds, False, args.device, t)
                    numbers = {k: v["value"] for k, v in res["compared"].items()}
                    extra = {"correct": res["correct"], "attempted": res["attempted"],
                             "failed": res["failed"], "metrics": res["metrics"]}
                else:
                    numbers = control_numbers(cell, seed, args.seconds, args.device)
                    extra = {}
                line = json.dumps({"workload": args.workload, "who": who, "seed": seed,
                                   "numbers": numbers, "seconds": time.perf_counter() - t,
                                   **extra})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
