"""The knee of a served cell: its open-loop traffic at a ladder of rates.

    python3 perfbench/tools/sweep.py --workload s5.served --rates 60,80,100,120 \
        --seconds 15 [--seed 11] [--out sweep.jsonl]

For each rate, a fresh server (the cell's configuration and mix, the rate
replaced) takes the mix's traffic for ``--seconds``. Printed per rate: the
requests due and completed, the completed rate, latency from due time (p50,
p95, max), the mean batch size, and the backlog's growth: the mean queue
wait of the requests due in the window's last quarter over that of its first
quarter. The knee is the highest rate whose backlog does not grow.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    import numpy as np
    import torch

    from perfbench.harness import cell as cell_mod
    from perfbench.harness import compare, drive, problem, traffic
    from perfbench.harness.readers import p95
    from repro_torch.serving import SolveServer

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = cell_mod.load_cell(ROOT, args.workload)
    config, mix = cell.config, dict(cell.mix)
    device = torch.device(args.device)
    system = problem.make_system(config["problem"], args.seed, device)
    tol = traffic.tolerance(mix, config)
    for rate in (float(r) for r in args.rates.split(",")):
        mix["rate_per_s"] = rate
        load = traffic.make_load(mix, system, args.seed, args.seconds)
        A = cell_mod.program_matrix(system.host())
        server = SolveServer(max_batch=int(mix["max_batch"]),
                             max_wait_ms=float(mix["max_wait_ms"]),
                             num_epochs=int(mix["epochs"]), tol=tol, pool_size=1,
                             prepare_kwargs={**config["prepare"], "device": device})
        fp = server.register(A)
        server.pool.get(fp)
        w = drive.open_loop(server, fp, device, load.rhs, load.due_s, args.seconds,
                            load.warm, lambda: None)
        ok = [(i, r) for i, r in enumerate(w.results)
              if r is not None and not isinstance(r, BaseException)]
        q = len(load.due_s) // 4
        first = [r.queue_ms for i, r in ok if i < q]
        last = [r.queue_ms for i, r in ok if i >= len(load.due_s) - q]
        lat = w.latencies_ms
        row = {
            "workload": args.workload, "rate_per_s": rate, "seconds": args.seconds,
            "due": int(w.attempted), "failed": int(w.failed),
            "completed_per_s": len(ok) / max(float(load.due_s[i]) + lat[i] / 1e3 for i, _ in ok)
            if ok else 0.0,
            "latency_ms": {"p50": float(np.median(lat)), "p95": p95(lat),
                           "max": float(np.max(lat))},
            "batch_size": float(np.mean([r.batch_size for _, r in ok])) if ok else None,
            "solve_ms": float(np.median([r.solve_ms for _, r in ok])) if ok else None,
            "backlog_growth": (float(np.mean(last)) / max(float(np.mean(first)), 1e-9)
                               if first and last else None),
            "lateness_ms_p95": float(np.percentile(w.lateness_ms, 95)),
        }
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del server, w, load
        compare.free_device()
    return 0


if __name__ == "__main__":
    sys.exit(main())
