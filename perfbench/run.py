"""Run one cell of the benchmark once, on the card this process is given.

    python3 perfbench/run.py --workload s5.batch --seed 7 --seconds 20 --trace 0

Loads the cell named in ``BENCHMARK.json``, makes its inputs from the seed,
prepares the solver, warms up, measures for ``--seconds``, checks the
answers against the plain reference, and prints one JSON object as the last
line of standard output: the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics (from a device trace of a stretch of the window) with
``--trace 1``. Each number compared with the reference is printed beside
its limit as the last lines of standard error and under ``compared`` last in
the JSON line.

Exits non-zero, with no result, without a CUDA device (or with fewer than
the cell asks for), and when a module of jax, jaxlib, flax or the JAX
package ``repro`` is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    # the process's own threads stay few; every cache stays in the checkout
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a non-negative whole number")
    _environment()

    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"perfbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("perfbench: CUDA is not available; the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(entry["chips"]):
        print(f"perfbench: {args.workload} needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    # float32 as the configurations state it: no TF32 in library products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from perfbench.harness.cell import forbidden_modules, load_cell, run_cell

    cell = load_cell(ROOT, args.workload)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: modules of jax or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
