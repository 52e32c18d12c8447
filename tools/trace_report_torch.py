"""Summarize a serving trace file (Chrome trace-event JSON or jsonl) with the
PyTorch port's reader (the counterpart of ``tools/trace_report.py``; it
needs no jax).

Reads the spans a ``repro_torch.obs.trace.Tracer`` exported (either format
— ``--trace-out`` / ``--trace-jsonl`` on ``repro_torch.launch.serve_solver``)
and prints the numbers a latency investigation starts from:

  * per span kind (queue / solve / batch / session.update / pool.*):
    count, p50 / p99 / max duration — where the requests' time went;
  * the batch-size histogram off the ``batch`` spans' recorded args —
    how well the trace coalesced;
  * the slowest individual spans with their trace ids and args, so the
    outlier request can be followed onto its Perfetto track by tid.

The report is host work on the file; ``--device`` is resolved as on every
entry point of the port (the card unless ``cpu`` is asked for).

    PYTHONPATH=src python tools/trace_report_torch.py trace.json [--top 5] [--device cpu]
"""
from __future__ import annotations

import argparse
import pathlib
import sys
from collections import Counter, defaultdict

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "src"))

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.obs.trace import load_trace


def _batch_sizes(spans) -> Counter:
    return Counter(
        r["args"]["batch_size"] for r in spans if "batch_size" in r.get("args", {})
    )


def summarize(records: list[dict], top: int = 5) -> str:
    """The report body for one trace's span records (``load_trace`` output)."""
    if not records:
        return "no spans in trace"
    lines = []
    by_kind: dict[str, list[dict]] = defaultdict(list)
    for rec in records:
        by_kind[rec["name"]].append(rec)

    lines.append(f"{len(records)} spans, {len(by_kind)} kinds")
    lines.append(
        f"{'kind':<16} {'count':>6} {'p50 ms':>9} {'p99 ms':>9} {'max ms':>9}"
    )
    for kind in sorted(by_kind):
        durs = np.array([r["dur_us"] for r in by_kind[kind]]) / 1e3
        lines.append(
            f"{kind:<16} {len(durs):>6} {np.percentile(durs, 50):>9.2f} "
            f"{np.percentile(durs, 99):>9.2f} {durs.max():>9.2f}"
        )

    sizes = _batch_sizes(by_kind.get("batch", ()))
    if sizes:
        total = sum(sizes.values())
        lines.append("batch sizes:")
        for size in sorted(sizes):
            bar = "#" * round(40 * sizes[size] / total)
            lines.append(f"  {size:>4}: {sizes[size]:>5}  {bar}")

    slowest = sorted(records, key=lambda r: r["dur_us"], reverse=True)[:top]
    lines.append(f"slowest {len(slowest)} spans:")
    for rec in slowest:
        args = ", ".join(f"{k}={v}" for k, v in rec.get("args", {}).items())
        lines.append(
            f"  {rec['dur_us'] / 1e3:>9.2f} ms  {rec['name']:<16} "
            f"trace_id={rec['trace_id']}" + (f"  [{args}]" if args else "")
        )
    return "\n".join(lines)


def main(argv=None) -> dict:
    """Print the report; return its counts: spans, spans per kind, and
    batches per batch size."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("trace", help="trace file (Chrome trace JSON or jsonl)")
    ap.add_argument("--top", type=int, default=5,
                    help="how many slowest spans to list")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' must be asked for)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    records = load_trace(args.trace)
    print(summarize(records, top=args.top))
    return {
        "spans": len(records),
        "kinds": dict(Counter(r["name"] for r in records)),
        "batch_sizes": dict(_batch_sizes(r for r in records if r["name"] == "batch")),
    }


if __name__ == "__main__":
    main()
