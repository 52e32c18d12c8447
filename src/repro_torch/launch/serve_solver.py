"""Solve-serving command line: replay an arrival trace through the async
request-coalescing ``SolveServer`` and report throughput / latency / batching.

Two trace shapes:

  * ``--trace poisson`` (default) — independent requests arriving as a
    Poisson process at ``--rate`` req/s (Velasevic et al., arXiv:2304.10640
    motivate exactly this heterogeneity); the server coalesces whatever is
    pending into ``(m, k)`` batches under ``--max-batch``/``--max-wait-ms``.
  * ``--trace drifting`` — ``--sessions`` concurrent prediction-correction
    streams (``SolveServer.open_session``), each replaying ``--updates``
    solves of a smoothly drifting right-hand side b_t = A(x_base + drift_t)
    with per-component amplitude ``--drift``. Session columns coalesce
    across streams like ordinary requests but carry their warm starts, so
    the report shows epochs-per-update against the cold one-shot cost.

The port of the JAX package's ``repro.launch.serve_solver``, with the same
report lines. It serves on the card unless ``--device cpu`` is given, and
``--kernels`` prepares the pooled systems for the hand-written CUDA
kernels (on the CPU the kernel wrappers take their plain versions).

``--mesh D`` serves through the sharded matrix-free solver on D ranks
(``repro_torch.launch.mesh.run_ranks``): rank 0 runs the server and the
replay, ranks > 0 follow its prepares and solves
(``repro_torch.serving.mesh.serve_follower``). After a Poisson replay rank 0
also solves the replayed columns directly on the mesh, at the served width,
and prints a ``mesh: {...}`` JSON line: the ranks, the backend, the most
device bytes one rank holds, the requests answered, rank 0's SpMM kernel
launches over the replay, and the worst served column's distance from its
direct solve as a share of its max|x|.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve_solver --requests 64 \\
      --rate 200 --max-batch 8 --max-wait-ms 5 --kernels
  PYTHONPATH=src python -m repro_torch.launch.serve_solver --trace drifting \\
      --sessions 4 --updates 16 --kernels
  ... --mode matfree --mesh 4 --backend gloo   # 4 ranks on one card
  ... --device cpu              # the card is the default
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from collections import Counter

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--n", type=int, default=256, help="solution dimension")
    ap.add_argument("--m", type=int, default=1024, help="equations (rows)")
    ap.add_argument("--num-blocks", type=int, default=8)
    ap.add_argument("--method", default="dapc",
                    choices=("dapc", "apc", "cgnr", "dgd"))
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--gamma", type=float, default=None,
                    help="consensus step γ of the pooled solvers (default: "
                         "prepare's 1.0)")
    ap.add_argument("--eta", type=float, default=None,
                    help="consensus averaging η (default: prepare's 0.9)")
    ap.add_argument("--tol", type=float, default=1e-3,
                    help="per-column convergence tolerance on ||Ax-b||")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="Poisson arrival rate, requests/second")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--pool-size", type=int, default=4)
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="persistent factor checkpoint store: pool misses "
                         "warm-restore prepared factors from DIR (keyed by "
                         "matrix fingerprint) instead of re-factorizing, and "
                         "fresh prepares are written through — survives "
                         "process restarts")
    ap.add_argument("--mode", default="auto",
                    choices=("auto", "dense", "matfree"),
                    help="execution path for pooled systems (auto = "
                         "nnz/memory estimate per system)")
    ap.add_argument("--mesh", type=int, default=0, metavar="D",
                    help="serve through the sharded matfree path over D "
                         "ranks, one process each (requires --mode matfree)")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="process-group backend of --mesh (default: nccl on "
                         "the card, gloo on the CPU)")
    ap.add_argument("--kernels", action="store_true",
                    help="prepare the pooled systems for the hand-written "
                         "CUDA kernels")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' must be asked for)")
    ap.add_argument("--trace", default="poisson",
                    choices=("poisson", "drifting"),
                    help="poisson: independent one-shot requests; drifting: "
                         "concurrent prediction-correction session streams "
                         "over smoothly drifting right-hand sides")
    ap.add_argument("--sessions", type=int, default=4,
                    help="[drifting] number of concurrent streams")
    ap.add_argument("--updates", type=int, default=16,
                    help="[drifting] solves per stream")
    ap.add_argument("--drift", type=float, default=2e-3,
                    help="[drifting] per-component drift amplitude of the "
                         "underlying solution between updates")
    ap.add_argument("--seed", type=int, default=0)
    ft = ap.add_argument_group("fault tolerance (repro_torch.serving.faults)")
    ft.add_argument("--fault-plan", default=None, metavar="FILE",
                    help="arm a deterministic fault plan (JSON with seed + "
                         "rules, see FaultPlan) against the replay: injected "
                         "prepare/solve/checkpoint faults exercise the "
                         "containment ladder (retry -> fallback -> fresh "
                         "prepare); also arms the divergence watchdog and "
                         "prints a failure summary after the trace "
                         "(poisson trace only)")
    ft.add_argument("--watchdog", action="store_true",
                    help="arm the NaN/stall divergence watchdog on served "
                         "solves even without an injected fault plan")
    obs = ap.add_argument_group("observability (repro_torch.obs)")
    obs.add_argument("--trace-out", default=None, metavar="FILE",
                     help="record request spans and write a Chrome "
                          "trace-event JSON (open directly in Perfetto / "
                          "chrome://tracing: one track per request, server "
                          "batches, their batch.assemble / batch.deliver "
                          "and the solver.* phases on track 0)")
    obs.add_argument("--trace-jsonl", default=None, metavar="FILE",
                     help="also write the spans as JSON-lines (the "
                          "tools/trace_report.py input format)")
    obs.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                     help="serve the Prometheus text exposition of the "
                          "server's metrics registry on this port, followed "
                          "by the process registry's solver counters "
                          "(solver_solves_total, solver_epochs_total, "
                          "solver_column_epochs_total, "
                          "solver_active_column_epochs_total, "
                          "solver_host_syncs_total, "
                          "solver_copy_bytes_total{direction}) "
                          "(0 = ephemeral; the bound port is printed)")
    obs.add_argument("--stats-every", type=float, default=0.0, metavar="SEC",
                     help="print a periodic server-stats line every SEC "
                          "seconds while the trace replays (0 = off)")
    obs.add_argument("--block-history", action="store_true",
                     help="enable per-block residual diagnostics on the "
                          "served solves (consensus methods) and print the "
                          "convergence report — slowest block, imbalance — "
                          "after the replay")
    return ap


def _run_drifting(args, prob, system, server_kwargs, rng) -> None:
    """Replay ``--sessions`` concurrent prediction-correction streams.

    Every stream tracks its own smoothly drifting solution; the streams
    step in lockstep so their columns coalesce into shared batches (the
    serving win streaming adds on top of per-update epoch savings)."""
    import asyncio
    import time

    from repro_torch.serving.queue import SolveServer

    n, S, T = args.n, args.sessions, args.updates
    bases = rng.standard_normal((S, n)).astype(np.float32)
    phases = np.arange(n)[None, :] + 7.0 * np.arange(S)[:, None]

    def rhs_at(s: int, t: int) -> np.ndarray:
        xt = bases[s] + args.drift * np.sin(0.25 * t + phases[s])
        return (prob.A @ xt).astype(np.float32), xt

    async def serve():
        async with SolveServer(**server_kwargs) as server:
            fp = server.register(system)
            await server.submit(fp, rhs_at(0, 0)[0])  # prepare (and build)
            server.reset_stats()
            sessions = [server.open_session(fp) for _ in range(S)]

            async def stream(s: int):
                out = []
                for t in range(T):
                    b, xt = rhs_at(s, t)
                    res = await sessions[s].update(b)
                    out.append((res, float(np.abs(res.x - xt).max())))
                return out

            t0 = time.perf_counter()
            streams = await asyncio.gather(*(stream(s) for s in range(S)))
            wall = time.perf_counter() - t0
            return server.stats(), sessions, streams, wall

    stats, sessions, streams, wall = asyncio.run(serve())

    iters = np.array([[r.iterations for r, _ in st] for st in streams])  # (S, T)
    err = max(e for st in streams for _, e in st)
    total = int(iters.sum())
    cold = int(iters[:, 0].sum())  # update 0 has no history: the cold cost
    warm_mean = float(iters[:, 1:].mean()) if T > 1 else float("nan")
    print(
        f"system {args.m}x{args.n} method={args.method} "
        f"J={args.num_blocks} epochs<={args.epochs} tol={args.tol:g}"
    )
    print(
        f"replayed {S} drifting streams x {T} updates "
        f"(drift {args.drift:g}) in {wall:.3f}s "
        f"-> {S * T / wall:.1f} updates/s"
    )
    print(
        f"epochs/update: cold(first)={iters[:, 0].mean():.1f} "
        f"warm(rest)={warm_mean:.1f} "
        f"-> session total {total} vs ~{cold * T} if every update were cold"
    )
    print(
        f"batches: {stats['batches']} "
        f"(mean size {stats['mean_batch_size']:.2f}); "
        f"accuracy: max|x - x_true| = {err:.2e}"
    )


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.mode == "matfree" and args.method not in ("apc", "dapc"):
        ap.error("--mode matfree supports the consensus methods (apc/dapc)")
    if args.fault_plan and args.trace == "drifting":
        ap.error("--fault-plan replays the poisson trace; session streams "
                 "have no per-request failure slots")
    if args.mesh:
        if args.mode != "matfree":
            ap.error("--mesh shards the matfree path; pass --mode matfree")
        if args.num_blocks % args.mesh:
            ap.error(f"--num-blocks {args.num_blocks} must divide over "
                     f"--mesh {args.mesh} devices")

    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)  # no card and no --device cpu: fail first
    if args.mesh:
        from repro_torch.launch.mesh import run_ranks

        if args.kernels and dev.type == "cuda":
            from repro_torch.kernels import _build

            _build.build()  # once here, not once per rank
        run_ranks(rank_main, args.mesh, args.backend, args.device, (argv,))
        return
    _serve(args)


def _prepare_kwargs(args, mesh) -> dict:
    # use_kernels, gamma and eta join the checkpoint key only when asked
    # for, so a store the JAX package's command line wrote serves this one too
    return dict(
        method=args.method, num_blocks=args.num_blocks,
        materialize_p=False, mode=args.mode, device=args.device,
        **({"use_kernels": True} if args.kernels else {}),
        **({"gamma": args.gamma} if args.gamma is not None else {}),
        **({"eta": args.eta} if args.eta is not None else {}),
        **({"mesh": mesh} if mesh is not None else {}),
    )


def _system(args):
    """(problem, the matrix to register): the sparse COO for square systems
    (the matfree path then never densifies); augmented systems are dense."""
    from repro_torch.sparse import make_problem

    prob = make_problem(n=args.n, m=args.m, seed=args.seed, dtype=np.float32)
    return prob, (prob.coo if args.m == args.n else prob.A)


def rank_main(rank: int, argv) -> None:
    """One rank of ``--mesh D``: rank 0 serves the replay, the others follow
    its prepares and solves until it stops them."""
    from repro_torch.launch.mesh import make_host_local_mesh
    from repro_torch.serving.mesh import serve_follower, stop_followers
    from repro_torch.serving.queue import PreparedPool

    args = build_parser().parse_args(argv)
    mesh = make_host_local_mesh(args.mesh, device=args.device, backend=args.backend)
    if rank == 0:
        try:
            _serve(args, mesh)
        finally:
            stop_followers(mesh)
        return
    pool = PreparedPool(max_size=args.pool_size, **_prepare_kwargs(args, mesh))
    pool.register(_system(args)[1])
    serve_follower(pool)


def _pool_solve(server, fp, B, **solve_kwargs):
    """A direct solve on the pooled solver of ``fp``, announced to a served
    mesh's followers first."""
    prep = server.pool.get(fp)
    server.pool.announce_solve(fp, B, solve_kwargs)
    return prep.solve(B, **solve_kwargs)


def _serve(args, mesh=None) -> None:
    prob, system = _system(args)
    rng = np.random.default_rng(args.seed + 1)

    from repro_torch.obs.metrics import REGISTRY, MetricsRegistry, start_exposition
    from repro_torch.obs.trace import Tracer

    tracer = Tracer() if (args.trace_out or args.trace_jsonl) else None
    registry = MetricsRegistry()
    exposition = None
    if args.metrics_port is not None:
        exposition = start_exposition(registry, port=args.metrics_port, also=(REGISTRY,))
        host, port = exposition.server_address[:2]
        print(f"metrics: serving Prometheus exposition on "
              f"http://{host}:{port}/metrics")

    faults = None
    if args.fault_plan:
        from repro_torch.serving.faults import FaultInjector, FaultPlan

        plan = FaultPlan.load(args.fault_plan)
        faults = FaultInjector(plan)
        print(f"fault plan: {args.fault_plan} armed "
              f"({len(plan.rules)} rules, seed {plan.seed}, "
              f"poisoned requests {sorted(plan.poisoned_requests)})")
    watchdog = None
    if args.watchdog or faults is not None:
        from repro_torch.core.guard import Watchdog

        watchdog = Watchdog()

    server_kwargs = dict(
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        num_epochs=args.epochs,
        tol=args.tol,
        pool_size=args.pool_size,
        checkpoint=args.checkpoint_dir,
        metrics=registry,
        tracer=tracer,
        prepare_kwargs=_prepare_kwargs(args, mesh),
        **(
            {"solve_kwargs": {"block_history": True}}
            if args.block_history else {}
        ),
        **({"faults": faults} if faults is not None else {}),
        **({"watchdog": watchdog} if watchdog is not None else {}),
    )
    def finish_obs():
        if tracer is not None:
            if args.trace_out:
                count = tracer.export_chrome(args.trace_out)
                print(f"trace: {count} spans -> {args.trace_out} "
                      f"(Chrome trace-event; open in Perfetto)")
            if args.trace_jsonl:
                count = tracer.export_jsonl(args.trace_jsonl)
                print(f"trace: {count} spans -> {args.trace_jsonl} (jsonl)")
        if exposition is not None:
            exposition.shutdown()
            exposition.server_close()

    try:
        _run_replay(args, prob, system, server_kwargs, rng, tracer, mesh)
    finally:
        finish_obs()


def _run_replay(args, prob, system, server_kwargs, rng, tracer, mesh=None) -> None:
    from repro_torch.kernels.spmm import ops as spmm_ops
    from repro_torch.serving.queue import SolveServer, replay_trace

    if args.trace == "drifting":
        _run_drifting(args, prob, system, server_kwargs, rng)
        return

    xs = rng.standard_normal((args.n, args.requests)).astype(np.float32)
    rhs = prob.A @ xs
    gaps = rng.exponential(1.0 / args.rate, size=args.requests)
    gaps[0] = 0.0  # first request fires immediately

    faulted = server_kwargs.get("faults") is not None

    async def serve():
        async with SolveServer(**server_kwargs) as server:
            fp = server.register(system)
            # prepare the system (and build the kernels on their first use) so
            # the trace measures steady state
            await server.submit(fp, rhs[:, 0])
            server.reset_stats()  # report the trace, not the warm-up
            if faulted:
                # fault-plan `request` ids are absolute seqs; the warm-up
                # consumed some, so tell plan authors where the trace starts
                print(f"fault plan: trace request i is seq "
                      f"{server.next_request_seq} + i")
            if tracer is not None:
                tracer.clear()  # export the measured trace only

            launches0 = dict(spmm_ops.launches)  # rank 0's, over the replay
            ticker = None
            if args.stats_every > 0:

                async def tick():
                    while True:
                        await asyncio.sleep(args.stats_every)
                        s = server.stats()
                        print(f"[stats] requests={s['requests']} "
                              f"batches={s['batches']} "
                              f"mean_batch={s['mean_batch_size']:.2f} "
                              f"pool_hits={s['hits']} "
                              f"rejects={s['admission_rejects']}")

                ticker = asyncio.create_task(tick())
            t0 = time.perf_counter()
            results = await replay_trace(
                server, fp, rhs, gaps, return_exceptions=faulted
            )
            wall = time.perf_counter() - t0
            launches = {k: v - launches0[k] for k, v in spmm_ops.launches.items()}
            if ticker is not None:
                ticker.cancel()
            report = None
            if args.block_history and args.method in ("apc", "dapc"):
                # one diagnostic solve over a few replayed columns: the
                # per-block residual trace the convergence report reads
                from repro_torch.obs.convergence import convergence_report

                diag = _pool_solve(
                    server, fp, rhs[:, : min(4, rhs.shape[1])],
                    num_epochs=args.epochs, block_history=True,
                )
                report = convergence_report(diag, tol=args.tol)
            direct = None
            if mesh is not None:
                # the replayed columns solved directly on the mesh, at the
                # served width and tol: what each served answer must match
                direct = np.concatenate([
                    _pool_solve(server, fp, rhs[:, i:i + args.max_batch],
                                num_epochs=args.epochs, tol=args.tol).x
                    for i in range(0, rhs.shape[1], args.max_batch)
                ], axis=1)
            stats = server.stats()
            # watchdog verdicts land in the by-reason failure counter
            stats["watchdog_flags"] = int(
                server.metrics.value("server_failures_total", reason="nan")
                + server.metrics.value(
                    "server_failures_total", reason="stalled"
                )
            )
            prep = server.pool.get(fp)
            return (stats, results, wall, server.pool.resident(), report,
                    direct, getattr(prep, "per_device_memory_bytes", None), launches)

    stats, results, wall, resident, report, direct, per_device, launches = asyncio.run(serve())

    # under a fault plan, slot i may hold the structured failure instead of
    # a result — split, report the survivors, then summarize the failures
    failed = [(i, r) for i, r in enumerate(results) if isinstance(r, Exception)]
    ok = [(i, r) for i, r in enumerate(results) if not isinstance(r, Exception)]
    if not ok:
        raise SystemExit("every request failed — nothing to report")
    lat_ms = np.array([r.queue_ms + r.solve_ms for _, r in ok])
    err = max(float(np.abs(r.x - xs[:, i]).max()) for i, r in ok)
    sizes = Counter(r.batch_size for _, r in ok)
    unconverged = sum(not r.converged for _, r in ok)

    print(
        f"system {args.m}x{args.n} method={args.method} "
        f"J={args.num_blocks} epochs={args.epochs}"
    )
    print(
        f"replayed {args.requests} requests at ~{args.rate:.0f} req/s "
        f"(poisson, seed {args.seed}) in {wall:.3f}s "
        f"-> {args.requests / wall:.1f} req/s served"
    )
    print(
        f"latency ms: p50={np.percentile(lat_ms, 50):.1f} "
        f"p90={np.percentile(lat_ms, 90):.1f} "
        f"p99={np.percentile(lat_ms, 99):.1f} max={lat_ms.max():.1f}"
    )
    print(
        f"batches: {stats['batches']} "
        f"(mean size {stats['mean_batch_size']:.2f}, "
        f"full {stats['full_batches']}, "
        f"timeout-flushed {stats['timeout_flushes']}); "
        f"per-request sizes {dict(sorted(sizes.items()))}"
    )
    print(
        f"pool: hits={stats['hits']} misses={stats['misses']} "
        f"(prepares={stats['prepares']} restores={stats['restores']}, "
        f"restore {stats['restore_ms']:.1f}ms total) "
        f"evictions={stats['evictions']}"
    )
    print(
        f"accuracy: max|x - x_true| = {err:.2e}; "
        f"unconverged columns (tol={args.tol:g}): {unconverged}"
    )
    if args.fault_plan:
        from repro_torch.serving.faults import SolveFailure

        print(
            f"faults: {len(failed)}/{args.requests} requests failed, "
            f"{stats.get('recovered_requests', 0)} recovered after faults, "
            f"{int(stats.get('retries', 0))} recovery dispatches, "
            f"watchdog flags={stats.get('watchdog_flags', 0)}"
        )
        for i, f in failed:
            if isinstance(f, SolveFailure):
                print(f"  request {i}: FAILED reason={f.reason} "
                      f"attempts={f.attempts} (seq {f.request})")
            else:
                print(f"  request {i}: FAILED {type(f).__name__}: {f}")
    for entry in resident:  # which execution path each pooled system used
        print(
            f"pool: system {entry['fingerprint']} path={entry['path']} "
            f"factors={entry['memory_bytes'] / 1e6:.2f}MB "
            f"solves={entry['num_solves']}"
        )
    if direct is not None:
        import torch.distributed as dist

        worst = max(
            float(np.abs(r.x - direct[:, i]).max() / np.abs(direct[:, i]).max())
            for i, r in ok
        )
        print("mesh: " + json.dumps({
            "ranks": args.mesh, "backend": dist.get_backend(),
            "per_device_mb": per_device / 1e6, "requests": args.requests,
            "answered": stats["requests"], "failed": len(failed),
            "req_per_s": args.requests / wall,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "batches": stats["batches"], "launches_rank0": launches,
            "worst_rel_diff_vs_direct": worst,
            "bit_equal_vs_direct": sum(
                bool(np.array_equal(r.x, direct[:, i])) for i, r in ok),
        }))
    if report is not None:
        rates = report["rates"]
        print(
            f"convergence: J={report['num_blocks']} blocks over "
            f"{report['num_epochs']} epochs; slowest block "
            f"{report['slowest_block'][0]} (rate {rates.max():.4f}), "
            f"fastest {report['fastest_block'][0]} "
            f"(rate {rates.min():.4f}); "
            f"final-residual imbalance {report['imbalance'][0]:.2f}x"
        )


if __name__ == "__main__":
    main()
