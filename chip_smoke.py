#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

1. prints the card (nvidia-smi name and power limit) and turns TF32 off;
2. builds the hand-written kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, in parallel) and prints nvcc's ``-Xptxas -v`` report;
3. holds each dense-path kernel against its plain PyTorch version on the
   card at the main path's shapes (and the consensus update at the dense
   scale run's W (8, 2048, 4096), k = 64), and times the kernel, the plain
   version and one PyTorch library call computing the same function (a
   yardstick only; the port never calls it); the loop's residual kernel
   (``kernels/residual``) at the benchmark cells' shapes (s5 A (8, 2282,
   4563), k = 32; t1 A (8, 1164, 2327), k = 256), the main path's and the
   scale run's, within 1e-4 relative of a float64 residual, its library
   yardstick cuBLAS's product plus ATen's sums (the plain version on the
   card), and at k = 1 and in float64, which the plan keeps on the
   library; then times two design choices
   of the consensus update, ungated: W's unaligned rows against a copy
   padded to a multiple of 4 columns, and its split target;
4. drives the dense main path — ``repro_torch.launch.solve`` with
   ``--kernels --implicit-p`` at the paper's Table 1 shape m=9308, n=2327,
   k=32, 80 epochs, J=2 (tall: the upper trisolve) and J=8 (wide: the lower
   trisolve on Rᵀ) — with every launch counter zeroed just before and read
   just after (a residual call for x̄(0) and one an epoch), and checks the solution against the kernels-off solve on the
   card and the residual against the JAX package's CPU value; times a
   second, warm solve on each prepared solver and profiles one more with
   torch.profiler (device time by kernel, device busy share); then one
   timed, ungated scale run at n=4096, m=16384, J=8, k=64;
5. drives the matrix-free path the same way — ``--mode matfree --kernels``
   at the paper's square n=2327 (99.85% sparse), k=32, 300 epochs, J=8,
   with the accelerated (γ, η) = (2.0, 1.9) and the direct Gram solver;
   then ``--mode auto`` at n=16384, 100 epochs, which must resolve the
   matrix-free path with the PCG Gram solver. Each must launch the fused
   packed pass once per epoch, and is checked against the kernels-off solver
   restored from its own state on the card (within 2.5e-4·max|x|), the
   n=2327 residual against the JAX package's CPU value. The warm solve's
   peak device memory and its largest difference from the cold solve are
   printed;
6. holds the SpMM kernels against their plain versions on the operators
   those runs prepared (forward, transposed and Gram shards): the
   packed-nonzero ``spmm_packed`` on each operator's packed form and the
   fused packed pass on the forward and transposed packed forms (also bit
   for bit against two ``spmm_packed`` launches); each timed beside
   ``torch.sparse.mm`` (cuSPARSE) of the same shards laid out as
   block-diagonal CSR matrices (one call, or the pair for the fused pass).
   ``bound_ms`` counts the bytes the product needs (each nonzero's
   value and column, the row pointers, x, y and the outputs once),
   ``bound_ell_ms`` the stored ELL arrays;
7. runs the dgd and cgnr baselines through ``repro_torch.launch.solve
   --method dgd|cgnr`` at the Table 1 width (m=9308, n=2327, J=8, k=32, 80
   epochs; plain batched matmuls, no hand kernel), checks each residual
   against the JAX package's CPU value, prints dgd's step size beside the
   JAX package's, and times and profiles a warm solve;
8. replays a drifting stream (12 updates of 32 streams as columns, the
   reference's b_t = A(x_base + 2e-3·sin(0.25 t + i))) through a ``Session``
   over the kernels-on dense solver (the Table 1 wide system, implicit
   projector) and over the kernels-on matrix-free solver (n=2327, direct
   Gram solver), against independent cold solves at one tol (3x the cold
   floor at the 300-epoch cap): every update below tol and within 5·tol of
   its cold solve, the session's total epochs at most 0.7x the independent
   total, the watchdog all ok; one warm update's launches counted (one
   trisolve and 300 consensus updates dense; 300 fused packed passes and the
   warm start's ``spmm_packed`` matrix-free); the same
   stream on the kernels-off solver restored from each solver's state,
   held at the solve gates; and one warm-started session solve profiled;
9. plants a NaN in one column of b on both kernel paths, which the watchdog
   must flag alone, and checks that a matrix-free ``block_history`` solve
   returns x bit for bit, printing its per-block convergence report;
10. serves requests through the port's ``SolveServer`` (``repro_torch.serving``,
   kernels on, max_batch 32, 5 ms window, cap 300) on both systems: the
   serving command line's Poisson trace (256 requests at 2000 req/s; every
   request answered once, within the kernels-on/off gate (1e-4·max(1,
   max|x|) dense, 2.5e-4·max|x| matrix-free) of a direct solve of its column
   at the served width and within one epoch of it, the summed epochs within
   2% of the JAX package's, the served batches launching the path's
   kernels, counted around the replay), one profiled served batch, the
   session phases' streams as 32 one-column ``ServerSession``s (epochs
   within 2% of the JAX package's own server replay, at most 0.7x the
   independent solves'), 32 requests at max_batch 1 and 32 (printed), a
   checkpoint save and a restore by a fresh server with a pool of one (no
   prepare, served bits equal to the saved solver's, the evicted dense
   solver's memory released), and a fault plan on the dense replay (the
   poison fails alone, a one-shot error is redispatched, the watchdog flags
   the NaN column alone); prints the serving numbers beside the card line;
11. runs the multi-device path (``torch.distributed``): the reference's
   sharded configuration (``benchmarks/sparse_sharded.py``: the paper-size
   Schenk-like system of seed 5, J = 8, k = 32, 300 epochs, (γ, η) = (2.0,
   1.9), kernels on) on a one-rank ``nccl`` mesh in this process, held
   against the unsharded kernels-on solver (1e-5·max|x|, residual history,
   ``iterations_to_tol``; bit-equality printed), with one fused packed pass
   per epoch and the audited epoch's collectives; then, on one spawn of 4
   ``gloo`` ranks on the one card (``run_ranks(run_commands, ...)``), the
   rank bodies of ``launch.solve --mode matfree --mesh 4`` at the
   matrix-free path's two sizes (PCG at n=16384), held against phase 5's
   single-host solves (2.5e-4·max|x|), each rank at most 1.15/4 of their
   bytes, one fused packed pass per epoch per rank and the audited epoch;
   the dense ``solve_sharded`` at the Table 1 width on one ``nccl`` rank and
   on 4 ``gloo`` ranks (1e-5 apart), ``solve_sharded_2d`` on a (2, 2) mesh
   (1e-4 from one rank, at n = 2328: the model axis halves n); and the
   serving command line's Poisson trace at 64 requests through
   ``serve_solver --mesh 4 --backend gloo`` (every request answered,
   within 2.5e-4·max|x| of a direct sharded solve in the same run); then
   times the SpMM kernels on a rank's shard;
12. runs the model stack's serving path (``repro_torch.models``,
   ``serving.decode``, ``launch.serve``): the four dense archs' reduced
   configs at 3 layers on the card against the port's CPU path from the
   same weights (prefill logits within 1e-4·max, a 4-step decode
   continuation within 2e-2·scale); granite-3-2b at full width (40 layers,
   d_model 2048, 2.53e9 f32 parameters from a CUDA ``torch.Generator``): a
   1 x 16 prompt and 8 decode steps on the card against the CPU (1e-3 /
   2e-2), the prefill continuation against token-by-token decode on the
   card (2e-2·scale), greedy ``generate`` at batch 4, prompt 128, 32 new
   tokens timed (prefill, decode per step, tokens/s, peak memory) beside the
   cost model's bounds, one decode step profiled, and ``python -m
   repro_torch.launch.serve`` at that size as a subprocess; then the linear
   probe (``launch.linear_probe``): the reference's reduced configuration at
   its MSE < 1e-4 gate, and the full-width probe (features (8192, 2048), J =
   8 wide blocks) with the kernels, counted around the run (1 trisolve, 150
   consensus updates) and held against the kernels-off solve (1e-4·max(1,
   max|x|)); the two kernels against their plain versions at the probe's
   shapes; prints a ``{"model": ...}`` summary line (the reduced card-vs-CPU
   parity runs all ten archs: the dense four at 3 layers, the six below at
   ``reduced_config``);
13. serves the other six families at full width (``FAMILIES``: f32 weights
   from a CUDA ``torch.Generator``, bf16 caches, depth cut only where the f32
   weights would not fit beside a CPU copy or on the card, keeping the
   arch's pattern; a vision cross gate set to 0.5): deepseek-moe-16b (4 of 28
   layers), deepseek-v2-236b (2 of 60), zamba2-7b (15 of 81: two periods and
   the tail), xlstm-1.3b (all 48), llama-3.2-vision-90b (5 of 100: one
   period) and whisper-small (all): the parameter count against
   ``count_params``; where a CPU copy fits, a 1 x 16 prompt and 4 decode steps
   against the CPU (phase 12's gates) with the MoE routing of every call
   equal on >= 99.9% of (token, slot) pairs (each difference printed with its
   probability margin); the family's own property on the card (decode vs
   teacher forcing at 0 MoE drops; prefill continuation vs token by token,
   xlstm-1.3b's on its first period and, layer by layer at all 48, with
   token by token against teacher forcing within the perturbation envelope;
   the shared block's two caches, the cross cache written once, every state
   finite; whisper's position-0 decode pinned and its encoder skipped in
   decode); ``generate`` at batch 4, prompt 128, 32 new timed beside the cost
   model's bounds (the decode step's bytes count every expert), one decode
   step profiled; then ``launch.serve`` for whisper-small, xlstm-1.3b and
   zamba2-7b at their full configs; prints a ``{"families": ...}`` line;
14. trains the model stack (``repro_torch.training``, ``models.losses``,
   ``launch.train``): (a) one ``loss_fn`` step with gradients for each of
   the ten reduced archs on the card against the port's CPU path from the
   same weights, f32 compute at 1e-5 (loss) and 1e-4·max|g|, MoE routing
   equal first, and in the arch's own bf16 compute finite with some
   gradient nonzero and every matrix of every block call (recompute
   included) a bf16 copy, where the f32 run computes on the masters; (b) flash attention's backward at granite-3-2b's
   attention shapes (1 x 4096, 32 heads over 8, d 64, chunk 1024) against
   autograd of the plain core in f32 (1e-4·max) and bf16 (5e-2·max), and
   the chunked cross-entropy at (2, 4096, 2048) x 49408 against a
   full-logits ``F.cross_entropy``; (c) granite-3-2b at full width, its
   depth cut from 40 layers to 20 (f32 masters, bf16 compute, block remat,
   S 4096, the global batch cut from 256 to 2) for 30 steps of
   ``train_loop.train``:
   every logged number finite, the logged loss falling (the mean of the
   last 5 below the first 5's, the last below the first), the loss on step
   1's batch lower after training, a first-order descent check in f32, the
   median warm step,
   tokens/s and peak memory beside ``costs.step_cost``'s bound, one step
   profiled; (d) in a fresh process with the cuBLAS workspace fixed and
   deterministic algorithms, an exact restart at full width cut to 2
   layers (fail at step 4 of 6, checkpoints every 2, resume), the card's
   checkpoint restored on the CPU with the reference's leaf names; (e) int8
   gradient compression on the reference test's tiny config; (f) ``python
   -m repro_torch.launch.train`` with ``--fail-at`` (beside the
   uninterrupted run, two children at once) and a rerun that ends at the
   uninterrupted final loss; prints a ``{"train": ...}`` line;
15. checks the mesh rules and the dry run (``distributed.sharding``,
   ``launch.dryrun``, ``launch.multihost``, ``checkpoint.restore(...,
   shardings=)``): (a) ``python -m repro_torch.launch.dryrun --both-meshes``
   as a subprocess over its fake 256/512-rank groups, 64 cells ok and 16
   skipped exactly where ``configs.shapes.applicable`` says, each cell's
   per-rank argument GiB printed; (b) xlstm-1.3b x ``long_500k`` at full
   width (batch 1, 524288 positions), the one cell one card holds whole, on
   the one-rank ``nccl`` mesh of ``make_debug_mesh``: the dry run's argument
   bytes equal the reference's 4,593,267,368, ``dryrun.materialize`` places
   its arguments on the card under their placements (weights from a CUDA
   ``torch.Generator``): the allocations ask for exactly that number, and
   ``memory_allocated`` grows by it within the caching allocator's rounding
   (512 bytes per tensor, and an unsplit remainder of at most 1 MiB per
   tensor over 1 MiB); one decode step on them, its ms and its peak minus
   the arguments (the temporaries the dry run does not count);
   (c) a reduced granite-3-2b train state saved with ``checkpoint.save`` and
   restored onto that mesh with ``shardings=`` from ``named_shardings``,
   bit-equal under the placements asked for; (d) ``multihost.initialize`` in
   two child processes, one with ``COORDINATOR_ADDRESS``/``NUM_PROCESSES=1``/
   ``PROCESS_ID=0`` (an ``nccl`` group), one without them (no group), both
   {0, 1, 1, 1}; prints a ``{"dryrun": ...}`` line;
16. runs the examples and the trace report as a user runs them, each a
   child process through its ``main`` with the launch counters zeroed just
   before and read just after (``EXAMPLE_CHILD``): (a)
   ``examples/quickstart_torch.py`` with and without ``--kernels`` (the
   reference's max |x̂ - x| < 1e-3; the two solutions within 1e-4·max(1,
   max|x|); 1 trisolve and 100 consensus updates); (b)
   ``examples/solve_sparse_torch.py --full --kernels`` (the paper's 18252 x
   4563, 75% dense after augmentation: the dense path, J = 4 square tall
   blocks): its lines, 2 trisolves and 95 consensus updates, every number
   finite, the acceleration printed, not gated; then the default n = 1141
   with and without ``--kernels``: the dapc solution and the batched k = 8
   solution within the same gate, the batched max relative error below 1e-3
   (at --full the blocks are numerically rank-deficient and the error is
   O(1) in the JAX package too: ``solve_sparse_run``); (c) the two kernels
   against their plain versions at those two scripts' shapes; (d)
   ``examples/train_lm_torch.py`` at its default lm-100m (300 steps) and
   ``--small --steps 150``, each on a fresh ``--ckpt-dir``, with step ms,
   tokens/s, peak memory and each checkpoint save's seconds: --small at the
   reference's loss drop > 0.1; lm-100m's drop printed, not gated (the
   recipe's lr 3e-3 makes its loss rise in the JAX package too:
   ``train_lm_run``), beside the first 80 steps of a control at lr 3e-4;
   then the default again on the first directory, which resumes at step
   300; (e)
   ``python -m repro_torch.launch.serve_solver --kernels`` at 64 requests
   with ``--trace-out`` and ``--trace-jsonl``, and
   ``tools/trace_report_torch.py`` on both files: the report names queue,
   solve and batch, its batch sizes hold the 64 requests, and the two
   files give one report; prints an ``{"examples": ...}`` line;
17. prints the kernel table as one JSON line (with a row per kernel of one
   warm session update, of one served batch, of the multi-device runs, of
   the probe's solve and of the two examples' solves, carrying the measured
   case of the same shapes), the card line again, and the ``{"ok": true,
   "device": ...}`` line last.

The kernel cases are timed twice: with CUDA events around
back-to-back calls (``ms``, which includes the Python wrapper's host cost
where a call is shorter than it) and as a CUDA-graph replay of the same
calls, which the card runs without waiting for the host (``device_ms``;
``library_device_ms`` for the library call).

Any failed check raises, so the run exits non-zero and prints no last line.
Without CUDA, or without the repository beside it, it exits non-zero too.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

SRC = Path(__file__).resolve().parent / "src"

# final_residual_sq_max of the JAX package on the CPU for the same solves:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.solve --n 2327 \
#       --m 9308 --blocks {2,8} --epochs 80 --rhs 32 --implicit-p
JAX_CPU_RESIDUAL = {2: 9.247297384717967e-06, 8: 2080.2412109375}
# ... and for the matrix-free solve:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.solve --n 2327 \
#       --m 2327 --blocks 8 --mode matfree --rhs 32 --epochs 300 --gamma 2.0 --eta 1.9
JAX_CPU_MATFREE_RESIDUAL = 7.070346832275391
# ... and for the baselines at the Table 1 width:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.solve --n 2327 \
#       --m 9308 --blocks 8 --epochs 80 --rhs 32 --method {dgd,cgnr}
JAX_CPU_BASELINE_RESIDUAL = {"dgd": 1777464.5, "cgnr": 205.1161346435547}
# dgd's step size 1/λ_max from the JAX package's prepare of that system (its
# power iteration starts at a jax.random vector, the port's at a torch one):
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import numpy as np, repro.core as c, \
#       repro.sparse as s; print(c.prepare(s.make_problem(n=2327, m=9308, seed=0, \
#       dtype=np.float32).A, method='dgd', num_blocks=8).factors[0])"
JAX_CPU_DGD_LR = 1.2971216161973197e-05
RESIDUAL_FACTOR = 10.0  # the card's residual must lie within 10x either way
# the drifting streams of the session phases (``drift_stream``), replayed by
# the JAX package on the CPU through ``replay_stream``, which imports nothing:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import chip_smoke, repro.core, \
#       repro.sparse; chip_smoke.print_stream_reference(repro.core.prepare, \
#       repro.sparse.make_problem)"
# session and independent totals of epochs-to-tol over the 12 updates, and tol
JAX_CPU_STREAM = {
    "dense": {"session": 2239, "independent": 22644, "tol": 52.462440490722656},
    "matfree": {"session": 3572, "independent": 38640, "tol": 9.843310117721558},
}
STREAM_UPDATES, STREAM_COLS, STREAM_SEED, STREAM_AMP = 12, 32, 2, 2e-3
# the epoch cap of every session solve: the JAX CPU replay reaches the
# reference streaming benchmark's 0.5 ratio at it (0.0989 dense, 0.0924
# matrix-free); the card is gated at the reference test's 0.7
STREAM_CAP = 300
SESSION_RATIO_GATE = 0.7
# the serving phases: the serving command line's Poisson trace (256 requests
# at 2000 req/s, seed 0) through a SolveServer of max_batch 32, 5 ms window,
# cap STREAM_CAP, on the session phases' systems
SERVE_REQUESTS, SERVE_RATE, SERVE_BATCH, SERVE_WAIT_MS = 256, 2000.0, 32, 5.0
# the JAX package on the CPU for the same traffic: the Poisson tol (3x the cold
# floor of the first 32 requests at the cap, as stream_tol) and the summed
# epochs-to-tol of the 256 requests at it (batched solves at the served width;
# a column's count does not depend on its batchmates), and the drifting
# streams' summed epochs-to-tol through the JAX package's own SolveServer
# (32 one-column sessions, the session phases' tol), which equal the direct
# sessions' JAX_CPU_STREAM totals:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import chip_smoke, repro.core, \
#       repro.sparse, repro.serving.queue; chip_smoke.print_serving_reference( \
#       repro.core.prepare, repro.sparse.make_problem, repro.serving.queue.SolveServer)"
JAX_CPU_SERVING = {
    "dense": {"poisson_tol": 56.739200592041016, "poisson_iterations": 13761,
              "drifting_iterations": 2239},
    "matfree": {"poisson_tol": 10.222836256027222, "poisson_iterations": 25451,
                "drifting_iterations": 3572},
}
SERVING_ITER_GATE = 0.02  # summed epochs-to-tol within 2% of the JAX package's
# kernels-on vs kernels-off matrix-free solutions, as a share of max|x|: the
# reference's own full-size gate between two float32 trajectories
# (benchmarks/sparse.py)
MATFREE_AGREEMENT = 2.5e-4

# phase 11: the reference's sharded configuration (benchmarks/sparse_sharded.py
# :59-66,120-133), its paper-scale parity gate RELERR_GATE and its per-rank
# memory gate DEVICE_FRACTION_GATE = 1.15/D; the dense solvers at the
# reference tests' tolerances (tests/test_distributed_solver.py:36, :229)
MESH_N, MESH_SPARSITY, MESH_SEED, MESH_RHS_SEED = 2327, 0.9985, 5, 11
MESH_RANKS = 4
MESH_RELERR_GATE = 2.5e-4
MESH_FRACTION_GATE = 1.15 / MESH_RANKS
# the mesh replay serves the serving command line's Poisson trace at 64
# requests, not the serving phases' 256: each 4-rank gloo batch takes seconds,
# and its gates compare every answer with the same run's direct solve
MESH_SERVE_REQUESTS = 64
DENSE_SHARDED_ATOL, DENSE_2D_ATOL = 1e-5, 1e-4

# phase 12: the model stack's serving path at granite-3-2b's full width
# (src/repro_torch/configs/granite_3_2b.py: 40 layers, d_model 2048, 32 heads,
# 8 KV heads, d_ff 8192, vocab 49155), f32 weights, bf16 KV cache; the
# reduced parity runs the four dense archs at 3 layers. Gates: prefill logits
# card against CPU at 1e-4·max|logits| reduced, 1e-3 at full width (40 f32
# layers on two devices' gemms); decode continuations at the reference's
# 2e-2·scale (tests/test_model_properties.py:116)
MODEL_ARCH = "granite-3-2b"
MODEL_PARITY_ARCHS = ("granite-3-2b", "granite-3-8b", "gemma-7b", "qwen1.5-32b")
MODEL_PREFILL_GATE = {"reduced": 1e-4, "full": 1e-3}
MODEL_DECODE_GATE = 2e-2
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 128, 32
PROBE_EPOCHS = 150
# phase 13: the other six families at full width (src/repro_torch/configs/<arch>.py),
# f32 weights drawn on the card, bf16 caches. Depth is cut only where the f32
# weights would not fit beside a CPU copy, or on the card: "cut" keeps that
# many leading and trailing layers of the arch's own list (None: all), so the
# pattern stays; "params" is count_params of the cut config; "cpu" marks the
# card-vs-CPU parity run (phase 12's gates); "check" the on-card property the
# reference tests for the family, gated at MODEL_DECODE_GATE with 0 MoE drops.
# "gate_layers": those two run on the arch's first period (same weights), as
# xlstm-1.3b's 48 layers without pre-norms are chaotic at random init: a 1e-7
# perturbation of the embeddings grows to O(1) by layer 24 on the card and
# on the CPU alike. Every CPU-parity arch is also held, layer by layer at its
# full depth, within ENVELOPE_FACTOR of that perturbation's spread; a
# "gate_layers" arch's prefill continuation and token-by-token decode are
# held so at full depth too, against teacher forcing.
FAMILIES = {
    "deepseek-moe-16b": {"cut": (4, 0), "params": 2_561_165_312, "cpu": True,
                         "check": "teacher"},
    "deepseek-v2-236b": {"cut": (2, 0), "params": 8_468_526_080, "cpu": False,
                         "check": "teacher"},
    "zamba2-7b": {"cut": (12, 3), "params": 1_333_887_888, "cpu": True,
                  "check": "continuation"},
    "xlstm-1.3b": {"cut": None, "params": 1_942_837_584, "cpu": True, "check": "continuation",
                   "gate_layers": 8},
    "llama-3.2-vision-90b": {"cut": (5, 0), "params": 5_479_956_481, "cpu": False,
                             "check": "continuation"},
    "whisper-small": {"cut": None, "params": 238_187_532, "cpu": True, "check": "position0"},
}
FAMILY_CLI = ("whisper-small", "xlstm-1.3b", "zamba2-7b")  # launch.serve at full configs
ROUTING_GATE = 0.999  # (token, slot) pairs routed alike on the card and the CPU
PERTURBATION = 1e-7  # relative, on the embedding table, for the layer envelope
ENVELOPE_FACTOR = 10.0

# phase 14: training (src/repro_torch/training, models/losses.py, launch/train.py)
TRAIN_ARCH = "granite-3-2b"
TRAIN_SEQ, TRAIN_BATCH = 4096, 2  # train_4k's sequence (configs/shapes.py); batch cut 256 -> 2
# launch/train.py's recipe (launch.train.opt_config) at OptConfig's default
# learning rate, chosen after the launch's --lr 3e-3 default (sized for
# reduced configs) made the full-width loss rise (PERF.md section 6). Over
# 10 steps the logged loss rises with the warmup; it falls over 30, so the
# gate compares the mean of the last TRAIN_WINDOW logged losses with the
# first TRAIN_WINDOW's, and the last loss with the first.
TRAIN_STEPS, TRAIN_WINDOW = 30, 5
# (c)'s depth, cut from granite-3-2b's 40 layers to pay for phase 16 (every
# width kept; all 40 are measured in PERF.md section 5)
TRAIN_LAYERS = 20
TRAIN_LR = 3e-4
# the descent check at full width, f32 compute: one step of size eta along
# -g with eta·|g|² = DESCENT_DROP must lower the loss on the same batch by
# 0.5–1.5x that (a first-order check of the full-width gradient)
DESCENT_DROP = 0.05
TRAIN_F32_GATE = {"loss": 1e-5, "grads": 1e-4}  # reduced archs, card vs CPU, f32 compute
FLASH_GATE = {"float32": 1e-4, "bfloat16": 5e-2}  # flash backward vs autograd of the plain core
RESTART_LAYERS, RESTART_STEPS, RESTART_FAIL_AT, RESTART_EVERY = 2, 6, 4, 2
TRAIN_CLI_STEPS, TRAIN_CLI_FAIL_AT = 40, 20
# the reference test's tiny config (tests/test_training.py:18-25)
TINY_TRAIN = dict(name="tiny", family="dense", num_layers=2, d_model=32, num_heads=2,
                  num_kv_heads=2, d_ff=64, vocab_size=64, attn_chunk_q=0, xent_chunk=16,
                  remat="none")

# phase 15: the mesh rules and the dry run (distributed/sharding.py,
# launch/dryrun.py, launch/multihost.py, checkpoint.restore(shardings=)).
# The sweep: 10 archs x 4 shapes x 2 meshes, long_500k only where
# configs.shapes.applicable runs it (zamba2-7b, xlstm-1.3b)
DRYRUN_COUNTS = {"ok": 64, "skip": 16, "fail": 0}
# the one cell one card holds whole, at full width on a (1, 1) mesh, and the
# reference's per-device argument bytes of it: the JAX package's build_cell on
# AbstractMesh((1, 1), ("data", "model")), each argument struct at its shard
# shape (tests/test_torch_dryrun.py::_reference_bytes computes it that way):
#   JAX_PLATFORMS=cpu PYTHONPATH=src:tests python -c "import test_torch_dryrun as t; \
#       print(t._reference_bytes('xlstm-1.3b', 'long_500k', (1, 1)))"
DRYRUN_CARD_CELL = ("xlstm-1.3b", "long_500k")
JAX_CPU_CARD_CELL_BYTES = 4_593_267_368
ALLOC_ROUND = 512  # the caching allocator rounds each block up to 512 bytes
ALLOC_LARGE_REMAINDER = 1 << 20  # and leaves a large block whole when <= 1 MiB would remain
RESTORE_STEPS = 2  # reduced granite-3-2b trained this far, so the moments are not zeros

# phase 16: the examples and the trace report (examples/*_torch.py,
# tools/trace_report_torch.py), each a child process run as a user runs it.
# The reference's gates: quickstart's max |x̂ - x| < 1e-3, train_lm's loss drop
# > 0.1, solve_sparse's batched max relative error < 1e-3; kernels on against
# off within the dense gate 1e-4·max(1, max|x|) (section 2 of PERF.md)
QUICKSTART_ERR_GATE = 1e-3
SPARSE_BATCHED_GATE = 1e-3
# the quickstart's one trisolve and 100 epochs; solve_sparse --full's dapc
# solve (dense projector: the trisolve only) and its batched k = 8 solve
# (implicit projector: the trisolve and 95 epochs)
# the examples solve k = 1 and 8 right-hand sides, whose residual the plan
# keeps on the library's product: no residual launch
QUICKSTART_LAUNCHES = {"trisolve": 1, "consensus_update": 100, "residual": 0}
SPARSE_LAUNCHES = {"trisolve": 2, "consensus_update": 95, "residual": 0}
# solve_sparse --full's batched solve in the JAX package on the CPU (its
# prepare(A, method="dapc", num_blocks=4, materialize_p=False).solve(B, 95) on
# the script's problem and B): the error the reference itself reaches there
SPARSE_FULL_REFERENCE = {"batched_rel_err": 1.3319774}
TRAIN_LM_STEPS = {"lm-100m": 300, "lm-10m": 150}  # the default, and the docstring's --small
TRAIN_LM_DROP_GATE = 0.1  # the reference's (examples/train_lm.py)
TRAIN_LM_CONTROL_LR = 3e-4  # OptConfig's default, where the recipe has 3e-3
TRAIN_LM_CONTROL_STEPS = 80  # the first 80 steps of the recipe's 300-step schedule
TRACE_REQUESTS = 64
EXAMPLE_TIMEOUT = 600

TRISOLVE_SRC = "src/repro_torch/csrc/trisolve.cu"
PROJECT_SRC = "src/repro_torch/csrc/project.cu"
SPMM_SRC = "src/repro_torch/csrc/spmm.cu"
RESIDUAL_SRC = "src/repro_torch/csrc/residual.cu"
TRISOLVE_TPU = "src/repro/kernels/trisolve/trisolve.py:88"
PROJECT_TPU = "src/repro/kernels/project/project.py:71,84"
SPMM_TPU = "src/repro/kernels/spmm/spmm.py:75"
SPMM_FUSED_TPU = "src/repro/kernels/spmm/spmm.py:140"
RESIDUAL_TPU = "none: the reference's residual is plain jnp (src/repro/core/consensus.py:29)"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls, timed
    with CUDA events after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int) -> float:
    """Mean device milliseconds per call without the host's cost of making
    it: ``iters`` calls captured in one CUDA graph (after a warm-up call on
    the capture stream), replayed once and timed with CUDA events. For calls
    that do not wait on the host (kernels, library calls)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, rate: str) -> tuple[float, str]:
    """The least milliseconds the card could take: bytes over its HBM rate or
    operations over its peak for ``rate``, whichever is larger, from the H100
    SXM data-sheet peaks in ``repro_torch.models.costs``."""
    from repro_torch.models import costs

    t_bytes = nbytes / costs.HBM_BW * 1e3
    t_ops = flops / costs.PEAK_FLOPS_BY_TYPE[rate] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def kernel_cases(torch, trisolve_ops, trisolve_ref, project_ops, project_ref, cu_ref, gen,
                 results):
    """The dense kernels' case runners: each holds one kernel against its
    plain version on the card (vectors drawn from ``gen``), times the
    kernel, the plain version and the library call, and adds a row to
    ``results``."""
    dev = torch.device("cuda")

    def tri_case(name, J, n, k, dtype, lower, transpose, r):
        y = torch.randn(J, n, k, generator=gen, device=dev, dtype=dtype)
        got = trisolve_ops.trisolve(r, y, lower=lower, transpose=transpose)
        want = trisolve_ref(r, y, lower=lower, transpose=transpose)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rtol = 1e-4 if dtype == torch.float32 else 1e-9
        tol = rtol * max(1.0, float(want.abs().max()))
        iters = 20
        ms = cuda_ms(torch, lambda: trisolve_ops.trisolve(r, y, lower=lower, transpose=transpose), iters)
        plain = cuda_ms(torch, lambda: trisolve_ref(r, y, lower=lower, transpose=transpose), iters)
        op_r = r.mT if transpose else r
        lib = cuda_ms(torch, lambda: torch.linalg.solve_triangular(op_r, y, upper=not lower), iters)
        dev_ms = device_ms(torch, lambda: trisolve_ops.trisolve(r, y, lower=lower, transpose=transpose), iters)
        lib_dev = device_ms(torch, lambda: torch.linalg.solve_triangular(op_r, y, upper=not lower), iters)
        s = r.element_size()
        nbytes = J * n * (n + 1) / 2 * s + 2 * J * n * k * s
        flops = J * k * float(n) * n
        b_ms, b_by = bound(nbytes, flops, str(dtype).split(".")[1])
        results[name] = {
            "shape": f"R ({J}, {n}, {n}) y ({J}, {n}, {k}) {str(dtype).split('.')[1]}"
                     f" {'lower' if lower else 'upper'}{' on R^T' if transpose else ''}",
            "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "device_ms": dev_ms, "library_device_ms": lib_dev,
        }
        print(f"  {name:26s} err {err:.3e} (tol {tol:.1e})  kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f})  plain {plain:.4f} ms  library {lib:.4f} ms (device {lib_dev:.4f})"
              f"  bound {b_ms:.4f} ms ({b_by})")
        check(err <= tol, f"{name}: max error {err} above {tol}")

    def proj_case(name, w, k, x_dtype, with_x):
        J, p, n = w.shape
        xbar = torch.randn(J, n, k, generator=gen, device=dev).to(x_dtype)
        x = torch.randn(J, n, k, generator=gen, device=dev).to(x_dtype) if with_x else None
        gamma = torch.linspace(0.5, 1.5, J, device=dev) if with_x else 1.0
        if with_x:
            def run():
                return project_ops.consensus_update(w, x, xbar, gamma)

            def plain():
                return cu_ref(w, x, xbar, gamma)
        else:
            def run():
                return project_ops.project(w, xbar)

            def plain():
                return project_ref(w, xbar)
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        # the reference's tolerances (tests/test_kernel_project.py), scaled
        # by the input: P v cancels most of v where W spans nearly all of
        # R^n (the tall blocks), so float32 rounding follows |v|, not the
        # small result
        v_max = float(((xbar.float() - x.float()) if with_x else xbar.float()).abs().max())
        if torch.bfloat16 in (w.dtype, x_dtype):
            tol = 0.05 + 0.05 * max(v_max, float(want.float().abs().max()))
        else:
            tol = 2e-5 + 1e-4 * max(v_max, float(want.abs().max()))
        wf = w.float() if w.dtype == torch.bfloat16 else w
        xf = xbar.to(wf.dtype)
        xx = x.to(wf.dtype) if with_x else None

        def library():  # the bmm pair: v − Wᵀ(W v), plus the update when x is given
            v = xf - xx if with_x else xf
            pv = v - torch.bmm(wf.mT, torch.bmm(wf, v))
            return xx + gamma[:, None, None] * pv if with_x else pv

        ms = cuda_ms(torch, run, 20)
        plain_ms = cuda_ms(torch, plain, 5)
        lib = cuda_ms(torch, library, 20)
        dev_ms = device_ms(torch, run, 20)
        lib_dev = device_ms(torch, library, 20)
        sx = xbar.element_size()
        nbytes = J * p * n * w.element_size() + J * n * k * sx * (3 if with_x else 2)
        flops = 4.0 * J * p * n * k
        rate = "bfloat16" if w.dtype == torch.bfloat16 else "float32_3xtf32"
        b_ms, b_by = bound(nbytes, flops, rate)
        results[name] = {
            "shape": f"W ({J}, {p}, {n}) {str(w.dtype).split('.')[1]}, x̄ ({J}, {n}, {k}) "
                     f"{str(x_dtype).split('.')[1]}" + (", x and per-block γ" if with_x else ", project"),
            "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "device_ms": dev_ms, "library_device_ms": lib_dev,
        }
        print(f"  {name:30s} err {err:.3e} (tol {tol:.1e})  kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f})  plain {plain_ms:.4f} ms  library {lib:.4f} ms (device "
              f"{lib_dev:.4f})  bound {b_ms:.4f} ms ({b_by})")
        check(err <= tol, f"{name}: max error {err} above {tol}")

    return tri_case, proj_case


def gaussian_factors(torch, gen, J, rows, cols, dtype, tall):
    """W and R of the reduced QR of Gaussian blocks, as prepare() makes
    them: tall blocks (rows >= cols) give R (cols, cols), wide ones are
    factored through their transpose and give R (rows, rows)."""
    a = torch.randn(J, rows, cols, generator=gen, device="cuda", dtype=torch.float64)
    if tall:
        w, r = torch.linalg.qr(a, mode="reduced")
    else:
        q, r = torch.linalg.qr(a.mT, mode="reduced")
        w = q.mT
    return w.to(dtype).contiguous(), r.to(dtype).contiguous()


def kernel_phase(torch, trisolve_ops, trisolve_ref, project_ops, project_ref, cu_ref):
    """Each kernel against its plain version at the main path's shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    def factors(J, rows, cols, dtype, tall):
        return gaussian_factors(torch, gen, J, rows, cols, dtype, tall)

    tri_case, proj_case = kernel_cases(torch, trisolve_ops, trisolve_ref, project_ops,
                                       project_ref, cu_ref, gen, results)

    f32, f64 = torch.float32, torch.float64
    w_tall, r_tall = factors(2, 4654, 2327, f32, tall=True)
    tri_case("trisolve.upper", 2, 2327, 32, f32, False, False, r_tall)
    w_wide, r_wide = factors(8, 1164, 2327, f32, tall=False)
    tri_case("trisolve.lower_t", 8, 1164, 32, f32, True, True, r_wide)
    _, r_wide64 = factors(8, 1164, 2327, f64, tall=False)
    tri_case("trisolve.lower_t.f64", 8, 1164, 32, f64, True, True, r_wide64)
    del r_wide64
    proj_case("consensus_update.tall", w_tall, 32, f32, with_x=False)
    proj_case("consensus_update.wide", w_wide, 32, f32, with_x=False)
    proj_case("consensus_update.wide.x_gamma", w_wide, 32, f32, with_x=True)
    proj_case("consensus_update.wide.bf16", w_wide.to(torch.bfloat16), 32, torch.bfloat16,
              with_x=False)
    design_checks(torch, project_ops, gen, {"tall": w_tall, "wide": w_wide})
    w_scale, _ = factors(8, 2048, 4096, f32, tall=False)
    proj_case("consensus_update.scale", w_scale, 64, f32, with_x=False)
    return results


# (name, J, p, n, k, dtype name): the benchmark cells' shapes (s5, t1), the
# main path's (Table 1 at J = 8 wide and J = 2 tall, k = 32), the scale
# run's, and float64 and one right-hand side, which the plan keeps on the
# library's product
RESIDUAL_CASES = (
    ("residual.s5", 8, 2282, 4563, 32, "float32"),
    ("residual.t1", 8, 1164, 2327, 256, "float32"),
    ("residual.table1_wide", 8, 1164, 2327, 32, "float32"),
    ("residual.table1_tall", 2, 4654, 2327, 32, "float32"),
    ("residual.scale", 8, 2048, 4096, 64, "float32"),
    ("residual.t1.f64", 8, 1164, 2327, 32, "float64"),
    ("residual.s5.k1", 8, 2282, 4563, 1, "float32"),
)


def residual_phase(torch, residual_ops, residual_ref):
    """The loop's residual ‖A x̄ − b‖² (``kernels/residual``) against a
    float64 residual of the same card inputs: b = A x in float64 and x̄ = x
    + 1e-2 noise, so A x̄ − b cancels ~99% of A x̄, as in the loop. The
    kernel's total and per-block sums within 1e-4 relative (float32: its
    3xTF32 products are float32-accurate, and the cancellation leaves
    ~2e-4 of their rounding in each entry; 1e-10 in float64), one launch a
    call (none at k ≤ 8 or in float64, where the plan keeps the library's
    product); timed
    beside cuBLAS's product plus ATen's subtraction, squares and sums (the
    plain version on the card, which is also the library yardstick) and
    the gemm alone."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    results = {}
    for name, J, p, n, k, dt_name in RESIDUAL_CASES:
        dt = getattr(torch, dt_name)
        a = torch.randn(J, p, n, generator=gen, device=dev, dtype=dt)
        x = torch.randn(n, k, generator=gen, device=dev, dtype=dt)
        b = (a.double() @ x.double()).to(dt)
        xbar = x + 1e-2 * torch.randn(n, k, generator=gen, device=dev, dtype=dt)
        want = residual_ref(a.double(), b.double(), xbar.double(), per_block=True)
        before = residual_ops.launches
        got = residual_ops.residual_sq(a, b, xbar, per_block=True)
        calls = residual_ops.launches - before
        plain = residual_ref(a, b, xbar, per_block=True)
        torch.cuda.synchronize()

        def rel(pair):
            return max(float(((g.double() - w) / w).abs().max()) for g, w in zip(pair, want))

        err, plain_err = rel(got), rel(plain)
        tol = 1e-4 if dt == torch.float32 else 1e-10
        plan = residual_ops.plan(J, p, n, k, dt)
        ms = cuda_ms(torch, lambda: residual_ops.residual_sq(a, b, xbar), 20)
        dev_ms = device_ms(torch, lambda: residual_ops.residual_sq(a, b, xbar), 20)
        lib = cuda_ms(torch, lambda: residual_ref(a, b, xbar), 20)
        lib_dev = device_ms(torch, lambda: residual_ref(a, b, xbar), 20)
        gemm_dev = device_ms(torch, lambda: a @ xbar, 20)
        s = a.element_size()
        nbytes = s * (J * p * n + n * k + J * p * k + k)
        flops = 2.0 * J * p * n * k + 3.0 * J * p * k
        b_ms, b_by = bound(nbytes, flops, "float32_3xtf32" if dt == torch.float32 else dt_name)
        results[name] = {
            "shape": f"A ({J}, {p}, {n}) b ({J}, {p}, {k}) x̄ ({n}, {k}) {dt_name}",
            "plan": "library (k <= 8 or float64)" if plan is None else f"config {plan}",
            "max_rel_err": err, "plain_max_rel_err": plain_err, "tol": tol,
            "ms": ms, "plain_ms": lib, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "device_ms": dev_ms, "library_device_ms": lib_dev, "gemm_device_ms": gemm_dev,
        }
        print(f"  {name:22s} {results[name]['plan']}: rel err {err:.3e} (tol {tol:.0e}; "
              f"cuBLAS + ATen {plain_err:.3e})  kernel {ms:.4f} ms (device {dev_ms:.4f})  "
              f"cuBLAS + ATen {lib:.4f} ms (device {lib_dev:.4f}; the gemm alone {gemm_dev:.4f})  "
              f"bound {b_ms:.4f} ms ({b_by})")
        check(err <= tol, f"{name}: relative error {err} above {tol}")
        check(calls == (0 if plan is None else 1), f"{name}: {calls} launches for one call")
        del a, x, b, xbar, want, got, plain
    return results


def design_checks(torch, project_ops, gen, factors):
    """Two choices of the consensus-update kernel, timed on the card (device
    time by CUDA-graph replay, k = 32), printed and not gated:
    (a) W's rows as they are (n = 2327: 4-byte copies) against (b) a copy
    padded by a zero column to n = 2328, whose rows are 16-byte aligned;
    and the split target (thread blocks a pass is cut into) around its
    value."""
    dev = torch.device("cuda")
    for label, w in factors.items():
        J, p, n = w.shape
        xbar = torch.randn(J, n, 32, generator=gen, device=dev)
        n4 = -(-n // 4) * 4
        w_pad = torch.nn.functional.pad(w, (0, n4 - n)).contiguous()
        xbar_pad = torch.nn.functional.pad(xbar, (0, 0, 0, n4 - n)).contiguous()
        a = device_ms(torch, lambda: project_ops.project(w, xbar), 20)
        b = device_ms(torch, lambda: project_ops.project(w_pad, xbar_pad), 20)
        diff = float((project_ops.project(w_pad, xbar_pad)[:, :n] - project_ops.project(w, xbar))
                     .abs().max())
        print(f"  design {label}: rows as they are (n={n}) {a:.4f} ms, padded to n={n4} "
              f"{b:.4f} ms (device; max |diff| {diff:.2e})")
        default = project_ops.TARGET_BLOCKS
        times = {}
        try:
            for target in (132, 264, 528, 1056):
                project_ops.TARGET_BLOCKS = target
                plan = project_ops.split_plan(J, p, n, 32)
                times[f"{target} ({plan.splits1}x, {plan.splits2}x)"] = device_ms(
                    torch, lambda: project_ops.project(w, xbar), 20)
        finally:
            project_ops.TARGET_BLOCKS = default
        print(f"  design {label}: split target (splits pass 1, pass 2) -> device ms "
              + ", ".join(f"{key}: {t:.4f}" for key, t in times.items()))


def reset_launches(ops) -> None:
    """Every kernel's launch count to 0."""
    ops.trisolve.launches = 0
    ops.project.launches = 0
    ops.residual.launches = 0
    for key in ops.spmm.launches:
        ops.spmm.launches[key] = 0


def solver_epochs() -> float:
    """Epochs the dense solver's consensus loops have run in this process
    (its counter; a tol solve stops once every column has frozen)."""
    from repro_torch.obs import metrics

    return metrics.REGISTRY.value("solver_epochs_total")


def read_launches(ops) -> dict:
    return {"trisolve": ops.trisolve.launches, "consensus_update": ops.project.launches,
            "residual": ops.residual.launches, **ops.spmm.launches}


def residual_per_solve(launches) -> bool:
    """A dense kernels-on solve of more than 8 columns calls the residual
    kernel for x̄(0) and once an epoch: one trisolve and one consensus
    update an epoch a solve."""
    return launches["residual"] == launches["consensus_update"] + launches["trisolve"]


def main_path_run(torch, launch_solve, ops, n, m, J, k, gate):
    """One run of the user's entry point with the kernels, counters zeroed
    just before and read just after; gated runs are also checked against the
    kernels-off solve on the card and the JAX package's CPU residual."""
    argv = ["--n", str(n), "--m", str(m), "--blocks", str(J), "--epochs", "80",
            "--rhs", str(k), "--implicit-p", "--device", "cuda"]
    reset_launches(ops)
    record, prep, res, b, x_ref = launch_solve.run(argv + ["--kernels"])
    launches = read_launches(ops)
    print(f"  n={n} m={m} J={J} k={k} mode={record['mode']}: launches {launches}, "
          f"setup {prep.setup_seconds:.4f} s, solve {res.wall_seconds:.4f} s, "
          f"final_residual_sq_max {record['final_residual_sq_max']:.6e}, "
          f"final_mse_max {record['final_mse_max']:.6e}")
    check(launches["trisolve"] >= 1 and launches["consensus_update"] >= 1,
          f"J={J}: a kernel of the path was not launched: {launches}")
    check(residual_per_solve(launches),
          f"J={J}: expected a residual call for x̄(0) and one an epoch: {launches}")
    check(res.x.shape == (n, k), f"J={J}: solution shape {res.x.shape}")
    check(bool(torch.isfinite(torch.as_tensor(res.x)).all()), f"J={J}: non-finite solution")
    warm = prep.solve(b, num_epochs=80, x_ref=x_ref).wall_seconds
    print(f"    warm solve (same prepared solver, second call): {warm:.4f} s")
    out = {"record": record, "launches": launches, "setup_seconds": prep.setup_seconds,
           "solve_seconds": res.wall_seconds, "warm_solve_seconds": warm}
    if not gate:
        return out
    _, prep0, res0, _, _ = launch_solve.run(argv)
    warm0 = prep0.solve(b, num_epochs=80, x_ref=x_ref).wall_seconds
    diff = float(abs(res.x - res0.x).max())
    tol = 1e-4 * max(1.0, float(abs(res0.x).max()))
    print(f"    kernels off: solve {res0.wall_seconds:.4f} s, warm {warm0:.4f} s; "
          f"max |x_kernels - x_plain| {diff:.3e} (tol {tol:.1e})")
    profile_solve(torch, prep, b, x_ref, 80)
    check(diff <= tol, f"J={J}: kernels-on solution differs from kernels-off by {diff}")
    resid, ref = record["final_residual_sq_max"], JAX_CPU_RESIDUAL[J]
    print(f"    residual {resid:.6e} vs JAX CPU {ref:.6e} (ratio {resid / ref:.4f}, "
          f"allowed 1/{RESIDUAL_FACTOR:g}..{RESIDUAL_FACTOR:g})")
    check(ref / RESIDUAL_FACTOR <= resid <= ref * RESIDUAL_FACTOR,
          f"J={J}: residual {resid} not within {RESIDUAL_FACTOR}x of {ref}")
    out.update(plain_solve_seconds=res0.wall_seconds, max_abs_diff_vs_plain=diff)
    return out


def device_rows(prof) -> list:
    """(device µs, count, name) of every kernel a torch.profiler run saw,
    largest first."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue  # host ranges repeat the time of the kernels they launch
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    return rows


def profile_solve(torch, prep, b, x_ref, epochs, label="one warm solve", **solve_kw) -> dict:
    """Where one warm solve's time goes: device time by kernel and the
    device's busy share of the host wall time, from torch.profiler. Prints
    the eight largest rows and every row of the epoch's fused pass.
    ``solve_kw`` go to the solve (a session's warm start and tol)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = prep.solve(b, num_epochs=epochs, x_ref=x_ref, **solve_kw).wall_seconds
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"    profile of {label}: wall {wall * 1e3:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / (wall * 1e3):.1f}%), "
          f"{sum(r[1] for r in rows)} kernels run")
    for i, (dev_us, count, name) in enumerate(rows):
        if i < 8 or "spmm_fused" in name:
            print(f"      {dev_us / 1e3:9.3f} ms  x{count:<5d} {name[:90]}")
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms}


def peak_memory_solve(torch, prep, b, x_ref, epochs):
    """One solve with the device's peak allocation tracked: (result, peak
    bytes allocated during it, bytes allocated before it)."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = prep.solve(b, num_epochs=epochs, x_ref=x_ref)
    torch.cuda.synchronize()
    return res, torch.cuda.max_memory_allocated(), held


def matfree_run(torch, launch_solve, ops, n, mode, epochs):
    """The matrix-free path through the user's entry point, counters zeroed
    just before and read just after; checked against the kernels-off solver
    restored from this solver's own state on the card."""
    from repro_torch.core import matfree

    argv = ["--n", str(n), "--m", str(n), "--blocks", "8", "--mode", mode, "--kernels",
            "--rhs", "32", "--epochs", str(epochs), "--gamma", "2.0", "--eta", "1.9",
            "--device", "cuda"]
    reset_launches(ops)
    syncs0 = matfree.host_syncs
    record, prep, res, b, x_ref = launch_solve.run(argv)
    launches = read_launches(ops)
    syncs = matfree.host_syncs - syncs0
    inner = np.asarray(res.history["inner_iters"])
    fill = int(torch.count_nonzero(prep.op.fwd_data)) / prep.op.fwd_data.numel()
    print(f"  n={n} --mode {mode}: path {record['path']}, gram solver {prep.gram_solver}, "
          f"launches {launches}, setup {prep.setup_seconds:.4f} s, cold solve "
          f"{res.wall_seconds:.4f} s, final_residual_sq_max "
          f"{record['final_residual_sq_max']:.6e}, final_mse_max {record['final_mse_max']:.6e}")
    print(f"    operator on the card {prep.memory_bytes / 1e6:.3f} MB (dense blocks would be "
          f"{prep.dense_memory_bytes / 1e6:.1f} MB); forward tiles "
          f"{tuple(prep.op.fwd_data.shape)}, {100 * fill:.2f}% of their entries nonzero; "
          f"inner depth per epoch mean {inner.mean():.3f} "
          f"max {inner.max()}; host syncs in the solve {syncs}")
    packs = {name: getattr(prep.op, f"{name}_packed") for name in ("fwd", "tra", "gram")}
    check(all(p is not None for p in packs.values()), f"n={n}: the operator was not packed")
    print("    packed forms on the card: " + ", ".join(
        f"{name} {p.nnz} nonzeros {p.nbytes / 1e6:.3f} MB" for name, p in packs.items()))
    check(record["path"] == "matfree", f"n={n}: path {record['path']}, expected matfree")
    check(launches["spmm"] >= 1 and launches["spmm_fused_packed"] == epochs,
          f"n={n}: expected spmm and one fused packed pass per epoch: {launches}")
    check(res.x.shape == (n, 32), f"n={n}: solution shape {res.x.shape}")
    check(bool(np.isfinite(res.x).all()), f"n={n}: non-finite solution")
    warm_res, peak, held = peak_memory_solve(torch, prep, b, x_ref, epochs)
    warm = warm_res.wall_seconds
    cold_vs_warm = float(np.abs(res.x - warm_res.x).max())
    print(f"    warm solve (same prepared solver, second call): {warm:.4f} s, peak device "
          f"memory {peak / 1e6:.3f} MB ({held / 1e6:.3f} MB held before it); "
          f"max |x_cold - x_warm| {cold_vs_warm:.3e}")
    arrays, meta = prep.to_state()
    plain = matfree.MatrixFreePreparedSolver.from_state(
        arrays, {**meta, "use_kernels": False}, device="cuda")
    res0 = plain.solve(b, num_epochs=epochs, x_ref=x_ref)
    warm0 = plain.solve(b, num_epochs=epochs, x_ref=x_ref).wall_seconds
    diff = float(np.abs(res.x - res0.x).max())
    tol = MATFREE_AGREEMENT * float(np.abs(res0.x).max())
    print(f"    kernels off (restored from this solver's state): solve {res0.wall_seconds:.4f} s, "
          f"warm {warm0:.4f} s; max |x_kernels - x_plain| {diff:.3e} (tol {tol:.3e})")
    profile = profile_solve(torch, prep, b, x_ref, epochs)
    check(diff <= tol, f"n={n}: kernels-on solution differs from kernels-off by {diff}")
    return {"record": record, "prep": prep, "launches": launches, "host_syncs": syncs,
            "setup_seconds": prep.setup_seconds, "solve_seconds": res.wall_seconds,
            "warm_solve_seconds": warm, "plain_warm_solve_seconds": warm0,
            "warm_peak_bytes": peak,
            "max_abs_diff_cold_vs_warm": cold_vs_warm,
            "max_abs_diff_vs_plain": diff, "inner_mean": float(inner.mean()),
            "profile": profile, "x": res.x}


def block_diag_csr(torch, indices, data, num_col_blocks):
    """The J shards as one block-diagonal CSR matrix, for the library
    yardstick (``torch.sparse.mm``, cuSPARSE); the port never calls it."""
    J, R, S, bp, bn = data.shape
    j, r, s, p, b = (data != 0).nonzero(as_tuple=True)
    rows = (j * R + r) * bp + p
    cols = (j * num_col_blocks + indices[j, r, s].long()) * bn + b
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), data[j, r, s, p, b],
                                  (J * R * bp, J * num_col_blocks * bn))
    return coo.coalesce().to_sparse_csr()


def spmm_phase(torch, spmm_ops, spmm_plain, spmm_packed_plain, spmm_fused_packed_plain,
               op_small, op_big, only=None):
    """The SpMM kernels against their plain versions on the card, on the
    operators the matrix-free runs prepared (their packed forms included), at
    k = 32. ``only`` ({label: operator}) measures just the fused packed pass
    and the packed forward and Gram products on those operators."""
    from repro_torch.sparse import PartitionedBSR, generate_schenk_like
    from repro_torch.sparse.bsr import _pad_cols

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    results = {}

    def case(name, what, indices, data, packed, xb, iters=20):
        def run():
            return (spmm_ops.spmm_packed(packed, xb),)

        def plain():  # the packed kernel's plain version: a segment sum
            return (spmm_packed_plain(packed, xb),)

        got, want = run(), plain()
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        # and the function itself, on the ELL arrays
        err = max(err, float((got[0] - spmm_plain(indices, data, xb)).abs().max()))
        # the reference's own tolerance (tests/test_kernel_spmm.py): atol
        # 1e-4 plus rtol 1e-4 of the largest entry
        tol = min(1e-4 + 1e-4 * float(w.abs().max()) for w in want)
        ms = cuda_ms(torch, run, iters)
        plain_ms = cuda_ms(torch, plain, max(iters // 4, 3))
        dev_ms = device_ms(torch, run, iters)
        C = xb.shape[1]
        csr = block_diag_csr(torch, indices, data, C)
        xs = xb.contiguous().reshape(-1, xb.shape[-1])
        lib_out = torch.sparse.mm(csr, xs)
        lib_err = float((lib_out.reshape(want[0].shape) - want[0]).abs().max())
        lib = cuda_ms(torch, lambda: torch.sparse.mm(csr, xs), iters)
        lib_dev = device_ms(torch, lambda: torch.sparse.mm(csr, xs), iters)
        J, R, S, bp, bn = data.shape
        k = xb.shape[-1]
        s = data.element_size()
        nnz = int(torch.count_nonzero(data))
        x_bytes = xb[0].numel() * s * (1 if xb.stride(0) == 0 else J)
        io_bytes = x_bytes + sum(t.numel() for t in got) * s
        # what the product needs: each nonzero's value and column (int32) and
        # the int32 row pointers of the J*R*bp rows; the ELL figure streams
        # every stored tile and tile id
        need = nnz * (s + 4) + (J * R * bp + 1) * 4 + io_bytes
        ell = indices.numel() * 4 + data.numel() * s + io_bytes
        flops = 2.0 * nnz * k
        dt = str(data.dtype).split(".")[1]
        b_ms, b_by = bound(need, flops, dt)
        ell_ms, _ = bound(ell, flops, dt)
        results[name] = {
            "shape": f"{what}: indices {tuple(indices.shape)}, tiles {(bp, bn)}, k {k}, "
                     f"{nnz} nonzeros"
                     + (", x broadcast over J" if xb.stride(0) == 0 else ""),
            "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bound_ell_ms": ell_ms, "library_ms": lib,
            "device_ms": dev_ms, "library_device_ms": lib_dev,
        }
        lib_txt = f"{lib:.4f} ms (device {lib_dev:.4f}, err {lib_err:.1e})"
        print(f"  {name:24s} err {err:.3e} (tol {tol:.1e})  kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f})  plain {plain_ms:.4f} ms  library "
              f"{lib_txt}  bound {b_ms:.4f} ms ({b_by}, {need / 1e6:.2f} MB, "
              f"{flops / 1e9:.3f} GFLOP)  ELL bound {ell_ms:.4f} ms ({ell / 1e6:.1f} MB)")
        check(err <= tol, f"{name}: max error {err} above {tol}")

    def col_tiles(op, k):  # the main path's broadcast operand: padded once
        x = torch.randn(op.shape[1], k, generator=gen, device=dev)
        return op._col_tiles(x)

    def rows(op, k):  # (J, p_pad, k) row-space operand
        return torch.randn(op.num_blocks, op.p_pad, k, generator=gen, device=dev)

    def row_tiles(op, k):  # its (J, R, bp, k) view for the fused pass
        return rows(op, k).reshape(op.num_blocks, -1, op.block_shape[0], k)

    def fused_packed_case(name, op, iters):
        """The epoch's fused pass on the operator's packed forms, with the
        main path's operands: x broadcast over the blocks, y per block."""
        fwd_p, tra_p = op.fwd_packed, op.tra_packed
        xb, yb = col_tiles(op, 32), row_tiles(op, 32)

        def run():
            return spmm_ops.spmm_fused_packed(fwd_p, tra_p, xb, yb)

        def plain():
            return spmm_fused_packed_plain(fwd_p, tra_p, xb, yb)

        def pair():  # the two packed products as separate launches
            return spmm_ops.spmm_packed(fwd_p, xb), spmm_ops.spmm_packed(tra_p, yb)

        csr_f = block_diag_csr(torch, op.fwd_indices, op.fwd_data, xb.shape[1])
        csr_t = block_diag_csr(torch, op.tra_indices, op.tra_data, yb.shape[1])
        xs = xb.contiguous().reshape(-1, 32)
        ys = yb.reshape(-1, 32)

        def library():  # the torch.sparse.mm pair on block-diagonal CSR matrices
            return torch.sparse.mm(csr_f, xs), torch.sparse.mm(csr_t, ys)

        got, want, two, lib_out = run(), plain(), pair(), library()
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        tol = min(1e-4 + 1e-4 * float(w.abs().max()) for w in want)
        same = all(torch.equal(g, t) for g, t in zip(got, two))
        lib_err = max(float((o.reshape(w.shape) - w).abs().max()) for o, w in zip(lib_out, want))
        ms = cuda_ms(torch, run, iters)
        plain_ms = cuda_ms(torch, plain, max(iters // 4, 3))
        dev_ms = device_ms(torch, run, iters)
        pair_dev = device_ms(torch, pair, iters)
        lib = cuda_ms(torch, library, iters)
        lib_dev = device_ms(torch, library, iters)
        s = fwd_p.val.element_size()
        nnz = fwd_p.nnz + tra_p.nnz
        ptrs = (fwd_p.row_ptr.numel() + tra_p.row_ptr.numel()) * 4
        need = (nnz * (s + 4) + ptrs + xb[0].numel() * s + yb.numel() * s
                + sum(t.numel() for t in got) * s)
        flops = 2.0 * nnz * 32
        b_ms, b_by = bound(need, flops, str(fwd_p.val.dtype).split(".")[1])
        results[name] = {
            "shape": f"forward {fwd_p.nnz} + transposed {tra_p.nnz} nonzeros packed, rows "
                     f"{fwd_p.num_blocks} x ({fwd_p.block_rows} + {tra_p.block_rows}), k 32, "
                     "x broadcast over J, y per block",
            "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "device_ms": dev_ms, "library_device_ms": lib_dev,
            "spmm_packed_pair_device_ms": pair_dev, "identical_to_spmm_packed_pair": same,
        }
        print(f"  {name:24s} err {err:.3e} (tol {tol:.1e})  kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f}; two spmm_packed launches {pair_dev:.4f}, bit-identical {same})  "
              f"plain {plain_ms:.4f} ms  library {lib:.4f} ms (device {lib_dev:.4f}, err "
              f"{lib_err:.1e}, torch.sparse.mm pair)  bound {b_ms:.4f} ms ({b_by}, "
              f"{need / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
        check(err <= tol, f"{name}: max error {err} above {tol}")
        check(same, f"{name}: not bit-identical to the two spmm_packed launches")

    bp = (op_big or next(iter(only.values()))).block_shape[0]
    if only is not None:
        for label, op in only.items():
            fused_packed_case(f"spmm_fused_packed.{label}", op, 10)
            case(f"spmm.fwd.{label}", "forward shards", op.fwd_indices, op.fwd_data,
                 op.fwd_packed, col_tiles(op, 32), iters=10)
            case(f"spmm.gram.{label}", "Gram shards", op.gram_indices, op.gram_data,
                 op.gram_packed, _pad_cols(rows(op, 32), op.p_pad, bp), iters=10)
        return results
    for label, op in (("n2327", op_small), ("n16384", op_big)):
        iters = 20 if label == "n2327" else 10
        fused_packed_case(f"spmm_fused_packed.{label}", op, iters)
        case(f"spmm.fwd.{label}", "forward shards", op.fwd_indices, op.fwd_data,
             op.fwd_packed, col_tiles(op, 32), iters=iters)
    case("spmm.fwd.n2327.k1", "forward shards, one RHS", op_small.fwd_indices,
         op_small.fwd_data, op_small.fwd_packed, col_tiles(op_small, 1))
    case("spmm.tra.n16384", "transposed shards", op_big.tra_indices, op_big.tra_data,
         op_big.tra_packed, _pad_cols(rows(op_big, 32), op_big.p_pad, bp), iters=10)
    case("spmm.gram.n16384", "Gram shards", op_big.gram_indices, op_big.gram_data,
         op_big.gram_packed, _pad_cols(rows(op_big, 32), op_big.p_pad, bp), iters=10)
    tall = PartitionedBSR.from_coo(generate_schenk_like(2048, seed=5), 8, (16, 8),
                                   device=dev).with_packed()
    case("spmm.tile16x8", "forward shards, (16, 8) tiles", tall.fwd_indices, tall.fwd_data,
         tall.fwd_packed, col_tiles(tall, 32))
    return results


def baseline_run(torch, launch_solve, ops, method):
    """``repro_torch.launch.solve --method dgd|cgnr`` at the Table 1 width:
    no hand kernel runs (the reference's products are plain einsums, here
    batched matmuls); the residual is held against the JAX package's."""
    argv = ["--n", "2327", "--m", "9308", "--blocks", "8", "--epochs", "80", "--rhs", "32",
            "--method", method, "--device", "cuda"]
    reset_launches(ops)
    record, prep, res, b, x_ref = launch_solve.run(argv)
    launches = read_launches(ops)
    resid, ref = record["final_residual_sq_max"], JAX_CPU_BASELINE_RESIDUAL[method]
    print(f"  {method}: mode {record['mode']}, launches {launches}, setup {prep.setup_seconds:.4f} s, "
          f"solve {res.wall_seconds:.4f} s, final_residual_sq_max {resid:.6e}, "
          f"final_mse_max {record['final_mse_max']:.6e}")
    if method == "dgd":
        lr = prep.factors[0]
        print(f"    step size 1/lambda_max {lr:.10e} vs JAX CPU {JAX_CPU_DGD_LR:.10e} "
              f"(ratio {lr / JAX_CPU_DGD_LR:.4f})")
    check(res.x.shape == (2327, 32) and bool(np.isfinite(res.x).all()),
          f"{method}: solution shape {res.x.shape} or non-finite values")
    check(res.gamma is None and res.eta is None, f"{method}: gamma/eta set on a baseline")
    warm = prep.solve(b, num_epochs=80, x_ref=x_ref).wall_seconds
    print(f"    warm solve (same prepared solver, second call): {warm:.4f} s")
    print(f"    residual {resid:.6e} vs JAX CPU {ref:.6e} (ratio {resid / ref:.4f}, "
          f"allowed 1/{RESIDUAL_FACTOR:g}..{RESIDUAL_FACTOR:g})")
    check(ref / RESIDUAL_FACTOR <= resid <= ref * RESIDUAL_FACTOR,
          f"{method}: residual {resid} not within {RESIDUAL_FACTOR}x of {ref}")
    profile = profile_solve(torch, prep, b, x_ref, 80)
    return {"record": record, "warm_solve_seconds": warm, "profile": profile}


def stream_problem(make_problem, path):
    """(matrix to prepare, its dense form, prepare kwargs) of a session
    phase: the Table 1 wide system, or the paper-size square sparse one."""
    if path == "dense":
        prob = make_problem(n=2327, m=9308, seed=0, dtype=np.float32)
        return prob.A, prob.A, {"num_blocks": 8, "materialize_p": False}
    prob = make_problem(n=2327, m=2327, seed=0, dtype=np.float32)
    return (prob.coo, prob.coo.to_dense().astype(np.float32),
            {"mode": "matfree", "num_blocks": 8, "gamma": 2.0, "eta": 1.9})


def drift_stream(A):
    """The reference's streaming trace (benchmarks/streaming.py), 32 streams
    as columns: b_t = A(x_base + 2e-3·sin(0.25 t + i)), t < 12."""
    n = A.shape[1]
    x_base = np.random.default_rng(STREAM_SEED).standard_normal((n, STREAM_COLS)).astype(np.float32)
    phase = np.arange(n)[:, None]
    return [(A @ (x_base + STREAM_AMP * np.sin(0.25 * t + phase))).astype(np.float32)
            for t in range(STREAM_UPDATES)]


def stream_tol(prep, b0):
    """3x the cold solve's residual floor at the cap, the largest column's."""
    cold = prep.solve(b0, num_epochs=STREAM_CAP)
    return 3.0 * float(np.sqrt(np.max(cold.history["residual_sq"][-1])))


def replay_stream(prep, bs, tol, on_update=None):
    """The stream through a session and as independent cold solves at one
    tol. ``on_update(t, update)`` wraps each session update (the launch
    count). Returns the totals of epochs-to-tol and both results per update."""
    sess = prep.open_session(num_epochs=STREAM_CAP, tol=tol)
    independent, pairs = 0, []
    for t, b in enumerate(bs):
        res = on_update(t, lambda: sess.update(b)) if on_update else sess.update(b)
        cold = prep.solve(b, num_epochs=STREAM_CAP, tol=tol)
        independent += int(cold.iterations_to_tol(tol).sum())
        pairs.append((res, cold))
    return {"session": sess.total_epochs, "independent": independent, "tol": tol, "pairs": pairs}


def print_stream_reference(prepare, make_problem):
    """The session phases' streams replayed by a package's ``prepare`` and
    ``make_problem`` on the CPU (the JAX package's, for ``JAX_CPU_STREAM``)."""
    for path in ("dense", "matfree"):
        A, dense, kw = stream_problem(make_problem, path)
        prep = prepare(A, **kw)
        bs = drift_stream(dense)
        out = replay_stream(prep, bs, stream_tol(prep, bs[0]))
        print(json.dumps({"path": path, "session": out["session"],
                          "independent": out["independent"], "tol": out["tol"],
                          "ratio": out["session"] / out["independent"]}))


def serving_problem(make_problem, path):
    """(matrix to register, its dense form, prepare kwargs) of a serving
    phase: the session phases' systems, the dense one pinned to the dense
    path."""
    A, dense, kw = stream_problem(make_problem, path)
    return (A, dense, {**kw, "mode": "dense"}) if path == "dense" else (A, dense, kw)


def poisson_traffic(dense):
    """The serving command line's Poisson trace at seed 0: b_i = A x_i with
    x_i from default_rng(1), then the inter-arrival gaps from the same
    generator (the first request fires at once)."""
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((dense.shape[1], SERVE_REQUESTS)).astype(np.float32)
    gaps = rng.exponential(1.0 / SERVE_RATE, size=SERVE_REQUESTS)
    gaps[0] = 0.0
    return (dense @ xs).astype(np.float32), xs, gaps


def direct_iterations(prep, rhs, tol):
    """Per-request epochs-to-tol of batched solves of ``rhs`` in the served
    width, and their solutions: what a served request must reproduce."""
    iters, xs = [], []
    for i in range(0, rhs.shape[1], SERVE_BATCH):
        res = prep.solve(rhs[:, i:i + SERVE_BATCH], num_epochs=STREAM_CAP, tol=tol)
        iters.append(res.iterations_to_tol(tol))
        xs.append(res.x)
    return np.concatenate(iters), np.concatenate(xs, axis=1)


def serve_streams(server_cls, system, prepare_kwargs, bs, tol, **server_kw):
    """The session phases' streams through a package's ``SolveServer``: one
    ``ServerSession`` per column, all 32 stepping in lockstep, so each
    update's columns coalesce into one batch. Returns the summed
    epochs-to-tol of the sessions, each update's results (one list per
    update, column order) and the server's stats."""
    import asyncio

    async def run():
        async with server_cls(max_batch=SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS,
                              num_epochs=STREAM_CAP, tol=tol, prepare_kwargs=prepare_kwargs,
                              **server_kw) as server:
            fp = server.register(system)
            sessions = [server.open_session(fp) for _ in range(bs[0].shape[1])]
            updates = []
            for b in bs:
                updates.append(await asyncio.gather(
                    *(s.update(b[:, i]) for i, s in enumerate(sessions))))
            return sum(s.total_iterations for s in sessions), updates, server.stats()

    return asyncio.run(asyncio.wait_for(run(), timeout=600))


def print_serving_reference(prepare, make_problem, server_cls):
    """The serving phases' reference numbers from a package's ``prepare``,
    ``make_problem`` and ``SolveServer`` on the CPU (the JAX package's, for
    ``JAX_CPU_SERVING``): the Poisson tol (3x the cold floor of the first 32
    requests) and the summed epochs-to-tol of the 256 requests at it; the
    drifting streams' summed epochs-to-tol through the server."""
    for path in ("dense", "matfree"):
        A, dense, kw = serving_problem(make_problem, path)
        prep = prepare(A, **kw)
        rhs, _, _ = poisson_traffic(dense)
        tol = stream_tol(prep, rhs[:, :SERVE_BATCH])
        iters, _ = direct_iterations(prep, rhs, tol)
        drift, _, stats = serve_streams(server_cls, A, kw, drift_stream(dense),
                                        JAX_CPU_STREAM[path]["tol"])
        print(json.dumps({"path": path, "poisson_tol": tol, "poisson_iterations": int(iters.sum()),
                          "drifting_iterations": int(drift), "drifting_batches": stats["batches"]}))


def session_phase(torch, ops, path, make_problem, prepare):
    """A drifting stream through a session over the kernels-on solver on the
    card: every update and every independent solve below tol, each update
    within 5·tol of its cold solve, the epoch ratio under the gate; the
    launches of one update counted; the watchdog all ok; then the same
    stream on the kernels-off solver restored from this one's state."""
    A, dense, kw = stream_problem(make_problem, path)
    prep = prepare(A, use_kernels=True, device="cuda", **kw)
    bs = drift_stream(dense)
    tol = stream_tol(prep, bs[0])
    counted = {}

    def on_update(t, update):
        if t != STREAM_UPDATES // 2:
            return update()
        reset_launches(ops)  # around one warm update
        epochs = solver_epochs()
        res = update()
        counted.update(read_launches(ops), epochs_run=solver_epochs() - epochs)
        return res

    out = replay_stream(prep, bs, tol, on_update)
    ref = JAX_CPU_STREAM[path]
    ratio, ref_ratio = out["session"] / out["independent"], ref["session"] / ref["independent"]
    walls = [(r.wall_seconds, c.wall_seconds) for r, c in out["pairs"]]
    print(f"  {path} session: tol {tol:.6e} (JAX CPU {ref['tol']:.6e}); epochs session "
          f"{out['session']} / independent {out['independent']} = {ratio:.4f} (JAX CPU "
          f"{ref['session']} / {ref['independent']} = {ref_ratio:.4f}; gate {SESSION_RATIO_GATE})")
    print(f"    per update: session wall mean {np.mean([w[0] for w in walls]):.4f} s, independent "
          f"solve wall mean {np.mean([w[1] for w in walls]):.4f} s (cap {STREAM_CAP} epochs each)")
    print(f"    launches in update {STREAM_UPDATES // 2}: {counted}")
    for t, (res, cold) in enumerate(out["pairs"]):
        for name, r in (("session", res), ("independent", cold)):
            top = float(np.sqrt(np.max(r.final_residual)))
            check(top <= tol, f"{path} update {t}: {name} residual {top} above tol {tol}")
        diff = float(np.abs(res.x - cold.x).max())
        check(diff <= 5 * tol, f"{path} update {t}: session differs from cold by {diff} > 5·tol")
        health = res.assess_health(tol)
        check(health.ok, f"{path} update {t}: watchdog {health.status}")
    check(ratio <= SESSION_RATIO_GATE, f"{path}: session/independent epochs {ratio} above gate")
    if path == "dense":
        check(counted["trisolve"] == 1
              and counted["consensus_update"] == counted["epochs_run"] < STREAM_CAP
              and residual_per_solve(counted),
              f"dense update: expected 1 trisolve, a consensus update per epoch run, "
              f"fewer than {STREAM_CAP}, and a residual call for x̄(0) and each epoch: {counted}")
    else:
        check(counted["spmm_fused_packed"] == STREAM_CAP and counted["spmm"] >= 1,
              f"matfree update: expected {STREAM_CAP} fused packed passes and spmm_packed for "
              f"the warm-start projection: {counted}")
    # kernels on against kernels off, on the same card, the same stream
    arrays, meta = prep.to_state()
    meta = {**meta, "use_kernels": False}
    if meta.get("projector") is not None:
        meta["projector"] = {**meta["projector"], "kind": "implicit"}
    off = type(prep).from_state(arrays, meta, device=prep.device).open_session(
        num_epochs=STREAM_CAP, tol=tol)
    worst, its = 0.0, []
    for t, ((on_res, _), b) in enumerate(zip(out["pairs"], bs)):
        off_res = off.update(b)
        top = float(np.abs(off_res.x).max())
        gate = 1e-4 * max(1.0, top) if path == "dense" else MATFREE_AGREEMENT * top
        diff = float(np.abs(on_res.x - off_res.x).max())
        worst = max(worst, diff / gate)
        its.append((int(on_res.iterations_to_tol(tol).sum()), int(off_res.iterations_to_tol(tol).sum())))
        check(diff <= gate, f"{path} update {t}: kernels on/off differ by {diff} > {gate}")
    print(f"    kernels off (restored from this solver's state): session epochs {off.total_epochs}; "
          f"largest |x_on - x_off| / gate {worst:.3f}; iterations_to_tol per update (on, off) {its}")
    x0 = out["pairs"][-2][0].x  # the session's warm start for the last update
    profile = profile_solve(torch, prep, bs[-1], None, STREAM_CAP,
                            label="one warm-started session solve", x0=x0, tol=tol)
    return {"prep": prep, "b0": bs[0], "launches": counted, "ratio": ratio, "tol": tol,
            "profile": profile,
            "session_epochs": out["session"], "independent_epochs": out["independent"],
            "session_wall_mean": float(np.mean([w[0] for w in walls])),
            "independent_wall_mean": float(np.mean([w[1] for w in walls]))}


def watchdog_phase(sessions):
    """NaN in one column of b: exactly that column is flagged, on the dense
    and on the matrix-free direct kernel paths (solved as a session's
    independent solve, at its cap and tol); and a block_history solve of the
    matrix-free path returns x bit for bit, with its report printed."""
    from repro_torch.obs import convergence_report

    for name, run in sessions.items():
        prep, b, tol = run["prep"], run["b0"], run["tol"]
        bad = b.copy()
        bad[5, 7] = np.nan
        health = prep.solve(bad, num_epochs=STREAM_CAP, tol=tol).assess_health(tol)
        want = tuple("nan" if i == 7 else "ok" for i in range(b.shape[1]))
        print(f"  {name}: NaN planted in column 7 of b -> nan columns {health.nan_columns}, "
              f"sick columns {health.sick_columns}")
        check(health.status == want, f"{name}: watchdog verdict {health.status}")
    matfree_prep, matfree_b = sessions["matfree"]["prep"], sessions["matfree"]["b0"]
    check(matfree_prep.gram_solver == "direct", "matfree watchdog run: expected the direct solver")
    plain = matfree_prep.solve(matfree_b, num_epochs=STREAM_CAP)
    diag = matfree_prep.solve(matfree_b, num_epochs=STREAM_CAP, block_history=True)
    same = bool(np.array_equal(plain.x, diag.x))
    rep = convergence_report(diag)
    print(f"  matfree block_history: x bit-identical {same}; slowest block per column "
          f"{np.bincount(rep['slowest_block'], minlength=8).tolist()} (counts over 32 columns), "
          f"imbalance min {rep['imbalance'].min():.3f} max {rep['imbalance'].max():.3f}, "
          f"rates min {rep['rates'].min():.5f} max {rep['rates'].max():.5f}")
    check(same, "matfree: block_history changed the solution")


def pct(values, q) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def served_tolerance(path, x):
    """The kernels-on/off gate for one served solution: 1e-4·max(1, max|x|)
    dense, 2.5e-4·max|x| matrix-free."""
    top = float(np.abs(x).max())
    return 1e-4 * max(1.0, top) if path == "dense" else MATFREE_AGREEMENT * top


def profile_served_batch(torch, loop, server, fp, B):
    """One served batch of 32 requests under torch.profiler: the device
    time by kernel (CUPTI sees the worker thread's launches too) against
    the host wall of the batch, from submit to the last answer."""
    import asyncio

    from torch.profiler import ProfilerActivity, profile

    async def batch():
        return await asyncio.gather(*(server.submit(fp, B[:, i]) for i in range(B.shape[1])))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        results = loop.run_until_complete(batch())
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"    profile of one served batch of {B.shape[1]}: wall {wall * 1e3:.3f} ms (solve "
          f"{results[0].solve_ms:.3f} ms), device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / (wall * 1e3):.1f}%), {sum(r[1] for r in rows)} kernels run")
    for dev_us, count, name in rows[:6]:
        print(f"      {dev_us / 1e3:9.3f} ms  x{count:<5d} {name[:90]}")
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
            "top": [(name[:60], dev_us / 1e3) for dev_us, _, name in rows[:4]]}


def poisson_phase(torch, ops, path, make_problem, serving, card):
    """The serving command line's Poisson trace (256 requests at 2000 req/s)
    through a ``SolveServer`` of the port on the card, kernels on: every
    request answered once, by its own b, within the kernels-on/off gate of
    a direct solve of the same columns at the served width and within one
    epoch of it; the summed epochs-to-tol within 2% of the JAX package's; the served
    batches launch the path's hand kernels (counts zeroed just before the
    replay, read just after). Prints throughput, latency and queue wait
    from the server's clock, the batches, the cold first batch apart, the
    pool, the lateness of the arrivals (the GIL's share of queue wait) and
    one profiled served batch."""
    import asyncio

    A, dense, kw = serving_problem(make_problem, path)
    kw = {**kw, "use_kernels": True, "device": "cuda"}
    rhs, _, gaps = poisson_traffic(dense)
    tol = JAX_CPU_SERVING[path]["poisson_tol"]
    tracer = serving.Tracer()
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    server = serving.SolveServer(max_batch=SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS,
                                 num_epochs=STREAM_CAP, tol=tol, prepare_kwargs=kw, tracer=tracer)
    fp = server.register(A)

    async def replay():
        t_start = server.clock.now()
        reset_launches(ops)
        epochs = solver_epochs()
        t0 = time.perf_counter()
        results = await serving.replay_trace(server, fp, rhs, gaps)
        wall = time.perf_counter() - t0
        return results, {**read_launches(ops), "epochs_run": solver_epochs() - epochs}, wall, t_start

    results, launches, wall, t_start = loop.run_until_complete(asyncio.wait_for(replay(), 600))
    stats = server.stats()
    spans = tracer.spans()
    batches = sorted((s for s in spans if s.name == "batch"), key=lambda s: s.t0)
    prepare_ms = sum(s.duration_ms for s in spans if s.name == "pool.prepare")
    queue_spans = sorted((s for s in spans if s.name == "queue"), key=lambda s: s.trace_id)
    lateness = [(s.t0 - t_start - a) * 1e3 for s, a in zip(queue_spans, np.cumsum(gaps))]
    cold, warm = batches[0], batches[1:]
    profile = profile_served_batch(torch, loop, server, fp, rhs[:, :SERVE_BATCH])
    loop.run_until_complete(server.aclose())
    loop.close()
    asyncio.set_event_loop(None)
    prep = server.pool.get(fp)
    direct_its, direct_x = direct_iterations(prep, rhs, tol)

    n = len(results)
    lat = [r.queue_ms + r.solve_ms for r in results]
    queue = [r.queue_ms for r in results]
    its = np.array([r.iterations for r in results])
    nb = stats["batches"]
    per_batch = {k: v / nb for k, v in launches.items()}
    worst, bit_equal = 0.0, 0
    for i, r in enumerate(results):
        diff = float(np.abs(r.x - direct_x[:, i]).max())
        worst = max(worst, diff / served_tolerance(path, direct_x[:, i]))
        bit_equal += bool(np.array_equal(r.x, direct_x[:, i]))
    ref_total = JAX_CPU_SERVING[path]["poisson_iterations"]
    total = int(its.sum())
    print(f"  {path} Poisson replay [{card}]: {n} requests at ~{SERVE_RATE:g} req/s in {wall:.3f} s "
          f"-> {n / wall:.1f} req/s; after the cold batch {(n - cold.args['batch_size']) / (batches[-1].t1 - cold.t1):.1f} req/s")
    print(f"    latency ms p50 {pct(lat, 50):.1f} p99 {pct(lat, 99):.1f} max {max(lat):.1f}; queue wait "
          f"ms p50 {pct(queue, 50):.1f} p99 {pct(queue, 99):.1f}; arrival lateness ms p50 "
          f"{pct(lateness, 50):.3f} p99 {pct(lateness, 99):.3f} max {max(lateness):.3f}")
    print(f"    batches {nb} (mean size {stats['mean_batch_size']:.2f}, full {stats['full_batches']}, "
          f"timeout-flushed {stats['timeout_flushes']}); cold first batch "
          f"{cold.duration_ms:.1f} ms ({cold.args['batch_size']} requests, prepare "
          f"{prepare_ms:.1f} ms inside), the rest mean {np.mean([b.duration_ms for b in warm]):.1f} ms "
          f"min {min(b.duration_ms for b in warm):.1f} max {max(b.duration_ms for b in warm):.1f}")
    print(f"    pool hits {stats['hits']} prepares {stats['prepares']} restores {stats['restores']}; "
          f"launches per served batch {per_batch}")
    print(f"    against direct solves at width {SERVE_BATCH}: worst |x - x_direct| / gate "
          f"{worst:.3f}, {bit_equal}/{n} bit-equal, iterations max diff "
          f"{int(np.abs(its - direct_its).max())}; summed epochs-to-tol {total} vs JAX CPU "
          f"{ref_total} (ratio {total / ref_total:.4f}, tol {tol:.6g})")
    check(n == SERVE_REQUESTS and stats["requests"] == n and stats["failed_requests"] == 0,
          f"{path}: {stats['requests']} answered of {n}")
    check(worst <= 1.0, f"{path}: a served solution is off its direct solve by {worst:.3f} x the gate")
    check(int(np.abs(its - direct_its).max()) <= 1, f"{path}: iterations differ by more than one")
    check(abs(total / ref_total - 1.0) <= SERVING_ITER_GATE,
          f"{path}: summed epochs-to-tol {total} not within 2% of the JAX package's {ref_total}")
    if path == "dense":
        check(launches["trisolve"] == nb
              and launches["consensus_update"] == launches["epochs_run"] < STREAM_CAP * nb
              and residual_per_solve(launches),
              f"dense served batches: expected 1 trisolve per batch, a consensus update "
              f"per epoch run, fewer than {STREAM_CAP} a batch, and a residual call for x̄(0) "
              f"and each epoch (batches padded to {SERVE_BATCH} columns): {launches} over {nb}")
    else:
        check(launches["spmm_fused_packed"] == STREAM_CAP * nb and launches["spmm"] >= nb,
              f"matfree served batches: expected {STREAM_CAP} fused packed passes and spmm_packed "
              f"per batch: {launches} over {nb}")
    return {"pool": server.pool, "fp": fp, "A": A, "dense": dense, "kw": kw, "rhs": rhs,
            "tol": tol, "gaps": gaps, "direct_x": direct_x, "launches": launches,
            "per_batch": per_batch, "batches": nb, "throughput": n / wall,
            "lat_p50": pct(lat, 50), "lat_p99": pct(lat, 99), "queue_p50": pct(queue, 50),
            "queue_p99": pct(queue, 99), "mean_batch": stats["mean_batch_size"],
            "cold_batch_ms": cold.duration_ms, "prepare_ms": prepare_ms,
            "warm_batch_ms": float(np.mean([b.duration_ms for b in warm])),
            "iterations": total, "bit_equal": bit_equal, "profile": profile,
            "lateness_p99": pct(lateness, 99)}


def drifting_phase(path, run, session, serving, card):
    """The session phases' streams as 32 concurrent ``ServerSession``s of
    one column through the pooled kernels-on solver: the summed epochs-to-tol
    within 2% of the JAX package's own server replay, at most 0.7x the
    independent solves' of the session phase, every update converged."""
    t0 = time.perf_counter()
    total, updates, stats = serve_streams(
        serving.SolveServer, run["A"], run["kw"], drift_stream(run["dense"]), session["tol"],
        pool=run["pool"])
    wall = time.perf_counter() - t0
    ref = JAX_CPU_SERVING[path]["drifting_iterations"]
    ratio = total / session["independent_epochs"]
    bad = [(t, i) for t, upd in enumerate(updates) for i, r in enumerate(upd)
           if not (r.converged and np.isfinite(r.x).all())]
    print(f"  {path} drifting [{card}]: {STREAM_COLS} server sessions x {STREAM_UPDATES} updates in "
          f"{wall:.3f} s, {stats['batches']} batches (mean size {stats['mean_batch_size']:.2f}); "
          f"summed epochs-to-tol {total} vs JAX CPU server {ref} (ratio {total / ref:.4f}); "
          f"/ independent {session['independent_epochs']} = {ratio:.4f} (gate {SESSION_RATIO_GATE})")
    check(not bad, f"{path} drifting: unconverged or non-finite updates {bad[:5]}")
    check(abs(total / ref - 1.0) <= SERVING_ITER_GATE,
          f"{path} drifting: {total} epochs not within 2% of the JAX server's {ref}")
    check(ratio <= SESSION_RATIO_GATE, f"{path} drifting: ratio {ratio} above the gate")
    return {"iterations": total, "ratio": ratio, "wall_s": wall, "batches": stats["batches"]}


def coalescing_phase(run, serving, card):
    """32 dense requests at once through the pooled solver, at max_batch 1
    and at 32 (printed, not gated)."""
    import asyncio

    out = {}
    B = run["rhs"][:, :SERVE_BATCH]
    for max_batch in (1, SERVE_BATCH):
        async def burst():
            async with serving.SolveServer(pool=run["pool"], max_batch=max_batch,
                                           max_wait_ms=SERVE_WAIT_MS, num_epochs=STREAM_CAP,
                                           tol=run["tol"]) as server:
                t0 = time.perf_counter()
                await serving.replay_trace(server, run["fp"], B, np.zeros(B.shape[1]))
                return time.perf_counter() - t0, server.stats()

        wall, stats = asyncio.run(asyncio.wait_for(burst(), 600))
        out[max_batch] = B.shape[1] / wall
        print(f"  coalescing [{card}]: {B.shape[1]} dense requests at max_batch {max_batch}: "
              f"{wall:.3f} s, {stats['batches']} batches -> {out[max_batch]:.1f} req/s")
    return out


def checkpoint_phase(torch, runs, serving, card):
    """The pooled solvers saved through the port's ``CheckpointStore`` and
    restored by a fresh server with a fresh pool of one entry: no prepare,
    two restores, each served batch equal bit for bit to the saved solver's
    solve of it; and the dense solver's eviction (the matrix-free system's
    restore) releases at least half its ``memory_bytes`` on the card."""
    import asyncio
    import gc
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        store = serving.CheckpointStore(d)
        saved = {}
        for path, run in runs.items():
            t0 = time.perf_counter()
            prep = run["pool"].get(run["fp"])
            check(store.save(run["fp"], prep, run["kw"]), f"{path}: checkpoint save refused")
            saved[path] = (prep, time.perf_counter() - t0)
        tracer = serving.Tracer()
        memory = {}

        async def restore():
            async with serving.SolveServer(max_batch=SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS,
                                           num_epochs=STREAM_CAP, pool_size=1, checkpoint=d,
                                           tracer=tracer) as server:
                fps = {path: server.register(run["A"], **run["kw"]) for path, run in runs.items()}
                served = {}
                for path, run in runs.items():
                    B = run["rhs"][:, :SERVE_BATCH]
                    opts = serving.SubmitOptions(tol=run["tol"])
                    served[path] = await asyncio.gather(
                        *(server.submit(fps[path], B[:, i], opts) for i in range(B.shape[1])))
                    gc.collect()
                    torch.cuda.synchronize()
                    memory[path] = (torch.cuda.memory_allocated(), server.pool.resident())
                return served, server.stats()

        served, stats = asyncio.run(asyncio.wait_for(restore(), 600))
    restore_ms = {s.args["fingerprint"]: s.duration_ms for s in tracer.spans()
                  if s.name == "pool.restore"}
    out = {"restores": stats["restores"], "prepares": stats["prepares"]}
    for path, run in runs.items():
        prep, save_s = saved[path]
        B = run["rhs"][:, :SERVE_BATCH]
        want = prep.solve(B, num_epochs=STREAM_CAP, tol=run["tol"]).x
        same = sum(bool(np.array_equal(r.x, want[:, i])) for i, r in enumerate(served[path]))
        out[path] = {"restore_ms": restore_ms.get(run["fp"]), "prepare_ms": run["prepare_ms"],
                     "save_s": save_s, "bit_equal": same}
        print(f"  checkpoint {path} [{card}]: save {save_s * 1e3:.1f} ms, restore "
              f"{restore_ms.get(run['fp'], float('nan')):.1f} ms against prepare "
              f"{run['prepare_ms']:.1f} ms; served batch bit-equal to the saved solver on "
              f"{same}/{B.shape[1]} requests")
        check(same == B.shape[1], f"{path}: restored solves differ from the saved solver's")
    print(f"  restoring server: pool restores {stats['restores']}, prepares {stats['prepares']}, "
          f"evictions {stats['evictions']}")
    check(stats["restores"] == 2 and stats["prepares"] == 0,
          f"the restoring server prepared: {stats}")
    (held, (dense_entry,)), (after, _) = memory["dense"], memory["matfree"]
    freed = held - after
    print(f"  eviction of the dense solver ({dense_entry['memory_bytes'] / 1e6:.1f} MB of factors): "
          f"torch.cuda.memory_allocated {held / 1e6:.1f} -> {after / 1e6:.1f} MB "
          f"(freed {freed / 1e6:.1f} MB)")
    check(freed >= 0.5 * dense_entry["memory_bytes"],
          f"evicting the dense solver freed {freed} bytes of {dense_entry['memory_bytes']}")
    out["freed_bytes"] = freed
    out["dense_memory_bytes"] = dense_entry["memory_bytes"]
    return out


def fault_phase(run, serving, card):
    """One fault plan on the dense Poisson replay (watchdog armed, replay
    with ``return_exceptions``): a persistent poison fails alone, with
    ``SolveFailure``; a one-shot solve error is retried (the failing batch
    redispatched in halves) and answered; a NaN planted in one column is
    flagged by the watchdog, that column alone, and recovers on the retry.
    Every other request is answered within the kernels-on/off gate."""
    import asyncio

    poison, transient, nan = 40, 100, 170
    plan = serving.FaultPlan(rules=(
        serving.FaultRule(site="solve", kind="error", request=poison),
        serving.FaultRule(site="solve", kind="error", request=transient, times=1),
        serving.FaultRule(site="solve", kind="nan", request=nan, times=1),
    ), seed=17)
    faults = serving.FaultInjector(plan)

    async def replay():
        async with serving.SolveServer(pool=run["pool"], max_batch=SERVE_BATCH,
                                       max_wait_ms=SERVE_WAIT_MS, num_epochs=STREAM_CAP,
                                       tol=run["tol"], faults=faults,
                                       watchdog=serving.Watchdog()) as server:
            t0 = time.perf_counter()
            results = await serving.replay_trace(server, run["fp"], run["rhs"], run["gaps"],
                                                 return_exceptions=True)
            v = server.metrics.value
            flags = {r: int(v("server_failures_total", reason=r)) for r in ("nan", "stalled")}
            return results, time.perf_counter() - t0, server.stats(), flags

    results, wall, stats, flags = asyncio.run(asyncio.wait_for(replay(), 600))
    failed = {i: r for i, r in enumerate(results) if isinstance(r, BaseException)}
    worst = max(float(np.abs(r.x - run["direct_x"][:, i]).max())
                / served_tolerance("dense", run["direct_x"][:, i])
                for i, r in enumerate(results) if i not in failed)
    fires = [s["fires"] for s in faults.stats()]
    attempts = {i: r.attempts for i, r in enumerate(results) if i not in failed and r.attempts != 1}
    print(f"  faults [{card}]: {len(results)} requests in {wall:.3f} s; failed {sorted(failed)} "
          f"({[(f.reason, f.request, f.attempts) for f in failed.values()]}); rule fires {fires}; "
          f"watchdog flags {flags}; retries {stats['retries']}, recovered "
          f"{stats['recovered_requests']}; requests with more than one attempt {attempts}; "
          f"worst |x - x_direct| / gate {worst:.3f}")
    check(set(failed) == {poison} and isinstance(failed[poison], serving.SolveFailure)
          and failed[poison].request == poison and failed[poison].reason == "error",
          f"faults: expected request {poison} alone to fail: {failed}")
    check(worst <= 1.0, f"faults: a batchmate is off its direct solve by {worst:.3f} x the gate")
    check(fires[1] == 1 and stats["retries"] >= 1,
          f"faults: the one-shot error fired {fires[1]} times, retries {stats['retries']}")
    check(flags == {"nan": 1, "stalled": 0} and attempts == {nan: 2},
          f"faults: watchdog flags {flags}, attempts {attempts}: expected request {nan} alone")
    return {"failed": sorted(failed), "fires": fires, "flags": flags, "wall_s": wall,
            "retries": stats["retries"], "recovered": stats["recovered_requests"]}


def serving_phases(torch, ops, make_problem, sessions, card):
    """Every serving phase on the card, in order; returns their numbers."""
    from repro_torch import serving as srv
    from repro_torch.core import Watchdog
    from repro_torch.obs import Tracer

    serving = SimpleNamespace(
        SolveServer=srv.SolveServer, replay_trace=srv.replay_trace,
        CheckpointStore=srv.CheckpointStore, SubmitOptions=srv.SubmitOptions,
        FaultPlan=srv.FaultPlan, FaultRule=srv.FaultRule, FaultInjector=srv.FaultInjector,
        SolveFailure=srv.SolveFailure, Tracer=Tracer, Watchdog=Watchdog)
    t0 = time.perf_counter()
    runs = {path: poisson_phase(torch, ops, path, make_problem, serving, card)
            for path in ("dense", "matfree")}
    drifting = {path: drifting_phase(path, runs[path], sessions[path], serving, card)
                for path in ("dense", "matfree")}
    coalescing = coalescing_phase(runs["dense"], serving, card)
    restore = checkpoint_phase(torch, runs, serving, card)
    faults = fault_phase(runs["dense"], serving, card)
    seconds = time.perf_counter() - t0
    print(f"  serving phases: {seconds:.1f} s")
    summary = {path: {k: v for k, v in run.items() if isinstance(v, (int, float, str, dict))
                      and k not in ("kw", "pool")} for path, run in runs.items()}
    print(json.dumps({"serving": {"poisson": summary, "drifting": drifting,
                                  "coalescing_req_per_s": coalescing, "checkpoint": restore,
                                  "faults": faults, "seconds": seconds}, "card": card}))
    return runs


def run_module(module, args, timeout):
    """``python -m module args`` with the checkout's sources on the path:
    (stdout, seconds). A non-zero exit prints its output's end and fails."""
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", module, *args], capture_output=True, text=True,
                         env=env, timeout=timeout)
    if out.returncode:
        print(out.stdout[-6000:])
        print(out.stderr[-6000:], file=sys.stderr)
    check(out.returncode == 0, f"{module} {' '.join(args)} exited {out.returncode}")
    return out.stdout, time.perf_counter() - t0


def load_run(path):
    """A command line's ``--out`` file: its arrays and its JSON record."""
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    out["record"] = json.loads(str(out["record"]))
    return out


def first_shard(op, ranks):
    """Rank 0's shard of ``op`` over ``ranks`` ranks, as ``place`` keeps it:
    blocks [0, J/D) of every array, packed on the card."""
    from repro_torch.sparse.bsr import _ARRAY_FIELDS

    per = op.num_blocks // ranks
    kept = {f: getattr(op, f)[:per] for f in _ARRAY_FIELDS if getattr(op, f) is not None}
    return dataclasses.replace(op, **kept, fwd_packed=None, tra_packed=None, gram_packed=None,
                               shard=(0, per, op.num_blocks)).with_packed()


def mesh_d1_phase(torch, ops, prepare, tmp):
    """One rank on ``nccl`` in this process: the sharded matrix-free solver
    of the reference's sharded configuration against the unsharded
    kernels-on solver, its launches and audited epoch; then the dense
    ``solve_sharded`` of the Table 1 width (and its even-width twin, the 2-D
    solver's reference) on the same one-rank group."""
    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import sharded_solve
    from repro_torch.sparse import generate_schenk_like

    coo = generate_schenk_like(MESH_N, sparsity=MESH_SPARSITY, seed=MESH_SEED)
    A = coo.to_dense().astype(np.float32)
    xs = np.random.default_rng(MESH_RHS_SEED).standard_normal((MESH_N, 32)).astype(np.float32)
    B = (A @ xs).astype(np.float32)
    kw = dict(mode="matfree", num_blocks=8, use_kernels=True, gamma=2.0, eta=1.9)
    single = prepare(coo, device="cuda", **kw)
    mesh = tmesh.make_host_local_mesh(1, device="cuda", backend="nccl")
    try:
        sharded = prepare(coo, mesh=mesh, **kw)
        reset_launches(ops)
        got = sharded.solve(B, num_epochs=300)
        launches = read_launches(ops)
        want = single.solve(B, num_epochs=300)
        rel = float(np.abs(got.x - want.x).max() / np.abs(want.x).max())
        floor = 1e-9 * float(np.max(np.sum(B.astype(np.float64) ** 2, axis=0)))
        hist_ok = bool(np.allclose(got.history["residual_sq"], want.history["residual_sq"],
                                   rtol=1e-3, atol=floor))
        tol = 3.0 * float(np.sqrt(np.max(want.history["residual_sq"][-1])))
        its = sharded.solve(B, num_epochs=300, tol=tol).iterations_to_tol(tol)
        its_single = single.solve(B, num_epochs=300, tol=tol).iterations_to_tol(tol)
        audit = obs.audit_epoch_collectives(sharded, B, num_epochs=4)
        audit_tol = obs.audit_epoch_collectives(sharded, B, num_epochs=4, tol=tol)
        warm = sharded.solve(B, num_epochs=300).wall_seconds
        warm_single = single.solve(B, num_epochs=300).wall_seconds
        from repro_torch.launch.solve import _all_reduce_ms

        nccl_ms = _all_reduce_ms(sharded.comm, MESH_N * 32, sharded.device)
        print(f"  one nccl rank, n={MESH_N} k=32 300 epochs: max |x - x_single| / max|x| "
              f"{rel:.3e} (gate 1e-5), bit-equal {np.array_equal(got.x, want.x)}, residual "
              f"history within rtol 1e-3 {hist_ok}, iterations_to_tol equal "
              f"{np.array_equal(its, its_single)} (tol {tol:.4g}, sum {int(its.sum())}); "
              f"launches {launches}; audited epoch {audit['ops']} op(s) {audit['payload_elems']} "
              f"elements, with tol {audit_tol['ops']} op(s) {audit_tol['payload_elems']}; warm "
              f"solve {warm:.4f} s vs unsharded {warm_single:.4f} s; one {MESH_N * 32}-element "
              f"nccl all-reduce {nccl_ms:.4f} ms; operator bytes "
              f"{sharded.memory_bytes} (unsharded {single.memory_bytes})")
        check(rel <= 1e-5, f"one-rank mesh: off the unsharded solve by {rel}")
        check(hist_ok, "one-rank mesh: residual history off the unsharded one")
        check(np.array_equal(its, its_single), "one-rank mesh: iterations_to_tol differ")
        check(launches["spmm_fused_packed"] == 300,
              f"one-rank mesh: expected 300 fused packed passes: {launches}")
        nk = MESH_N * 32
        check((audit["ops"], audit["payload_elems"]) == (1, nk)
              and (audit_tol["ops"], audit_tol["payload_elems"]) == (2, nk + 32),
              f"one-rank mesh: audited epoch {audit['ops']}/{audit['payload_elems']}, "
              f"with tol {audit_tol['ops']}/{audit_tol['payload_elems']}")
        dense = {}
        for label, n, m in (("table1", 2327, 9308), ("even", 2328, 9312)):
            t0 = time.perf_counter()
            sharded_solve.rank_main(0, ["--n", str(n), "--m", str(m), "--blocks", "8",
                                        "--rhs", "32", "--epochs", "80", "--device", "cuda",
                                        "--backend", "nccl", "--out", str(tmp / f"d1_{label}.npz")])
            dense[label] = load_run(tmp / f"d1_{label}.npz")
            print(f"  dense solve_sharded, one nccl rank, m={m} n={n}: "
                  f"{time.perf_counter() - t0:.2f} s")
    finally:
        dist.destroy_process_group()
    return {"rel_vs_single": rel, "bit_equal": bool(np.array_equal(got.x, want.x)),
            "launches": launches, "audit": audit, "audit_tol": audit_tol,
            "warm_solve_seconds": warm, "single_warm_solve_seconds": warm_single,
            "nccl_all_reduce_ms": nccl_ms, "op": sharded.op, "dense": dense}


def mesh_d4_args(label, n, epochs, tmp):
    """``launch.solve --mode matfree --mesh 4 --backend gloo``'s arguments
    for one of phase 5's systems, its record written to ``tmp/label.npz``."""
    return ["--n", str(n), "--m", str(n), "--blocks", "8", "--mode", "matfree", "--kernels",
            "--rhs", "32", "--epochs", str(epochs), "--gamma", "2.0", "--eta", "1.9",
            "--mesh", str(MESH_RANKS), "--backend", "gloo", "--device", "cuda", "--audit",
            "--profile", "--out", str(tmp / f"{label}.npz")]


def mesh_d4_run(label, n, epochs, single, tmp):
    """A ``launch.solve --mesh 4`` run on the card (``mesh_d4_args``), held
    against the phase-5 single-host run of the same system."""
    run = load_run(tmp / f"{label}.npz")
    rec = run["record"]
    rel = float(np.abs(run["x"] - single["x"]).max() / np.abs(single["x"]).max())
    whole = single["prep"].memory_bytes
    nk, pcg = n * 32, rec["gram_solver"] == "pcg"
    print(f"  {MESH_RANKS} gloo ranks, n={n}: gram "
          f"solver {rec['gram_solver']}, max |x - x_single| / max|x| {rel:.3e} (gate "
          f"{MESH_RELERR_GATE:g}), final_residual_sq_max {rec['final_residual_sq_max']:.6e}")
    for r in rec["ranks"]:
        busy, wall = r["device_busy_ms"], r["warm_wall_ms"]
        share = (f", profiled warm solve {wall:.1f} ms with the device busy {busy:.1f} ms "
                 f"({100 * busy / wall:.1f}%); one {nk}-element all-reduce "
                 f"{r['all_reduce_ms']:.3f} ms on the card ({100 * epochs * r['all_reduce_ms'] / wall:.1f}% "
                 f"of the warm solve at one per epoch), {r.get('all_reduce_host_ms', float('nan')):.3f} "
                 f"ms on host tensors, {r['all_reduce_1_ms']:.3f} ms for one element")
        print(f"    rank {r['rank']}: {r['device_bytes']} bytes ({r['device_bytes'] / whole:.4f} "
              f"of the single solver's {whole}), cold solve {r['solve_seconds']:.4f} s{share}; "
              f"launches {r['launches']}; audited epoch {r['audit']}, with tol {r['audit_tol']}")
    check(rec["path"] == "matfree_sharded", f"mesh n={n}: path {rec['path']}")
    check(rel <= MESH_RELERR_GATE, f"mesh n={n}: off the single-host solve by {rel}")
    for r in rec["ranks"]:
        check(r["device_bytes"] <= MESH_FRACTION_GATE * whole,
              f"mesh n={n}: rank {r['rank']} holds {r['device_bytes']} of {whole} bytes")
        check(r["launches"]["spmm_fused_packed"] == epochs,
              f"mesh n={n}: rank {r['rank']} launches {r['launches']}")
        check(r["audit"] == {"ops": 1 + pcg, "payload_elems": nk + 32 * pcg}
              and r["audit_tol"] == {"ops": 2 + pcg, "payload_elems": nk + 32 * (1 + pcg)},
              f"mesh n={n}: rank {r['rank']} audited epoch {r['audit']} / {r['audit_tol']}")
    return {"rel_vs_single": rel, "ranks": rec["ranks"],
            "gram_solver": rec["gram_solver"], "record": rec}


def mesh_served(card, requests):
    """The serving command line's Poisson trace of ``requests`` requests
    through ``serve_solver --mesh 4 --backend gloo``:
    every request answered, each within 2.5e-4·max|x| of a direct sharded
    solve of its column in the same run, the fused packed pass launched."""
    tol = JAX_CPU_SERVING["matfree"]["poisson_tol"]
    stdout, serve_seconds = run_module("repro_torch.launch.serve_solver", [
        "--n", "2327", "--m", "2327", "--num-blocks", "8", "--mode", "matfree", "--kernels",
        "--gamma", "2.0", "--eta", "1.9", "--epochs", str(STREAM_CAP), "--tol", repr(tol),
        "--requests", str(requests), "--rate", str(SERVE_RATE),
        "--max-batch", str(SERVE_BATCH), "--max-wait-ms", str(SERVE_WAIT_MS),
        "--mesh", str(MESH_RANKS), "--backend", "gloo", "--device", "cuda"], timeout=900)
    served = json.loads(next(line for line in stdout.splitlines()
                             if line.startswith("mesh: "))[len("mesh: "):])
    for line in stdout.splitlines()[:6]:
        print(f"    | {line}")
    print(f"  served Poisson trace, {MESH_RANKS} gloo ranks [{card}]: {served['answered']} of "
          f"{served['requests']} answered, {served['req_per_s']:.1f} req/s, latency ms p50 "
          f"{served['p50_ms']:.1f} p99 {served['p99_ms']:.1f}; {served['batches']} batches, rank "
          f"0 launches {served['launches_rank0']}; worst |x - x_direct| / max|x| "
          f"{served['worst_rel_diff_vs_direct']:.3e} (gate {MESH_RELERR_GATE:g}), "
          f"{served['bit_equal_vs_direct']} bit-equal; {serve_seconds:.1f} s in all")
    served["seconds"] = serve_seconds
    check(served["answered"] == served["requests"] == requests and served["failed"] == 0,
          f"served mesh: {served['answered']} answered of {requests}")
    check(served["worst_rel_diff_vs_direct"] <= MESH_RELERR_GATE,
          f"served mesh: off its direct solve by {served['worst_rel_diff_vs_direct']}")
    check(served["launches_rank0"]["spmm_fused_packed"] >= served["batches"],
          f"served mesh: rank 0 launches {served['launches_rank0']}")
    return served


def mesh_phase(torch, ops, prepare, mf_small, mf_big, card):
    """Phase 11, the multi-device path; returns its numbers and the rank-0
    shard operators whose kernels the kernel table times."""
    import tempfile

    from repro_torch.launch import mesh as tmesh

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        d1 = mesh_d1_phase(torch, ops, prepare, tmp)
        print(f"  one-rank nccl part: {time.perf_counter() - t_phase:.1f} s")
        # the 4-rank runs on one spawn of 4 ranks: launch.solve --mesh 4 at
        # phase 5's two sizes (--mesh takes --mode matfree, as the reference's
        # command line; at n = 16384 the Gram solver's own auto must resolve
        # PCG, as phase 5's did), then the dense sharded and 2-D solvers
        dense_args = ["--blocks", "8", "--rhs", "32", "--epochs", "80", "--device", "cuda",
                      "--backend", "gloo"]
        t0 = time.perf_counter()
        tmesh.run_ranks(tmesh.run_commands, MESH_RANKS, "gloo", "cuda", ([
            ("repro_torch.launch.solve", mesh_d4_args("n2327", 2327, 300, tmp)),
            ("repro_torch.launch.solve", mesh_d4_args("n16384", 16384, 100, tmp)),
            ("repro_torch.launch.sharded_solve", ["--n", "2327", "--m", "9308", "--mesh", "4",
                                                  *dense_args, "--out", str(tmp / "d4.npz")]),
            ("repro_torch.launch.sharded_solve", ["--n", "2328", "--m", "9312", "--mesh", "2",
                                                  "--model", "2", *dense_args,
                                                  "--out", str(tmp / "d2x2.npz")]),
        ],))
        spawn_seconds = time.perf_counter() - t0
        print(f"  the 4-rank runs on one spawn of {MESH_RANKS} gloo ranks: {spawn_seconds:.1f} s "
              f"in all, spawn included")
        d4 = {"n2327": mesh_d4_run("n2327", 2327, 300, mf_small, tmp),
              "n16384": mesh_d4_run("n16384", 16384, 100, mf_big, tmp)}
        check(d4["n16384"]["gram_solver"] == "pcg", "mesh n=16384: expected the PCG Gram solver")
        d4_dense, d2x2 = load_run(tmp / "d4.npz"), load_run(tmp / "d2x2.npz")
    diff = float(np.abs(d4_dense["x"] - d1["dense"]["table1"]["x"]).max())
    diff_2d = float(np.abs(d2x2["x"] - d1["dense"]["even"]["x"]).max())
    print(f"  dense solve_sharded, {MESH_RANKS} gloo ranks at m=9308 n=2327 and "
          f"solve_sharded_2d on (2, 2) at m=9312 n=2328: "
          f"max |x_4 - x_1| {diff:.3e} (atol {DENSE_SHARDED_ATOL:g}), max |x_2d - x_1| "
          f"{diff_2d:.3e} (atol {DENSE_2D_ATOL:g}); solve s per rank "
          f"{[round(r['solve_seconds'], 4) for r in d4_dense['record']['ranks']]} (1-D), "
          f"{[round(r['solve_seconds'], 4) for r in d2x2['record']['ranks']]} (2-D); "
          f"final_residual_sq_max {d4_dense['record']['final_residual_sq_max']:.6e} vs one rank "
          f"{d1['dense']['table1']['record']['final_residual_sq_max']:.6e}")
    check(diff <= DENSE_SHARDED_ATOL, f"dense sharded: 4 ranks off one rank by {diff}")
    check(diff_2d <= DENSE_2D_ATOL, f"2-D: off one rank by {diff_2d}")

    served = mesh_served(card, MESH_SERVE_REQUESTS)
    seconds = time.perf_counter() - t_phase
    print("  the 4-rank times staged every all-reduce through gloo and host memory: they "
          "measure the program on one card, not NCCL")
    print(f"  multi-device phase: {seconds:.1f} s")
    summary = {
        "d1": {k: v for k, v in d1.items() if k not in ("op", "dense")},
        "d4": {label: {k: v for k, v in run.items() if k != "record"}
               for label, run in d4.items()},
        "dense": {"max_abs_diff_4_vs_1": diff, "max_abs_diff_2d_vs_1": diff_2d},
        "spawn_seconds": spawn_seconds,
        "served": served, "seconds": seconds,
    }
    print(json.dumps({"mesh": summary, "card": card}, default=float))
    shards = {"mesh_d1": d1["op"],
              "shard4_n2327": first_shard(mf_small["prep"].op, MESH_RANKS),
              "shard4_n16384": first_shard(mf_big["prep"].op, MESH_RANKS)}
    return {"d1": d1, "d4": d4, "served": served, "shards": shards}


def dense_layers(cfg, n):
    """``cfg`` cut to ``n`` dense layers (depth only; every width kept)."""
    return dataclasses.replace(cfg, num_layers=n, layer_types=("dense",) * n)


def same_weights(transformer, model, device):
    """A model on ``device`` holding ``model``'s weights."""
    out = transformer.Transformer(model.cfg, device)
    out.load_state_dict(model.state_dict())
    return out


def on(aux, device):
    return None if aux is None else {k: v.to(device) for k, v in aux.items()}


def continuation(torch, transformer, model, toks, plen, aux=None):
    """Prefill ``toks[:, :plen]``, then decode the rest teacher-forced: the
    prefill logits and the decode steps' logits, first vocab_size columns,
    on the host."""
    cfg = model.cfg
    v = cfg.vocab_size
    toks, aux = toks.to(model.device), on(aux, model.device)
    logits, cache = transformer.prefill(model, toks[:, :plen], cfg, toks.shape[1], aux=aux)
    steps = [transformer.decode_step(model, cache, toks[:, i:i + 1], i, cfg, aux=aux)[0][:, 0, :v]
             for i in range(plen, toks.shape[1])]
    return logits[..., :v].cpu(), torch.stack(steps, 1).cpu()


def token_by_token(torch, transformer, model, toks, first, aux=None):
    """Decode every token from an empty cache; logits of steps >= first."""
    cfg = model.cfg
    toks, aux = toks.to(model.device), on(aux, model.device)
    cache = transformer.init_cache(cfg, toks.shape[0], toks.shape[1], device=model.device)
    steps = []
    for i in range(toks.shape[1]):
        logits, cache = transformer.decode_step(model, cache, toks[:, i:i + 1], i, cfg, aux=aux)
        if i >= first:
            steps.append(logits[:, 0, :cfg.vocab_size])
    return torch.stack(steps, 1).cpu()


def rel_err(got, want) -> float:
    return float((got - want).abs().max()) / float(want.abs().max())


def open_gates(torch, blocks, model):
    """Set every gated cross block's gate (zero-initialised, which would
    silence the patches) to 0.5."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, blocks.CrossBlock) and module.gated:
                module.gate.fill_(0.5)


def model_parity_reduced(torch, mods):
    """All ten archs' reduced configs on the card against the port's CPU
    path from the same weights (TF32 off): the four dense archs at 3 dense
    layers, the other six at ``reduced_config`` (a cross gate opened)."""
    transformer = mods.transformer
    out = {}
    for arch in MODEL_PARITY_ARCHS + tuple(FAMILIES):
        cfg = mods.reduced_config(mods.get_config(arch))
        label = "reduced"
        if arch in MODEL_PARITY_ARCHS:
            cfg, label = dense_layers(cfg, 3), "reduced, 3 layers"
        cpu = transformer.init_params(cfg, torch.Generator().manual_seed(0))
        open_gates(torch, mods.blocks, cpu)
        card = same_weights(transformer, cpu, torch.device("cuda"))
        toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)))
        aux = mods.serve.stubs(cfg, 2, "cpu")
        (pre_c, dec_c), (pre_g, dec_g) = (continuation(torch, transformer, m, toks, 8, aux)
                                          for m in (cpu, card))
        e_pre, e_dec = rel_err(pre_g, pre_c), rel_err(dec_g, dec_c)
        print(f"  {arch} ({label}): prefill logits {e_pre:.3e}·max (gate "
              f"{MODEL_PREFILL_GATE['reduced']:g}), 4 decode steps {e_dec:.3e}·max (gate "
              f"{MODEL_DECODE_GATE:g})")
        check(e_pre <= MODEL_PREFILL_GATE["reduced"], f"{arch} reduced prefill: {e_pre}")
        check(e_dec <= MODEL_DECODE_GATE, f"{arch} reduced decode: {e_dec}")
        out[arch] = {"prefill_rel_err": e_pre, "decode_rel_err": e_dec}
    return out


def model_serving_phase(torch, mods, card):
    """granite-3-2b at full width on the card: parity with the CPU path from
    the same weights, the prefill continuation, greedy generation timed
    (prefill, decode per step, tokens/s, peak memory) and one decode step
    profiled, beside the bounds of the port's cost model; then the serving
    command line as a subprocess."""
    import re

    from torch.profiler import ProfilerActivity, profile

    transformer, costs, decode = mods.transformer, mods.costs, mods.decode
    dev = torch.device("cuda")
    cfg = mods.get_config(MODEL_ARCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, {n_params:,} "
          f"parameters ({weight_bytes / 1e9:.2f} GB f32) drawn on the card in {init_s:.2f} s")
    check(n_params == cfg.param_count() == 2_534_049_792, f"parameter count {n_params}")

    # card against the CPU from the same weights: batch 1, 16-token prompt, 8 decode steps
    toks = torch.randint(0, cfg.vocab_size, (1, 24), generator=torch.Generator().manual_seed(1))
    t0 = time.perf_counter()
    pre_g, dec_g = continuation(torch, transformer, model, toks, 16)
    card_s = time.perf_counter() - t0
    cpu = same_weights(transformer, model, torch.device("cpu"))
    t0 = time.perf_counter()
    pre_c, dec_c = continuation(torch, transformer, cpu, toks, 16)
    cpu_s = time.perf_counter() - t0
    del cpu
    e_pre, e_dec = rel_err(pre_g, pre_c), rel_err(dec_g, dec_c)
    td = token_by_token(torch, transformer, model, toks, 16)
    e_cont = rel_err(dec_g, td)
    print(f"  card vs CPU (1 x 16 prompt + 8 decode steps; card {card_s:.2f} s, CPU "
          f"{cpu_s:.2f} s): prefill logits {e_pre:.3e}·max (gate {MODEL_PREFILL_GATE['full']:g}),"
          f" decode {e_dec:.3e}·max (gate {MODEL_DECODE_GATE:g}); prefill continuation vs "
          f"token-by-token decode on the card {e_cont:.3e}·max (gate {MODEL_DECODE_GATE:g})")
    check(e_pre <= MODEL_PREFILL_GATE["full"], f"full-width prefill card vs CPU: {e_pre}")
    check(e_dec <= MODEL_DECODE_GATE, f"full-width decode card vs CPU: {e_dec}")
    check(e_cont <= MODEL_DECODE_GATE, f"full-width prefill continuation: {e_cont}")

    # generate at batch 4, prompt 128, 32 new tokens
    prompts = torch.randint(0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT),
                            generator=torch.Generator().manual_seed(2)).to(dev)
    warm = decode.generate(model, cfg, prompts, max_new=GEN_NEW)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out_pf = decode.generate(model, cfg, prompts, max_new=GEN_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(tuple(out_pf.shape) == (GEN_BATCH, GEN_NEW), f"generate shape {tuple(out_pf.shape)}")
    check(bool((out_pf >= 0).all() and (out_pf < cfg.vocab_size).all()), "token ids out of range")
    max_seq = GEN_PROMPT + GEN_NEW
    step = decode.prepared_serve_step(cfg)
    prefill_ms, decode_ms = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = transformer.prefill(model, prompts, cfg, max_seq)
        tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        for t in range(GEN_PROMPT, max_seq - 1):
            tok, caches = step(model, caches, tok, t)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t0) * 1e3 / (GEN_NEW - 1))
    out_td = decode.generate(model, cfg, prompts, max_new=GEN_NEW, use_prefill=False)
    share = float((out_td == out_pf).float().mean())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(model, caches, tok, max_seq - 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    weight_ms = weight_bytes / costs.HBM_BW * 1e3
    prefill_flops = costs.forward_flops(cfg, GEN_BATCH, GEN_PROMPT, "prefill")
    prefill_bound_ms = prefill_flops / costs.PEAK_FLOPS_F32 * 1e3
    tok_s = GEN_BATCH * GEN_NEW / gen_s
    print(f"  generate (batch {GEN_BATCH}, prompt {GEN_PROMPT}, {GEN_NEW} new) on {card}: "
          f"{gen_s * 1e3:.1f} ms, {tok_s:.1f} tok/s; prefill {prefill_ms[-1]:.2f} ms "
          f"(runs {', '.join(f'{m:.2f}' for m in prefill_ms)}; bound {prefill_bound_ms:.2f} ms: "
          f"{prefill_flops / 1e12:.3f} TFLOP at 67 TFLOP/s f32), decode {decode_ms[-1]:.3f} ms "
          f"per step (runs {', '.join(f'{m:.3f}' for m in decode_ms)}; bound {weight_ms:.3f} ms:"
          f" {weight_bytes / 1e9:.2f} GB of f32 weights at 3.35 TB/s); peak device memory "
          f"{peak / 1e6:.1f} MB ({held / 1e6:.1f} MB held before)")
    print(f"  greedy tokens equal between generate(use_prefill=True) and False: {share:.4f} "
          f"(ungated; the bf16 cache is read only on the token-by-token side); the warm-up "
          f"call's tokens equal the timed call's: {bool(torch.equal(warm, out_pf))}")
    print(f"  profile of one decode step (batch {GEN_BATCH}, position {max_seq - 1}): wall "
          f"{wall * 1e3:.3f} ms, device busy {busy_ms:.3f} ms ({100 * busy_ms / (wall * 1e3):.1f}%),"
          f" {sum(r[1] for r in rows)} kernels run")
    for dev_us, count, name in rows[:6]:
        print(f"      {dev_us / 1e3:9.3f} ms  x{count:<5d} {name[:90]}")
    del model, caches, logits
    torch.cuda.empty_cache()

    args = ["--arch", MODEL_ARCH, "--batch", str(GEN_BATCH), "--prompt-len", str(GEN_PROMPT),
            "--max-new", str(GEN_NEW)]
    stdout, secs = run_module("repro_torch.launch.serve", args, timeout=600)
    lines = stdout.strip().splitlines()
    print(f"  python -m repro_torch.launch.serve {' '.join(args)} ({secs:.1f} s with start-up):")
    for line in lines[-2:]:
        print(f"    {line}")
    check(len(lines) >= 2 and re.fullmatch(
        rf"arch={MODEL_ARCH} generated \({GEN_BATCH}, {GEN_NEW}\) in [0-9.]+s "
        r"\([0-9.]+ tok/s incl\. prompt\)", lines[-2]) is not None
        and lines[-1].startswith("sample: ["), f"launch.serve printed {lines[-2:]}")
    return {"arch": MODEL_ARCH, "params": n_params, "weight_gb": weight_bytes / 1e9,
            "init_s": init_s, "prefill_rel_err_vs_cpu": e_pre, "decode_rel_err_vs_cpu": e_dec,
            "continuation_rel_err": e_cont, "generate_ms": gen_s * 1e3, "tok_s": tok_s,
            "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
            "prefill_bound_ms": prefill_bound_ms, "decode_bound_ms": weight_ms,
            "peak_mb": peak / 1e6, "prefill_vs_token_by_token_share": share,
            "decode_step_wall_ms": wall * 1e3, "decode_step_busy_ms": busy_ms,
            "decode_step_kernels": sum(r[1] for r in rows),
            "decode_step_top": [(name[:60], dev_us / 1e3) for dev_us, _, name in rows[:4]],
            "serve_cli": lines[-2]}


def probe_phase(torch, ops, mods, prepare, tri_case, proj_case):
    """The linear probe through ``repro_torch.launch.linear_probe``: the
    reference's reduced configuration at its gate, then granite-3-2b at full
    width with the kernels (counters zeroed around the run) against the
    kernels-off solve on the same features; the two kernels held against
    their plain versions at the probe's shapes."""
    linear_probe = mods.linear_probe
    reset_launches(ops)
    red = linear_probe.run(["--reduce", "--kernels", "--device", "cuda"])
    red_launches = read_launches(ops)
    rec = red["record"]
    print(f"  --reduce --kernels: features {rec['features']}, mode {rec['mode']}, final MSE "
          f"{rec['final_mse']:.3e} (gate {linear_probe.MSE_GATE:g}), launches {red_launches}")
    check(rec["final_mse"] < linear_probe.MSE_GATE, f"reduced probe MSE {rec['final_mse']}")
    reset_launches(ops)
    full = linear_probe.run(["--kernels", "--device", "cuda"])
    launches = read_launches(ops)
    rec = full["record"]
    off = linear_probe.fit(full["feats"], full["w_true"], False, "cuda")
    diff = float(np.abs(full["result"].x - off.x).max())
    tol = 1e-4 * max(1.0, float(np.abs(off.x).max()))
    print(f"  --kernels (full width): features {rec['features']} in {rec['feature_seconds']:.3f} s,"
          f" mode {rec['mode']}, solve {rec['solve_seconds']:.3f} s (kernels off "
          f"{off.wall_seconds:.3f} s), final MSE {rec['final_mse']:.6e} (kernels off "
          f"{float(off.final_mse):.6e}; ungated), max |x_kernels - x_plain| {diff:.3e} (tol "
          f"{tol:.1e}), launches {launches}")
    check(rec["mode"] == "wide", f"full-width probe mode {rec['mode']}")
    # one right-hand side: the plan keeps the residual on the library's gemv
    check(launches["trisolve"] == 1 and launches["consensus_update"] == PROBE_EPOCHS
          and launches["residual"] == 0, f"full-width probe launches {launches}")
    check(diff <= tol, f"full-width probe: kernels-on x differs from kernels-off by {diff}")
    prep = prepare(full["feats"], method="dapc", num_blocks=8, materialize_p=False,
                   use_kernels=True, device="cuda")
    w, r = prep.factors
    check(tuple(w.shape) == (8, 1024, 2048) and tuple(r.shape) == (8, 1024, 1024),
          f"probe factors {tuple(w.shape)}, {tuple(r.shape)}")
    tri_case("trisolve.probe", 8, 1024, 1, torch.float32, True, True, r)
    proj_case("consensus_update.probe", w, 1, torch.float32, with_x=False)
    return {"reduced": {**red["record"], "launches": red_launches},
            "full": {**rec, "launches": launches, "plain_solve_seconds": off.wall_seconds,
                     "plain_final_mse": float(off.final_mse), "max_abs_diff_vs_plain": diff}}


def family_config(get_config, arch):
    """The arch's config at full width, its depth cut as ``FAMILIES`` says."""
    cfg = get_config(arch)
    cut = FAMILIES[arch]["cut"]
    if cut is None:
        return cfg
    head, tail = cut
    types = cfg.types[:head] + cfg.types[len(cfg.types) - tail:]
    return dataclasses.replace(cfg, num_layers=len(types), layer_types=types)


def routing_agreement(card, cpu):
    """Expert ids of the same MoE calls (``moe.record_routing`` records) on
    the card and the CPU: (equal (token, slot) pairs, all pairs, every
    differing pair as (call, token, slot, card's expert, CPU's expert, the
    margin between their two probabilities on the card))."""
    check(len(card) == len(cpu), f"MoE calls: {len(card)} on the card, {len(cpu)} on the CPU")
    equal = total = 0
    diffs = []
    for call, ((e_g, p_g, _), (e_c, _, _)) in enumerate(zip(card, cpu)):
        e_g, p_g = e_g.cpu(), p_g.cpu()
        same = e_g == e_c
        equal += int(same.sum())
        total += same.numel()
        for tok, slot in (~same).nonzero().tolist():
            a, b = int(e_g[tok, slot]), int(e_c[tok, slot])
            diffs.append((call, tok, slot, a, b, abs(float(p_g[tok, a] - p_g[tok, b]))))
    return equal, total, diffs


def drops(records) -> int:
    return sum(r[2] for r in records)


def first_layers(torch, transformer, model, n):
    """A model of ``model``'s first ``n`` layers (its embedding and final
    norm too), holding copies of the same weights, on the same device."""
    cfg = model.cfg
    cut = dataclasses.replace(cfg, num_layers=n, layer_types=cfg.types[:n])
    out = transformer.Transformer(cut, model.device)
    state = model.state_dict()
    out.load_state_dict({k: state[k] for k in out.state_dict()})
    return out


def layer_outputs(torch, transformer, model, toks, aux, scale=None):
    """Every layer's output (host f32) of a train-mode forward of ``toks``,
    the embedding table multiplied by ``scale`` for the run when given."""
    outs = []
    hooks = [layer.register_forward_hook(
        lambda mod, args, out: outs.append(out[0].float().cpu()))
        for layer in dict.fromkeys(model.layers)]
    saved = None
    if scale is not None:
        saved = model.embed.clone()
        with torch.no_grad():
            model.embed.mul_(scale.to(model.device))
    try:
        with torch.no_grad():
            transformer.forward_hidden(model, toks.to(model.device), model.cfg,
                                       aux=on(aux, model.device))
    finally:
        if saved is not None:
            with torch.no_grad():
                model.embed.copy_(saved)
        for hook in hooks:
            hook.remove()
    return outs


def step_layer_outputs(torch, transformer, model, toks, plen, keep, aux=None):
    """Every layer's output (host f32, (B, S - keep, D)) on the decode steps
    of positions >= ``keep``: decoding ``toks`` from position ``plen``, after
    a prefill of ``toks[:, :plen]`` (plen > 0) or from an empty cache."""
    cfg = model.cfg
    toks, aux = toks.to(model.device), on(aux, model.device)
    step, kept = [], []
    hooks = [layer.register_forward_hook(
        lambda mod, args, out: step.append(out[0][:, -1].float().cpu()))
        for layer in dict.fromkeys(model.layers)]
    try:
        if plen:
            cache = transformer.prefill(model, toks[:, :plen], cfg, toks.shape[1], aux=aux)[1]
        else:
            cache = transformer.init_cache(cfg, toks.shape[0], toks.shape[1], device=model.device)
        for i in range(plen, toks.shape[1]):
            step.clear()
            transformer.decode_step(model, cache, toks[:, i:i + 1], i, cfg, aux=aux)
            if i >= keep:
                kept.append(list(step))
    finally:
        for hook in hooks:
            hook.remove()
    return [torch.stack(outs, 1) for outs in zip(*kept)]


def envelope_gate(cfg, rows, title):
    """Print and gate layer rows (layer, type, difference, spread), each a
    share of max|h|: every difference within ENVELOPE_FACTOR of its spread
    (+1e-6)."""
    worst = max(rows, key=lambda r: r[2] / (ENVELOPE_FACTOR * r[3] + 1e-6))
    last = rows[-1]
    shown = sorted({0, len(rows) - 1} | {r[0] for r in rows if r[1] != rows[0][1]}
                   | set(range(7, len(rows), 8)))
    print(f"    {title}, ·max|h|: "
          + ", ".join(f"{i} {rows[i][1]} {rows[i][2]:.1e} | {rows[i][3]:.1e}" for i in shown[:12]))
    ok = all(diff <= ENVELOPE_FACTOR * spread + 1e-6 for _, _, diff, spread in rows)
    print(f"      worst ratio at layer {worst[0]} ({worst[2]:.2e} | {worst[3]:.2e}); last layer "
          f"{last[2]:.2e} | {last[3]:.2e}; within {ENVELOPE_FACTOR:g}x the envelope at every "
          f"layer: {ok}")
    check(ok, f"{cfg.name}: {title} outside the rounding envelope at layer {worst[0]}")
    return {"layers": [r[2] for r in rows], "envelope": [r[3] for r in rows]}


def layer_envelope(torch, transformer, model, cpu, toks, aux):
    """Layer by layer at full depth: the card against the CPU, beside the
    spread a PERTURBATION of the embeddings causes on each (the rounding
    envelope of the arch). Each layer's card-vs-CPU difference must stay
    within ENVELOPE_FACTOR of the envelope (+1e-6): a fault of the card's
    path would jump out of it while the envelope is small."""
    gen = torch.Generator().manual_seed(5)
    scale = 1 + PERTURBATION * torch.randn(model.cfg.d_model, generator=gen)
    card, host = (layer_outputs(torch, transformer, m, toks, aux) for m in (model, cpu))
    card_p, host_p = (layer_outputs(torch, transformer, m, toks, aux, scale)
                      for m in (model, cpu))
    rows = []
    for i, (a, b, c, d) in enumerate(zip(card, host, card_p, host_p)):
        top = float(a.abs().max())
        diff = float((a - b).abs().max()) / top
        spread = max(float((a - c).abs().max()), float((b - d).abs().max())) / top
        rows.append((i, model.cfg.types[i], diff, spread))
    return envelope_gate(model.cfg, rows, f"layer envelope (1 x {toks.shape[1]}, train mode; "
                         f"card vs CPU | the spread of a {PERTURBATION:g} embedding perturbation)")


def continuation_envelope(torch, transformer, model, toks, plen, aux=None):
    """Layer by layer at full depth on the card, on the decode steps of
    positions >= ``plen``: a prefill of ``toks[:, :plen]`` continued by
    decode, and token-by-token decode from an empty cache, each against the
    train-mode forward (teacher forcing), beside the spread a PERTURBATION
    of the embeddings causes on that forward. A cache or state that prefill
    or decode fails to keep (any period's) jumps out of the envelope at the
    layers after it while the envelope is small."""
    gen = torch.Generator().manual_seed(6)
    scale = 1 + PERTURBATION * torch.randn(model.cfg.d_model, generator=gen)
    teacher, moved = ([h[:, plen:] for h in layer_outputs(torch, transformer, model, toks, aux, sc)]
                      for sc in (None, scale))
    cont = step_layer_outputs(torch, transformer, model, toks, plen, plen, aux)
    tbt = step_layer_outputs(torch, transformer, model, toks, 0, plen, aux)
    rows = []
    for i, (t, m, c, d) in enumerate(zip(teacher, moved, cont, tbt)):
        top = float(t.abs().max())
        diff = max(float((c - t).abs().max()), float((d - t).abs().max())) / top
        rows.append((i, model.cfg.types[i], diff, float((m - t).abs().max()) / top))
    return envelope_gate(model.cfg, rows, (
        f"continuation envelope ({toks.shape[0]} x {toks.shape[1]}, prompt {plen}, the decode "
        f"steps; prefill continuation and token by token vs teacher forcing | the spread of a "
        f"{PERTURBATION:g} embedding perturbation)"))


def family_parity(torch, mods, model, aux):
    """Card against the CPU from the same weights: the layer envelope at
    full depth, then a 1 x 16 prompt and 4 decode steps (phase 12's gates;
    on the first ``gate_layers`` where FAMILIES sets it) and the MoE routing
    of every call."""
    transformer, moe = mods.transformer, mods.moe
    cfg = model.cfg
    toks = torch.randint(0, cfg.vocab_size, (1, 20), generator=torch.Generator().manual_seed(1))
    cpu = same_weights(transformer, model, torch.device("cpu"))
    envelope = layer_envelope(torch, transformer, model, cpu, toks[:, :16], aux)
    gated = model
    n = FAMILIES[cfg.name].get("gate_layers")
    if n:
        gated = first_layers(torch, transformer, model, n)
        cpu = same_weights(transformer, gated, torch.device("cpu"))
        print(f"    the parity gates below hold the first {n} layers (one period, the same "
              f"weights); over all {cfg.num_layers} the envelope above is the gate")
    t0 = time.perf_counter()
    with moe.record_routing(gated) as r_card:
        pre_g, dec_g = continuation(torch, transformer, gated, toks, 16, aux)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with moe.record_routing(cpu) as r_cpu:
        pre_c, dec_c = continuation(torch, transformer, cpu, toks, 16, on(aux, "cpu"))
    cpu_s = time.perf_counter() - t0
    del cpu, gated
    e_pre, e_dec = rel_err(pre_g, pre_c), rel_err(dec_g, dec_c)
    out = {"prefill_rel_err_vs_cpu": e_pre, "decode_rel_err_vs_cpu": e_dec,
           "card_s": card_s, "cpu_s": cpu_s, "envelope": envelope}
    line = (f"    card vs CPU ({cfg.num_layers if not n else n} layers, 1 x 16 prompt + 4 decode "
            f"steps; card {card_s:.2f} s, CPU "
            f"{cpu_s:.2f} s): prefill logits {e_pre:.3e}·max (gate "
            f"{MODEL_PREFILL_GATE['full']:g}), decode {e_dec:.3e}·max (gate {MODEL_DECODE_GATE:g})")
    if r_card or r_cpu:
        equal, total, diffs = routing_agreement(r_card, r_cpu)
        out.update(routing_equal=equal, routing_pairs=total, routing_diffs=diffs,
                   drops_card=drops(r_card), drops_cpu=drops(r_cpu))
        line += (f"; MoE routing equal on {equal}/{total} (token, slot) pairs ("
                 f"{equal / total:.5f}, gate {ROUTING_GATE}), drops {drops(r_card)} card / "
                 f"{drops(r_cpu)} CPU")
        for call, tok, slot, a, b, margin in diffs:
            print(f"      routing differs: MoE call {call}, token {tok}, slot {slot}: card "
                  f"expert {a}, CPU expert {b}, probability margin {margin:.3e}")
        check(equal / total >= ROUTING_GATE, f"{cfg.name}: routing equal on {equal}/{total}")
    print(line)
    check(e_pre <= MODEL_PREFILL_GATE["full"], f"{cfg.name} prefill card vs CPU: {e_pre}")
    check(e_dec <= MODEL_DECODE_GATE, f"{cfg.name} decode card vs CPU: {e_dec}")
    return out


def family_check(torch, mods, model, aux):
    """The family's own property on the card: decode against teacher
    forcing (MoE, at 0 drops), prefill continuation against token by token
    (the recurrent states, the shared block's two caches, the cross cache
    written once), or whisper's pinned position-0 decode and its encoder
    skipped in decode. Where FAMILIES sets ``gate_layers``, the property is
    gated on those first layers and, at full depth, by the continuation
    envelope."""
    transformer, moe = mods.transformer, mods.moe
    kind = FAMILIES[model.cfg.name]["check"]
    gen = torch.Generator().manual_seed(3)
    out = {"check": kind}
    n = FAMILIES[model.cfg.name].get("gate_layers")
    if n:
        toks = torch.randint(0, model.cfg.vocab_size, (2, 12),
                             generator=torch.Generator().manual_seed(4))
        out["full_depth"] = continuation_envelope(torch, transformer, model, toks, 8, aux)
        model = first_layers(torch, transformer, model, n)
        print(f"    (on the first {n} layers)")
    cfg = model.cfg
    dev = model.device
    if kind == "teacher":
        # 8 tokens cannot overflow the 8-slot minimum capacity: 0 drops by size
        toks = torch.randint(0, cfg.vocab_size, (1, 8), generator=gen)
        with moe.record_routing(model) as routed, torch.no_grad():
            hid, _, _ = transformer.forward_hidden(model, toks.to(dev), cfg)
            full = transformer.logits_from_hidden(model, hid, cfg)[..., :cfg.vocab_size].cpu()
            dec = token_by_token(torch, transformer, model, toks, 0)
        err, dropped = rel_err(dec, full), drops(routed)
        print(f"    decode vs teacher forcing (1 x 8, the reference's test): {err:.3e}·scale "
              f"(gate {MODEL_DECODE_GATE:g}), MoE drops {dropped} over {len(routed)} calls")
        check(err <= MODEL_DECODE_GATE and dropped == 0,
              f"{cfg.name} teacher forcing: {err}, drops {dropped}")
        return {**out, "rel_err": err, "drops": dropped}
    if kind == "position0":
        toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen).to(dev)
        with torch.no_grad():
            one = transformer._embed(model, toks[:, 5:6], cfg)
            check(torch.equal(one, transformer._embed(model, toks[:, 5:], cfg)[:, :1]),
                  "whisper: a decode step's embedding is not position 0's")
            hid, _, _ = transformer.forward_hidden(model, toks, cfg, aux=aux)
        full = transformer.logits_from_hidden(model, hid, cfg)[..., :cfg.vocab_size].cpu()
        _, tbt = continuation(torch, transformer, model, toks, 1, aux)
        pinned = rel_err(tbt, full[:, 1:])
        logits, cache = transformer.prefill(model, toks[:, :8], cfg, 12, aux=aux)
        bare = {g: None if c is None else {s: {k: x.clone() for k, x in leaves.items()}
                                           for s, leaves in c.items()} for g, c in cache.items()}
        same = all(torch.equal(
            transformer.decode_step(model, cache, toks[:, i:i + 1], i, cfg, aux=aux)[0],
            transformer.decode_step(model, bare, toks[:, i:i + 1], i, cfg)[0]) for i in range(8, 12))
        print(f"    whisper's decode embeds position 0 (the reference's fault, pinned): token by "
              f"token vs teacher forcing {pinned:.3e}·scale (> 0.1 expected); decode logits "
              f"with and without enc_frames equal (encoder skipped in decode): {same}")
        check(pinned > 0.1 and same, f"whisper position-0 pin {pinned}, encoder skip {same}")
        return {**out, "tbt_vs_teacher_rel_err": pinned, "encoder_skipped_equal": same}
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
    _, cont = continuation(torch, transformer, model, toks, 8, aux)
    if cfg.vision_seq:  # only a prefill writes the cross caches
        tbt = continuation(torch, transformer, model, toks, 1, aux)[1][:, 7:]
    else:
        tbt = token_by_token(torch, transformer, model, toks, 8)
    err = rel_err(cont, tbt)
    out["rel_err"] = err
    notes = []
    logits, cache = transformer.prefill(model, toks[:, :8].to(dev), cfg, 12, aux=aux)
    if "zamba_attn" in cfg.types:
        first, second = (i for i, bt in enumerate(cfg.types) if bt == "zamba_attn")
        k = cache["main"][f"cache{first}"]["k"]
        two = (model.layers[first] is model.layers[second] and bool(k[0, :, :8].any())
               and bool(k[1, :, :8].any()) and not torch.equal(k[0], k[1]))
        notes.append(f"the shared block's two occurrences keep two caches: {two}")
        check(two, "zamba2: the shared block's occurrences do not keep two caches")
    cross = [c for group in cache.values() if group for c in group.values() if "ck" in c]
    before = [(c["ck"].clone(), c["cv"].clone()) for c in cross]
    for i in range(8, 12):
        logits, cache = transformer.decode_step(model, cache, toks[:, i:i + 1].to(dev), i, cfg,
                                                aux=aux)
    if cross:
        once = all(bool(c["ck"].any()) and torch.equal(c["ck"], ck) and torch.equal(c["cv"], cv)
                   for c, (ck, cv) in zip(cross, before))
        notes.append(f"cross caches written by prefill, unchanged by 4 decode steps: {once}")
        check(once, "vision: the cross cache changed after prefill")
    print(f"    prefill continuation vs token by token (2 x 12, prompt 8): {err:.3e}·scale "
          f"(gate {MODEL_DECODE_GATE:g})" + "".join(f"; {note}" for note in notes))
    check(err <= MODEL_DECODE_GATE, f"{cfg.name} continuation {err}")
    return out


def all_finite(torch, caches) -> bool:
    return all(bool(torch.isfinite(x.float()).all()) for group in caches.values() if group
               for leaves in group.values() for x in leaves.values())


def family_timing(torch, mods, model, card):
    """``generate`` at batch 4, prompt 128, 32 new tokens timed (prefill,
    decode per step, tokens/s, peak memory), one decode step profiled, and
    the bounds of the cost model: the prefill's f32 FLOPs, the decode step's
    bytes (every weight but the encoder's, all experts, the cache)."""
    from torch.profiler import ProfilerActivity, profile

    transformer, costs, decode, moe = mods.transformer, mods.costs, mods.decode, mods.moe
    cfg = model.cfg
    dev = model.device
    aux = mods.serve.stubs(cfg, GEN_BATCH, dev)
    prompts = torch.randint(0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT),
                            generator=torch.Generator().manual_seed(2)).to(dev)
    warm = decode.generate(model, cfg, prompts, max_new=GEN_NEW, aux=aux)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = decode.generate(model, cfg, prompts, max_new=GEN_NEW, aux=aux)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(tuple(out.shape) == (GEN_BATCH, GEN_NEW), f"{cfg.name} generate {tuple(out.shape)}")
    check(bool((out >= 0).all() and (out < cfg.vocab_size).all()), f"{cfg.name} token ids")
    max_seq = GEN_PROMPT + GEN_NEW
    step = decode.prepared_serve_step(cfg)
    prefill_ms, decode_ms = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = transformer.prefill(model, prompts, cfg, max_seq, aux=aux)
        tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        for t in range(GEN_PROMPT, max_seq - 1):
            tok, caches = step(model, caches, tok, t, aux=aux)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t0) * 1e3 / (GEN_NEW - 1))
    finite = bool(torch.isfinite(logits).all()) and all_finite(torch, caches)
    check(finite, f"{cfg.name}: prefill logits or a cache or state after 31 decode steps "
                  f"not finite")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(model, caches, tok, max_seq - 1, aux=aux)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    launches = sum(r[1] for r in rows)
    with moe.record_routing(model) as routed:
        transformer.prefill(model, prompts, cfg, max_seq, aux=aux)
    prefill_drops = drops(routed)
    decode_bytes = costs.decode_bytes(cfg, GEN_BATCH, max_seq)
    decode_bound_ms = decode_bytes / costs.HBM_BW * 1e3
    prefill_flops = costs.forward_flops(cfg, GEN_BATCH, GEN_PROMPT, "prefill")
    prefill_bound_ms = prefill_flops / costs.PEAK_FLOPS_F32 * 1e3
    tok_s = GEN_BATCH * GEN_NEW / gen_s
    print(f"    generate (batch {GEN_BATCH}, prompt {GEN_PROMPT}, {GEN_NEW} new) on {card}: "
          f"{gen_s * 1e3:.1f} ms, {tok_s:.1f} tok/s; prefill {prefill_ms[-1]:.2f} ms (runs "
          f"{', '.join(f'{m:.2f}' for m in prefill_ms)}; bound {prefill_bound_ms:.2f} ms: "
          f"{prefill_flops / 1e12:.3f} TFLOP at 67 TFLOP/s f32), decode {decode_ms[-1]:.3f} ms "
          f"per step (runs {', '.join(f'{m:.3f}' for m in decode_ms)}; bound "
          f"{decode_bound_ms:.3f} ms: {decode_bytes / 1e9:.2f} GB at 3.35 TB/s); peak device "
          f"memory {peak / 1e6:.1f} MB ({held / 1e6:.1f} MB held before); the warm-up's tokens "
          f"equal the timed call's: {bool(torch.equal(warm, out))}; prefill logits and every "
          f"cache and state after the 31 steps finite: {finite}")
    if routed:
        print(f"    MoE drops in the {GEN_BATCH} x {GEN_PROMPT} prefill: {prefill_drops} (token, slot) pairs over "
              f"{len(routed)} layers (capacity {moe.capacity(GEN_BATCH * GEN_PROMPT, cfg)}; the "
              f"reference's semantics, ungated)")
    print(f"    profile of one decode step (batch {GEN_BATCH}, position {max_seq - 1}): wall "
          f"{wall * 1e3:.3f} ms, device busy {busy_ms:.3f} ms ({100 * busy_ms / (wall * 1e3):.1f}%),"
          f" {launches} kernels run")
    for dev_us, count, name in rows[:5]:
        print(f"        {dev_us / 1e3:9.3f} ms  x{count:<5d} {name[:90]}")
    return {"generate_ms": gen_s * 1e3, "tok_s": tok_s, "prefill_ms": prefill_ms,
            "decode_ms_per_step": decode_ms, "prefill_bound_ms": prefill_bound_ms,
            "decode_bound_ms": decode_bound_ms, "decode_bytes": decode_bytes,
            "peak_mb": peak / 1e6, "held_mb": held / 1e6, "prefill_drops": prefill_drops,
            "decode_step_wall_ms": wall * 1e3, "decode_step_busy_ms": busy_ms,
            "decode_step_kernels": launches,
            "decode_step_top": [(name[:60], dev_us / 1e3) for dev_us, _, name in rows[:4]]}


def family_run(torch, mods, arch, card):
    """One family at full width on the card (depth cut as ``FAMILIES``
    says): parameters counted, parity with the CPU, the family's own check,
    ``generate`` timed and profiled; the model freed after."""
    spec = FAMILIES[arch]
    cfg = family_config(mods.get_config, arch)
    t_arch = time.perf_counter()
    model = mods.transformer.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    open_gates(torch, mods.blocks, model)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_arch
    n_params = sum(p.numel() for p in model.parameters())
    full = mods.get_config(arch)
    cut = "" if spec["cut"] is None else (
        f", cut from {full.num_layers} (the first {spec['cut'][0]}"
        + (f" and the last {spec['cut'][1]}" if spec["cut"][1] else "") + " of its layers)")
    print(f"  {arch}: {cfg.num_layers} layers{cut}, d_model {cfg.d_model}, {n_params:,} "
          f"parameters ({n_params * 4 / 1e9:.2f} GB f32) drawn on the card in {init_s:.2f} s"
          + ("; cross gates set to 0.5" if cfg.vision_seq else ""))
    check(n_params == cfg.param_count() == spec["params"], f"{arch} parameter count {n_params}")
    out = {"layers": cfg.num_layers, "layers_full": full.num_layers, "params": n_params,
           "init_s": init_s}
    aux = mods.serve.stubs(cfg, 1, model.device)
    if spec["cpu"]:
        out["parity"] = family_parity(torch, mods, model, aux)
    out["check"] = family_check(torch, mods, model, mods.serve.stubs(cfg, 2, model.device))
    out.update(family_timing(torch, mods, model, card))
    del model
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_arch
    print(f"    {arch}: {out['seconds']:.1f} s")
    return out


def family_phase(torch, mods, card):
    """The six families item 10b ported, each at full width on the card,
    then ``launch.serve`` at three of them as subprocesses."""
    import re

    out = {arch: family_run(torch, mods, arch, card) for arch in FAMILIES}
    cli = {}
    for arch in FAMILY_CLI:
        args = ["--arch", arch, "--batch", str(GEN_BATCH), "--prompt-len", str(GEN_PROMPT),
                "--max-new", str(GEN_NEW)]
        stdout, secs = run_module("repro_torch.launch.serve", args, timeout=600)
        lines = stdout.strip().splitlines()
        print(f"  python -m repro_torch.launch.serve {' '.join(args)} ({secs:.1f} s with start-up):")
        for line in lines[-2:]:
            print(f"    {line}")
        check(len(lines) >= 2 and re.fullmatch(
            rf"arch={arch} generated \({GEN_BATCH}, {GEN_NEW}\) in [0-9.]+s "
            r"\([0-9.]+ tok/s incl\. prompt\)", lines[-2]) is not None
            and lines[-1].startswith("sample: ["), f"launch.serve {arch} printed {lines[-2:]}")
        cli[arch] = {"line": lines[-2], "seconds": secs}
    return {"archs": out, "serve_cli": cli}



# ---------------------------------------------------------------------------
# phase 14: training
# ---------------------------------------------------------------------------


def train_batch(cfg, b, s, seed):
    """The reference smoke test's ``_batch`` layout drawn by numpy: tokens and
    targets (B, S), patches / frames at 0.1·N(0, 1)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.vision_seq:
        batch["patches"] = (0.1 * rng.standard_normal((b, cfg.vision_seq, cfg.d_model))).astype(
            np.float32)
    if cfg.is_encdec:
        batch["enc_frames"] = (0.1 * rng.standard_normal((b, cfg.encoder_seq, cfg.d_model))
                               ).astype(np.float32)
    return batch


def loss_and_grads(torch, mods, model, batch, cfg):
    """One ``loss_fn`` with gradients: (loss, MoE routing records, {name: grad}
    on the host, {dtype: count} of the matrices the blocks computed with,
    recompute included)."""
    batch = {k: torch.as_tensor(v).to(model.device) for k, v in batch.items()}
    model.zero_grad(set_to_none=True)
    with mods.transformer.record_compute_dtypes(model) as dtypes:
        with mods.moe.record_routing(model) as routed:
            loss, _ = mods.transformer.loss_fn(model, batch, cfg)
        loss.backward()
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).float().cpu()
             for n, p in model.named_parameters()}
    return float(loss.detach()), routed, grads, dict(dtypes)


def block_matrices(model):
    """Matrices (ndim >= 2) summed over the block calls of one forward."""
    units = list(model.layers) + (list(model.encoder.blocks) if model.cfg.is_encdec else [])
    return sum(p.ndim >= 2 for block in units for p in block.parameters())


def train_parity_reduced(torch, mods):
    """(a) All ten reduced archs, one loss_fn with gradients on the card and
    on the port's CPU path from the same weights and batch: f32 compute held
    at 1e-5 (loss) and 1e-4·max|g| (every leaf), MoE routing equal first;
    the arch's own bf16 compute finite, loss > 0.5, some gradient nonzero."""
    out = {}
    for arch in mods.ARCHS:
        base = mods.reduced_config(mods.get_config(arch))
        cfg = dataclasses.replace(base, dtype="float32")
        cpu = mods.transformer.init_params(cfg, torch.Generator().manual_seed(0))
        open_gates(torch, mods.blocks, cpu)
        card = same_weights(mods.transformer, cpu, torch.device("cuda"))
        cpu.requires_grad_(True)
        card.requires_grad_(True)
        batch = train_batch(cfg, 2, 16, seed=1)
        loss_c, routed_c, g_c, _ = loss_and_grads(torch, mods, cpu, batch, cfg)
        loss_g, routed_g, g_g, dt_g = loss_and_grads(torch, mods, card, batch, cfg)
        same_routes = all(torch.equal(a[0].cpu(), b[0]) for a, b in zip(routed_g, routed_c))
        check(len(routed_g) == len(routed_c) and same_routes, f"{arch}: MoE routing differs")
        gmax = max(float(g.abs().max()) for g in g_c.values())
        worst = max((float((g_g[n] - g_c[n]).abs().max()), n) for n in g_c)
        leaf = max(float((g_g[n] - g_c[n]).abs().max()) / max(float(g_c[n].abs().max()), 1e-30)
                   for n in g_c)
        e_loss = abs(loss_g - loss_c) / abs(loss_c)
        # the arch's own bf16 compute on the card: every matrix of every
        # block call a bf16 copy, forward and recompute (the f32 run above is
        # the control: the masters' f32)
        loss_b, _, g_b, dt_b = loss_and_grads(torch, mods, card, batch, base)
        finite = all(bool(torch.isfinite(g).all()) for g in g_b.values())
        nonzero = any(float(g.abs().max()) > 0 for g in g_b.values())
        calls = block_matrices(card) * (2 if base.remat == "block" else 1)
        bf16_only = dt_b == {torch.bfloat16: calls} and dt_g == {torch.float32: calls}
        print(f"  {arch}: f32 loss {loss_g:.6f} vs CPU {loss_c:.6f} ({e_loss:.2e} rel, gate "
              f"{TRAIN_F32_GATE['loss']:g}); grads {worst[0] / gmax:.2e}·max|g| (gate "
              f"{TRAIN_F32_GATE['grads']:g}; worst {worst[1]}; per leaf {leaf:.2e}); "
              f"{len(routed_g)} MoE calls routed alike; bf16 loss {loss_b:.4f}, grads finite "
              f"{finite}, nonzero {nonzero}; block matrices computed in bf16 "
              f"{dt_b.get(torch.bfloat16, 0)} of {calls} (f32 control: "
              f"{dt_g.get(torch.float32, 0)} in f32)")
        check(e_loss <= TRAIN_F32_GATE["loss"], f"{arch} f32 loss card vs CPU {e_loss}")
        check(worst[0] <= TRAIN_F32_GATE["grads"] * gmax, f"{arch} f32 grads {worst}")
        check(np.isfinite(loss_b) and loss_b > 0.5 and finite and nonzero,
              f"{arch} bf16 step: loss {loss_b}, finite {finite}, nonzero {nonzero}")
        check(bf16_only, f"{arch} compute dtypes: bf16 run {dt_b}, f32 run {dt_g}, {calls} calls")
        out[arch] = {"loss_rel_err": e_loss, "grad_err_over_max": worst[0] / gmax,
                     "grad_err_per_leaf": leaf, "moe_calls": len(routed_g), "bf16_loss": loss_b,
                     "bf16_matrix_calls": dt_b.get(torch.bfloat16, 0), "matrix_calls": calls}
    return out


def timed_backward(torch, fn, inputs, dout, iters=3):
    """fn(*inputs) forward + backward of ``dout``: (output, grads, ms per
    call over ``iters`` calls after the first, CUDA events)."""
    def run():
        for x in inputs:
            x.grad = None
        out = fn(*inputs)
        out.backward(dout)
        return out
    out = run()
    grads = [x.grad.clone() for x in inputs]
    ms = cuda_ms(torch, run, iters)
    return out.detach(), grads, ms


def flash_xent_phase(torch, mods):
    """(b) Flash attention's backward at granite-3-2b's attention shapes
    (B 1, S 4096, 32 heads over 8 KV heads, d 64, chunk 1024, causal)
    against autograd of the plain core (which materialises the scores), in
    f32 and bf16; the chunked cross-entropy at (2, 4096, 2048) x 49408
    padded vocab against a full-logits ``F.cross_entropy``."""
    import torch.nn.functional as F

    layers, losses = mods.layers, mods.losses
    cfg = mods.get_config(TRAIN_ARCH)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    b, s, h, hkv, d = 1, TRAIN_SEQ, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_actual
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((b, s, n, d), generator=gen, device=dev).to(dtype).requires_grad_(True)
                   for n in (h, hkv, hkv))
        dout = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
        o_f, g_f, ms_f = timed_backward(torch, lambda q, k, v: layers.attention(
            q, k, v, causal=True, chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv),
            (q, k, v), dout)
        o_p, g_p, ms_p = timed_backward(torch, lambda q, k, v: layers._plain_attention(
            q, k, v, True), (q, k, v), dout)
        errs = [rel_err(a.float(), b_.float()) for a, b_ in zip([o_f] + g_f, [o_p] + g_p)]
        name = str(dtype).split(".")[-1]
        print(f"  flash {name}: out {errs[0]:.2e}, dq {errs[1]:.2e}, dk {errs[2]:.2e}, dv "
              f"{errs[3]:.2e} ·max of the plain core's (gate {FLASH_GATE[name]:g}); fwd+bwd "
              f"{ms_f:.2f} ms chunked, {ms_p:.2f} ms plain")
        check(max(errs) <= FLASH_GATE[name], f"flash {name}: {errs}")
        out[f"flash_{name}"] = {"errs_out_dq_dk_dv": errs, "ms": ms_f, "plain_ms": ms_p}
        del q, k, v, dout, o_f, g_f, o_p, g_p
    torch.cuda.empty_cache()
    vpad, chunk = cfg.padded_vocab, cfg.xent_chunk
    hidden = torch.randn((TRAIN_BATCH, s, cfg.d_model), generator=gen, device=dev)
    embed = 0.02 * torch.randn((vpad, cfg.d_model), generator=gen, device=dev)
    targets = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, s), generator=gen, device=dev)
    pad_cols = torch.arange(vpad, device=dev) >= cfg.vocab_size

    def full(hid, emb):
        logits = (hid @ emb.T).masked_fill(pad_cols, -1e30)
        return F.cross_entropy(logits.reshape(-1, vpad), targets.reshape(-1))

    hid, emb = hidden.requires_grad_(True), embed.requires_grad_(True)
    l_c, g_c, ms_c = timed_backward(torch, lambda a, e: losses.chunked_softmax_xent(
        a, e, targets, cfg.vocab_size, chunk), (hid, emb), torch.ones((), device=dev))
    l_p, g_p, ms_p = timed_backward(torch, full, (hid, emb), torch.ones((), device=dev))
    e_loss = abs(float(l_c) - float(l_p)) / abs(float(l_p))
    e_h, e_e = rel_err(g_c[0], g_p[0]), rel_err(g_c[1], g_p[1])
    print(f"  chunked cross-entropy ({TRAIN_BATCH}, {s}, {cfg.d_model}) x {vpad} (chunk {chunk}):"
          f" loss {float(l_c):.6f} vs full logits {float(l_p):.6f} ({e_loss:.2e} rel), dhidden "
          f"{e_h:.2e}, dembed {e_e:.2e} ·max (gates 1e-5, 1e-4); fwd+bwd {ms_c:.2f} ms chunked, "
          f"{ms_p:.2f} ms full logits")
    check(e_loss <= 1e-5 and e_h <= 1e-4 and e_e <= 1e-4, f"xent: {e_loss}, {e_h}, {e_e}")
    out["xent"] = {"loss_rel_err": e_loss, "dhidden": e_h, "dembed": e_e, "ms": ms_c,
                   "full_logits_ms": ms_p}
    del hidden, embed, hid, emb, g_c, g_p
    torch.cuda.empty_cache()
    return out


def descent_check(torch, mods, model, cfg, batch):
    """The full-width gradient against the loss it predicts, in f32 compute:
    loss and gradient g on ``batch``, then one step of eta = DESCENT_DROP /
    |g|² along -g must lower the loss on the same batch by 0.5–1.5x
    eta·|g|² (the first-order prediction). The model keeps the step."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model.zero_grad(set_to_none=True)
    loss0, _ = mods.transformer.loss_fn(model, batch, cfg32)
    loss0.backward()
    params = [p for p in model.parameters() if p.grad is not None]
    gn2 = float(sum(torch.sum(p.grad.double() ** 2) for p in params))
    eta = DESCENT_DROP / gn2
    with torch.no_grad():
        for p in params:
            p.sub_(eta * p.grad)
        model.zero_grad(set_to_none=True)
        loss1, _ = mods.transformer.loss_fn(model, batch, cfg32)
    drop = float(loss0.detach()) - float(loss1)
    ratio = drop / DESCENT_DROP
    print(f"    descent check (f32 compute, step 1's batch): loss {float(loss0.detach()):.6f}, "
          f"|g| {gn2 ** 0.5:.4f}; a step of {eta:.3e} along -g predicts a drop of "
          f"{DESCENT_DROP:g}, measured {drop:.6f} ({ratio:.4f}x; gate 0.5–1.5x)")
    check(0.5 <= ratio <= 1.5, f"full-width descent check: {drop} against {DESCENT_DROP}")
    return {"loss": float(loss0.detach()), "grad_norm": gn2 ** 0.5, "eta": eta,
            "predicted_drop": DESCENT_DROP, "measured_drop": drop}


def full_width_train(torch, mods, card):
    """(c) granite-3-2b at full width, TRAIN_LAYERS of its layers: f32
    masters, bf16 compute, block remat, flash at chunk 1024, xent chunk 512,
    S 4096, batch 2,
    TRAIN_STEPS steps of ``train_loop.train``. Gates: every logged number
    finite; the logged loss falls (each is taken on a batch the model has
    not seen): the mean of the last TRAIN_WINDOW below the mean of the
    first TRAIN_WINDOW, and the last below the first; the loss on step 1's
    batch lower after training than at step 1; the descent check
    (``descent_check``). Printed: the median warm step, tokens/s and peak
    memory beside ``costs.step_cost``'s bound; one more step profiled."""
    from torch.profiler import ProfilerActivity, profile

    tl, costs = mods.train_loop, mods.costs
    dev = torch.device("cuda")
    cfg = dense_layers(mods.get_config(TRAIN_ARCH), TRAIN_LAYERS)
    tcfg = tl.TrainConfig(opt=mods.opt_config(TRAIN_STEPS, TRAIN_LR), num_steps=TRAIN_STEPS,
                          log_every=1)
    dcfg = mods.DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0, repeat_prob=0.75)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = tl.init_state(cfg, torch.Generator(device=dev).manual_seed(0), tcfg)
    n_params = sum(p.numel() for p in state["params"].parameters())
    state, hist = tl.train(cfg, tcfg, dcfg, state=state)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    stamps = [0.0] + [h["seconds"] for h in hist]
    steps_s = np.diff(stamps)
    warm = float(np.median(steps_s[1:]))
    tok_s = TRAIN_BATCH * TRAIN_SEQ / warm
    cost = costs.step_cost(cfg, mods.ShapeConfig("train_4k_batch2", TRAIN_SEQ, TRAIN_BATCH,
                                                 "train"), 1, {})
    flop_ms = cost.flops / costs.PEAK_FLOPS * 1e3
    byte_ms = cost.hbm_bytes / costs.HBM_BW * 1e3
    print(f"  {cfg.name} at full width: {n_params:,} parameters, {cfg.num_layers} of "
          f"{mods.get_config(TRAIN_ARCH).num_layers} layers, "
          f"S {TRAIN_SEQ}, batch {TRAIN_BATCH}, {TRAIN_STEPS} steps at lr {TRAIN_LR:g} on {card}")
    print(f"    losses {', '.join(f'{x:.4f}' for x in losses)}")
    print(f"    grad norms {', '.join(f'{x:.3f}' for x in norms)}")
    print(f"    step seconds {', '.join(f'{x:.3f}' for x in steps_s)}: median warm step "
          f"{warm * 1e3:.1f} ms, {tok_s:.1f} tokens/s; peak device memory {peak / 1e9:.2f} GB; "
          f"bound {max(flop_ms, byte_ms):.1f} ms ({cost.flops / 1e12:.1f} TFLOP at 989 TFLOP/s "
          f"bf16 = {flop_ms:.1f} ms; {cost.hbm_bytes / 1e9:.1f} GB at 3.35 TB/s = "
          f"{byte_ms:.1f} ms)")
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)), "full-width train: not finite")
    first, last = np.mean(losses[:TRAIN_WINDOW]), np.mean(losses[-TRAIN_WINDOW:])
    print(f"    logged loss: mean of steps 1–{TRAIN_WINDOW} {first:.4f}, of steps "
          f"{TRAIN_STEPS - TRAIN_WINDOW + 1}–{TRAIN_STEPS} {last:.4f}; step 1 {losses[0]:.4f}, "
          f"step {TRAIN_STEPS} {losses[-1]:.4f} (gates: lower)")
    check(last < first and losses[-1] < losses[0],
          f"full-width train: the logged loss does not fall: {losses}")
    descent = descent_check(torch, mods, state["params"], cfg, mods.make_batch(dcfg, 0, dev))
    print(f"    step 1's batch: loss {losses[0]:.4f} before training, {descent['loss']:.4f} after "
          f"the {TRAIN_STEPS} steps (f32 compute; gate: lower)")
    check(descent["loss"] < losses[0], f"full-width train: step 1's batch {losses[0]} -> "
          f"{descent['loss']}")
    step_fn = tl.make_train_step(cfg, tcfg.opt)
    batch = mods.make_batch(dcfg, TRAIN_STEPS, dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    launches = sum(r[1] for r in rows)
    print(f"    profile of step {TRAIN_STEPS + 1}: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / (wall * 1e3):.1f}%), {launches} kernels run")
    for dev_us, count, name in rows[:8]:
        print(f"      {dev_us / 1e3:9.3f} ms  x{count:<6d} {name[:90]}")
    del state, metrics, batch, step_fn
    torch.cuda.empty_cache()
    return {"params": n_params, "losses": losses, "grad_norms": norms, "descent": descent,
            "loss_window_means": [first, last],
            "step_seconds": steps_s.tolist(), "median_warm_step_ms": warm * 1e3,
            "tokens_per_s": tok_s, "peak_gb": peak / 1e9, "bound_ms": max(flop_ms, byte_ms),
            "flop_bound_ms": flop_ms, "byte_bound_ms": byte_ms, "profiled_wall_ms": wall * 1e3,
            "profiled_busy_ms": busy_ms, "profiled_launches": launches,
            "profiled_top": [(name[:60], dev_us / 1e3) for dev_us, _, name in rows[:6]]}


def restart_check(out_path):
    """(d), run as ``chip_smoke.py --restart-check OUT`` with
    CUBLAS_WORKSPACE_CONFIG set before CUDA starts: granite-3-2b at full
    width cut to 2 layers, 6 uninterrupted steps against a run that fails
    at step 4 (checkpoints every 2) and resumes, under
    ``torch.use_deterministic_algorithms(True)``; the card's checkpoint
    restored on the CPU, its leaf names against the reference's tree
    (``param_specs``, the port's copy of it). Writes a JSON record."""
    import tempfile

    import torch

    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.launch.train import opt_config
    from repro_torch.models import transformer
    from repro_torch.models.spec import iter_specs
    from repro_torch.training import checkpoint as ckpt_lib
    from repro_torch.training import data as data_lib
    from repro_torch.training import train_loop as tl

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dense_layers(get_config(TRAIN_ARCH), RESTART_LAYERS)
    opt = opt_config(RESTART_STEPS, TRAIN_LR)
    dcfg = data_lib.DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0, repeat_prob=0.75)
    t0 = time.perf_counter()
    plain, hist = tl.train(cfg, tl.TrainConfig(opt=opt, num_steps=RESTART_STEPS, log_every=1),
                           dcfg)
    want = tl.state_tree(plain)
    n_params = sum(p.numel() for p in plain["params"].parameters())
    del plain
    t_plain = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as ck:
        tcfg = tl.TrainConfig(opt=opt, num_steps=RESTART_STEPS, ckpt_dir=ck,
                              ckpt_every=RESTART_EVERY, log_every=1)
        t0 = time.perf_counter()
        try:
            tl.train(cfg, tcfg, dcfg, fail_at_step=RESTART_FAIL_AT)
            failed = False
        except RuntimeError as e:
            failed = "simulated node failure" in str(e)
        steps_before = ckpt_lib.all_steps(ck)
        resumed, hist2 = tl.train(cfg, tcfg, dcfg)
        t_restart = time.perf_counter() - t0
        got = tl.state_tree(resumed)
        del resumed
        ckpt_bytes = sum(f.stat().st_size for f in Path(ck, f"step_{RESTART_STEPS}").iterdir())
        with open(Path(ck, f"step_{RESTART_STEPS}", "manifest.json")) as f:
            names = set(json.load(f)["leaves"])
        t0 = time.perf_counter()
        on_cpu = ckpt_lib.restore(ck, RESTART_STEPS, want, device="cpu")
        t_restore = time.perf_counter() - t0
    fw, fg, fc = ckpt_lib.flatten(want), ckpt_lib.flatten(got), ckpt_lib.flatten(on_cpu)
    params = [k for k in fw if k.startswith("params/")]
    bit_equal = all(np.array_equal(fw[k], fg[k]) for k in fw)
    max_diff = max(float(np.abs(fw[k].astype(np.float64) - fg[k]).max()) for k in params)
    cpu_equal = all(fc[k].device.type == "cpu" and np.array_equal(fc[k].numpy(), fg[k])
                    for k in fg)
    leaves = [p for p, _ in iter_specs(transformer.param_specs(cfg))]
    ref_names = ({f"params/{p}" for p in leaves} | {f"opt/mu/{p}" for p in leaves}
                 | {f"opt/nu/{p}" for p in leaves} | {"opt/step"})
    rec = {"layers": RESTART_LAYERS, "params": n_params, "failed_at": RESTART_FAIL_AT if failed
           else None, "checkpoints_before_resume": steps_before, "resumed_from":
           hist2[0]["step"] - 1, "bit_equal": bit_equal, "max_param_diff": max_diff,
           "losses": [h["loss"] for h in hist], "resumed_losses": [h["loss"] for h in hist2],
           "checkpoint_gb": ckpt_bytes / 1e9, "restored_on_cpu_equal": cpu_equal,
           "leaf_names_equal_reference": names == ref_names, "leaves": len(names),
           "plain_s": t_plain, "fail_and_resume_s": t_restart, "cpu_restore_s": t_restore,
           "deterministic": torch.are_deterministic_algorithms_enabled()}
    Path(out_path).write_text(json.dumps(rec))
    return 0


def restart_phase():
    """(d) ``restart_check`` in a fresh process, with the cuBLAS workspace
    fixed before CUDA starts; its gates: the resumed params within 1e-6 of
    the uninterrupted run's (bit equality printed), the CPU restore equal,
    the leaf names the reference's."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp, "restart.json")
        env = {**os.environ, "PYTHONPATH": str(SRC), "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--restart-check",
                              str(path)], capture_output=True, text=True, env=env, timeout=900)
        secs = time.perf_counter() - t0
        if run.returncode:
            print(run.stdout[-6000:])
            print(run.stderr[-6000:], file=sys.stderr)
        check(run.returncode == 0, f"restart check exited {run.returncode}")
        rec = json.loads(path.read_text())
    print(f"  restart at full width, {rec['layers']} of 40 layers ({rec['params']:,} parameters, "
          f"{rec['checkpoint_gb']:.2f} GB per checkpoint; {secs:.1f} s with start-up): failed at "
          f"step {rec['failed_at']} with checkpoints {rec['checkpoints_before_resume']}, resumed "
          f"from step {rec['resumed_from']}; params bit-equal to the uninterrupted run: "
          f"{rec['bit_equal']} (max |diff| {rec['max_param_diff']:.3e}, gate 1e-6); the card's "
          f"checkpoint restored on the CPU equal: {rec['restored_on_cpu_equal']}; its "
          f"{rec['leaves']} leaf names the reference's: {rec['leaf_names_equal_reference']}; "
          f"deterministic algorithms {rec['deterministic']}")
    print(f"    losses {rec['losses']}, resumed {rec['resumed_losses']}")
    check(rec["failed_at"] == RESTART_FAIL_AT and rec["resumed_from"] == RESTART_FAIL_AT,
          f"restart: {rec}")
    check(rec["max_param_diff"] <= 1e-6, f"restart: params differ by {rec['max_param_diff']}")
    check(rec["restored_on_cpu_equal"] and rec["leaf_names_equal_reference"], f"restart: {rec}")
    rec["seconds"] = secs
    return rec


def compression_phase(torch, mods):
    """(e) int8 gradient compression on the reference test's tiny config on
    the card: 60 steps compressed and uncompressed, the compressed loss falls
    and ends within 0.05 of the uncompressed (the reference's gate)."""
    tl = mods.train_loop
    cfg = mods.ModelConfig(**TINY_TRAIN)
    opt = mods.OptConfig(learning_rate=3e-3, warmup_steps=5, total_steps=60)
    dcfg = mods.DataConfig(cfg.vocab_size, 16, 8, seed=0)
    hists = {}
    for comp in (False, True):
        tcfg = tl.TrainConfig(opt=opt, num_steps=60, compress_grads=comp, log_every=10)
        _, hists[comp] = tl.train(cfg, tcfg, dcfg)
    first, last, plain = hists[True][0]["loss"], hists[True][-1]["loss"], hists[False][-1]["loss"]
    print(f"  int8 compression with error feedback (tiny config, 60 steps): compressed loss "
          f"{first:.4f} -> {last:.4f}, uncompressed {hists[False][0]['loss']:.4f} -> {plain:.4f} "
          f"(gate: falls, and below uncompressed + 0.05)")
    check(last < first and last < plain + 0.05, f"compression: {first} -> {last} vs {plain}")
    return {"compressed": [h["loss"] for h in hists[True]],
            "uncompressed": [h["loss"] for h in hists[False]]}


def run_module_may_fail(module, args, timeout):
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-m", module, *args], capture_output=True, text=True,
                         env=env, timeout=timeout)
    return out.returncode, out.stdout + out.stderr


def train_cli_phase():
    """(f) ``python -m repro_torch.launch.train --arch granite-3-2b --reduce
    --steps 40`` as a subprocess; then with a checkpoint directory and
    ``--fail-at 20`` (must fail), and a rerun that resumes: its final loss
    equals the uninterrupted one's."""
    import tempfile

    base = ["--arch", TRAIN_ARCH, "--reduce", "--steps", str(TRAIN_CLI_STEPS)]
    # the uninterrupted run beside the failing one: two small children on the card
    t0 = time.perf_counter()
    plain = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *base],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env={**os.environ, "PYTHONPATH": str(SRC)})
    with tempfile.TemporaryDirectory() as ck:
        try:
            rc, text = run_module_may_fail("repro_torch.launch.train",
                                           base + ["--ckpt-dir", ck, "--fail-at",
                                                   str(TRAIN_CLI_FAIL_AT)], timeout=600)
            stdout, stderr = plain.communicate(timeout=600)
        finally:
            if plain.poll() is None:
                plain.kill()
                plain.communicate()
        secs = time.perf_counter() - t0
        if plain.returncode:
            print(stderr[-4000:], file=sys.stderr)
        check(plain.returncode == 0, f"launch.train {' '.join(base)} exited {plain.returncode}")
        final = stdout.strip().splitlines()[-1]
        check(rc != 0 and f"simulated node failure at step {TRAIN_CLI_FAIL_AT}" in text,
              f"launch.train --fail-at: exit {rc}")
        again, secs2 = run_module("repro_torch.launch.train", base + ["--ckpt-dir", ck],
                                  timeout=600)
    rerun = again.strip().splitlines()[-1]
    print(f"  python -m repro_torch.launch.train {' '.join(base)}: {final}; beside it with "
          f"--fail-at {TRAIN_CLI_FAIL_AT}: exit {rc} (both {secs:.1f} s with start-up); the rerun "
          f"({secs2:.1f} s): {rerun}")
    check(final.startswith("final loss: ") and rerun == final,
          f"launch.train rerun {rerun!r} vs {final!r}")
    return {"final": final, "rerun": rerun, "seconds": secs}


def train_mods(mods):
    """``mods`` with what the training phase reads."""
    from repro_torch.configs import ARCHS, ModelConfig, ShapeConfig
    from repro_torch.launch.train import opt_config
    from repro_torch.models import layers, losses
    from repro_torch.training import train_loop
    from repro_torch.training.data import DataConfig, make_batch
    from repro_torch.training.optimizer import OptConfig

    return SimpleNamespace(**vars(mods), ARCHS=ARCHS, ModelConfig=ModelConfig,
                           ShapeConfig=ShapeConfig, layers=layers, losses=losses,
                           train_loop=train_loop, DataConfig=DataConfig, make_batch=make_batch,
                           OptConfig=OptConfig, opt_config=opt_config)


def train_phase(torch, mods, card):
    """Phase 14: training on the card, (a)–(f)."""
    out = {}
    t0 = time.perf_counter()
    print("  (a) the ten reduced archs, one train step, card vs the port's CPU path:")
    out["reduced"] = train_parity_reduced(torch, mods)
    print("  (b) flash attention's backward and the chunked cross-entropy at full width:")
    out.update(flash_xent_phase(torch, mods))
    print("  (c) granite-3-2b trains at full width:")
    out["full_width"] = full_width_train(torch, mods, card)
    print("  (d) restart:")
    out["restart"] = restart_phase()
    print("  (e) int8 gradient compression:")
    out["compression"] = compression_phase(torch, mods)
    print("  (f) the command line:")
    out["cli"] = train_cli_phase()
    out["seconds"] = time.perf_counter() - t0
    print(f"  training phase: {out['seconds']:.1f} s")
    return out


def dryrun_sweep(tmp):
    """(a) ``python -m repro_torch.launch.dryrun --both-meshes`` in a
    subprocess (its fake 256/512-rank group never meets this process's
    groups): 64 cells ok and 16 skipped, exactly where ``applicable`` says."""
    from repro_torch.configs import SHAPES, applicable, get_config

    stdout, seconds = run_module("repro_torch.launch.dryrun",
                                 ["--both-meshes", "--artifacts", str(tmp / "dryrun")], timeout=600)
    lines = [line for line in stdout.splitlines() if line.startswith("[")]
    counts = {k: sum(line.startswith(f"[{k:4s}]") for line in lines) for k in DRYRUN_COUNTS}
    records = [json.loads(p.read_text()) for p in sorted((tmp / "dryrun").glob("*.json"))]
    misplaced = []
    for r in records:
        arch, shape_name, _ = r["cell"].split("__")
        if (r["status"] == "skip") == applicable(get_config(arch), SHAPES[shape_name])[0]:
            misplaced.append(r["cell"])
    for line in lines:
        print(f"    | {line}")
    print(f"  dry run over the fake groups: {seconds:.1f} s wall with start-up; cells {counts} "
          f"(expected {DRYRUN_COUNTS}); skips where applicable says: {not misplaced}")
    check(counts == DRYRUN_COUNTS, f"dry run: cells {counts}, expected {DRYRUN_COUNTS}")
    check(not misplaced, f"dry run: skipped against applicable: {misplaced}")
    per_rank = {r["cell"]: r["memory"]["argument_bytes"] for r in records if r["status"] == "ok"}
    return {"seconds": seconds, "counts": counts, "argument_bytes": per_rank}


def dryrun_card_cell(torch, mesh, tmp):
    """(b) xlstm-1.3b x long_500k at full width (batch 1, 524288 positions)
    on the one-rank nccl mesh: the dry run's bytes for the cell against the
    reference's, its arguments materialised on the card under their
    placements against that number, and one decode step on them."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.sharding import mesh_sizes
    from repro_torch.launch import dryrun

    arch, shape_name = DRYRUN_CARD_CELL
    run_module("repro_torch.launch.dryrun", ["--arch", arch, "--shape", shape_name, "--data", "1",
                                             "--model", "1", "--artifacts", str(tmp / "card")],
               timeout=300)
    rec = json.loads((tmp / "card" / f"{arch}__{shape_name}__pod1_d1m1.json").read_text())
    want = rec["memory"]["argument_bytes"]
    check(want == JAX_CPU_CARD_CELL_BYTES,
          f"dry run {arch} x {shape_name}: {want} argument bytes, the reference's "
          f"{JAX_CPU_CARD_CELL_BYTES}")

    fn, args, placements, _ = dryrun.build_cell(get_config(arch), SHAPES[shape_name],
                                                 mesh_sizes(mesh))
    # NCCL's first scatter and broadcast, before the count
    warm = torch.zeros(8, 8, device="cuda")
    for place in ((Shard(0), Shard(1)), (Replicate(), Replicate())):
        distribute_tensor(warm, mesh, place)
    del warm
    before = settled_memory(torch)
    blocks_before = active_blocks(torch)
    real = dryrun.materialize(args, placements, mesh, torch.Generator(device="cuda").manual_seed(0))
    after = settled_memory(torch)
    grown, asked = after[0] - before[0], after[1] - before[1]
    tensors = list(real[0].parameters()) + [t for a in real[1:] if a is not None
                                            for t in tensor_leaves(a)]
    sizes = [t.numel() * t.element_size() for t in tensors]
    held = sum(sizes)
    # each block rounds up to 512 bytes, and a block of the large pool is
    # not split when at most 1 MiB would remain
    slack = sum(ALLOC_ROUND + (ALLOC_LARGE_REMAINDER if n > ALLOC_LARGE_REMAINDER else 0)
                for n in sizes)
    ours = {t.untyped_storage().data_ptr() for t in tensors}
    blocks = active_blocks(torch)
    in_blocks = sum(size for addr, size in blocks.items() if addr in ours)
    other = sorted((size for addr, size in blocks.items()
                    if addr not in blocks_before and addr not in ours), reverse=True)
    print(f"  {arch} x {shape_name} on the (1, 1) nccl mesh: the dry run's argument bytes "
          f"{want} (the reference's {JAX_CPU_CARD_CELL_BYTES}); materialised on the card "
          f"under the placements, {len(tensors)} tensors holding {held} bytes: the "
          f"allocations asked for {asked} more bytes (gate: {want}); memory_allocated grew "
          f"{grown} (gate: {want} to {want + slack}), {in_blocks} of them in the tensors' own "
          f"blocks; other blocks that appeared: {len(other)}, {sum(other)} bytes")
    check(held == want, f"{arch}: the materialised tensors hold {held} bytes, not {want}")
    check(asked == want, f"{arch}: the allocations asked for {asked} bytes, not {want}")
    check(want <= grown <= want + slack, f"{arch}: memory_allocated grew {grown}, not {want}")

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        nxt, caches = fn(*real)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    temp = torch.cuda.max_memory_allocated() - base
    finite = all(bool(torch.isfinite(t.float()).all()) for t in tensor_leaves(caches))
    print(f"  one decode step at position {int(real[3])}: {times[0]:.2f} ms (first), "
          f"{times[1]:.2f} ms (second); peak minus the arguments {temp} bytes (the "
          f"temporaries the dry run does not count); next ids {nxt.flatten().tolist()}, "
          f"states finite {finite}")
    check(tuple(nxt.shape) == (1, 1) and 0 <= int(nxt) < get_config(arch).vocab_size,
          f"{arch}: next ids {nxt}")
    check(finite, f"{arch}: non-finite states after the decode step")
    del real, nxt, caches
    torch.cuda.empty_cache()
    return {"argument_bytes": want, "memory_grown": grown, "requested_grown": asked,
            "slack": slack, "tensors": len(tensors),
            "step_ms": times, "temp_bytes": temp}


def settled_memory(torch) -> tuple[int, int]:
    """(``memory_allocated``, the bytes the live allocations asked for)
    once they hold still: NCCL keeps the inputs of a finished collective
    until its watchdog thread releases them, so read every 0.2 s until two
    readings agree (at most 10 s)."""
    def read():
        return (torch.cuda.memory_allocated(),
                torch.cuda.memory_stats().get("requested_bytes.all.current", -1))

    torch.cuda.synchronize()
    last = read()
    for _ in range(50):
        time.sleep(0.2)
        now = read()
        if now == last:
            break
        last = now
    return last


def active_blocks(torch) -> dict:
    """{address: size} of the caching allocator's live blocks."""
    return {b["address"]: b["size"] for seg in torch.cuda.memory_snapshot()
            for b in seg["blocks"] if b["state"] == "active_allocated"}


def tensor_leaves(tree):
    """The tensors of a tensor or of nested dicts of them."""
    from repro_torch.training.checkpoint import flatten

    if not isinstance(tree, dict):
        return [tree]
    return [t for t in flatten(tree).values() if t is not None]


def elastic_restore(torch, mesh, tmp):
    """(c) a reduced granite-3-2b train state (RESTORE_STEPS steps in)
    saved with ``checkpoint.save`` and restored onto the nccl mesh with
    ``shardings=``: every leaf a DTensor on the card under the placements
    asked for, bit-equal to what was saved."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.distributed.sharding import NamedSharding, named_shardings
    from repro_torch.models import transformer
    from repro_torch.training import checkpoint as ckpt_lib
    from repro_torch.training import train_loop
    from repro_torch.training.checkpoint import flatten
    from repro_torch.training.data import DataConfig

    cfg = reduced_config(get_config(TRAIN_ARCH))
    tcfg = train_loop.TrainConfig(num_steps=RESTORE_STEPS, log_every=1)
    state, _ = train_loop.train(cfg, tcfg, DataConfig(cfg.vocab_size, 16, 4, seed=0),
                                device="cuda")
    saved = train_loop.state_tree(state)
    ckpt_lib.save(str(tmp / "ckpt"), RESTORE_STEPS, saved)
    psh = named_shardings(transformer.param_specs(cfg), mesh)
    shardings = {"params": psh, "opt": {"mu": psh, "nu": psh,
                                        "step": NamedSharding(mesh, (Replicate(), Replicate()))}}
    back = flatten(ckpt_lib.restore(str(tmp / "ckpt"), RESTORE_STEPS, train_loop.state_like(state),
                                    shardings=shardings))
    want, asked = flatten(saved), flatten(shardings)
    bad = [k for k, t in back.items()
           if not (isinstance(t, DTensor) and t.device.type == "cuda"
                   and t.placements == asked[k].placements and t.device_mesh is mesh
                   and np.array_equal(t.full_tensor().cpu().numpy(), want[k]))]
    sharded = sum(any(p.is_shard() for p in asked[k].placements) for k in back)
    print(f"  elastic restore: reduced {TRAIN_ARCH} state after {RESTORE_STEPS} steps, "
          f"{len(back)} leaves ({sharded} with a Shard placement) restored onto the nccl mesh "
          f"with shardings=: bit-equal under the placements asked for {not bad}")
    check(back.keys() == want.keys() and not bad, f"elastic restore: leaves off {bad}")
    return {"leaves": len(back), "sharded": sharded}


MULTIHOST_CHILD = (
    "import json, torch.distributed as dist\n"
    "from repro_torch.launch import multihost\n"
    "out = multihost.initialize()\n"
    "out['backend'] = dist.get_backend() if dist.is_initialized() else None\n"
    "if dist.is_initialized():\n"
    "    dist.destroy_process_group()\n"
    "print(json.dumps(out))\n"
)


def multihost_phase():
    """(d) ``multihost.initialize()`` in two child processes at once: with
    ``COORDINATOR_ADDRESS=127.0.0.1:<free port>``, ``NUM_PROCESSES=1``,
    ``PROCESS_ID=0`` an nccl group; without them no group; both report one
    process of one card."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = {k: v for k, v in os.environ.items()
            if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")}
    base["PYTHONPATH"] = str(SRC)
    procs = {label: subprocess.Popen([sys.executable, "-c", MULTIHOST_CHILD],
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                     env={**base, **extra})
             for label, extra in (("coordinator", {"COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                                                   "NUM_PROCESSES": "1", "PROCESS_ID": "0"}),
                                  ("alone", {}))}
    got = {}
    for label, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        if proc.returncode:
            print(stderr[-4000:], file=sys.stderr)
        check(proc.returncode == 0, f"multihost.initialize ({label}) exited {proc.returncode}")
        got[label] = json.loads(stdout.splitlines()[-1])
    one = {"process_index": 0, "process_count": 1, "local_devices": 1, "global_devices": 1}
    print(f"  multihost.initialize in a child: with a coordinator {got['coordinator']}; "
          f"alone {got['alone']}")
    check(got["coordinator"] == {**one, "backend": "nccl"},
          f"multihost with a coordinator: {got['coordinator']}")
    check(got["alone"] == {**one, "backend": None}, f"multihost alone: {got['alone']}")
    return got


def dryrun_phase(torch, card):
    """Phase 15: the mesh rules and the dry run, (a)–(d)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        print("  (a) the sweep:")
        out["sweep"] = dryrun_sweep(tmp)
        mesh = tmesh.make_debug_mesh(device="cuda", backend="nccl")
        try:
            dist.barrier()  # NCCL's own buffers before the byte count
            print(f"  (b) the one cell one card holds [{card}]:")
            out["card_cell"] = dryrun_card_cell(torch, mesh, tmp)
            print("  (c) elastic restore:")
            out["restore"] = elastic_restore(torch, mesh, tmp)
        finally:
            dist.destroy_process_group()
    print("  (d) multi-host start:")
    out["multihost"] = multihost_phase()
    out["seconds"] = time.perf_counter() - t0
    print(f"  dry-run phase: {out['seconds']:.1f} s")
    return out


# a counterpart's ``main`` (or another ``entry``) run in a child process once
# for each argv in a list (the command lines a user would type), with the launch counters zeroed
# just before and read just after each run, each checkpoint save timed (step,
# seconds) and the peak memory read; each run's stdout follows a "--- run i"
# line, and its records and arrays (keyed "i.name") go to an .npz file
EXAMPLE_CHILD = (
    "import json, runpy, sys, time\n"
    "import numpy as np, torch\n"
    "from repro_torch.kernels.project import ops as project_ops\n"
    "from repro_torch.kernels.residual import ops as residual_ops\n"
    "from repro_torch.kernels.trisolve import ops as trisolve_ops\n"
    "from repro_torch.training import checkpoint as ckpt_lib\n"
    "script, entry, out_path, runs = sys.argv[1:4] + [json.loads(sys.argv[4])]\n"
    "saves, save = [], ckpt_lib.save\n"
    "def timed_save(ckpt_dir, step, *args, **kwargs):\n"
    "    t0 = time.perf_counter()\n"
    "    path = save(ckpt_dir, step, *args, **kwargs)\n"
    "    saves.append((step, time.perf_counter() - t0))\n"
    "    return path\n"
    "ckpt_lib.save = timed_save\n"
    "main = runpy.run_path(script)[entry]\n"
    "records, arrays = [], {}\n"
    "for i, argv in enumerate(runs):\n"
    "    print(f'--- run {i}', flush=True)\n"
    "    saves.clear()\n"
    "    trisolve_ops.launches = project_ops.launches = residual_ops.launches = 0\n"
    "    torch.cuda.reset_peak_memory_stats()\n"
    "    t0 = time.perf_counter()\n"
    "    result = main(argv)\n"
    "    seconds = time.perf_counter() - t0\n"
    "    launches = {'trisolve': trisolve_ops.launches,\n"
    "                'consensus_update': project_ops.launches,\n"
    "                'residual': residual_ops.launches}\n"
    "    arrays.update({f'{i}.{k}': v for k, v in result.items() if isinstance(v, np.ndarray)})\n"
    "    records.append({**{k: v for k, v in result.items() if not isinstance(v, np.ndarray)},\n"
    "                    'launches': launches, 'checkpoint_saves': list(saves),\n"
    "                    'seconds': seconds, 'peak_bytes': torch.cuda.max_memory_allocated()})\n"
    "np.savez(out_path, records=json.dumps(records, default=float), **arrays)\n"
)


def run_example(script, runs, out_path, entry="main"):
    """``script``'s ``entry`` for each argv of ``runs`` in one child process
    (``EXAMPLE_CHILD``): ([{"stdout", "record", its arrays} per run], seconds
    with start-up). A non-zero exit prints its output's end and fails."""
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", EXAMPLE_CHILD, str(SRC.parent / script), entry,
                          str(out_path), json.dumps(runs)], capture_output=True, text=True,
                         env=env, timeout=EXAMPLE_TIMEOUT)
    secs = time.perf_counter() - t0
    if out.returncode:
        print(out.stdout[-6000:])
        print(out.stderr[-6000:], file=sys.stderr)
    check(out.returncode == 0, f"{script} {runs} exited {out.returncode}")
    stdouts = out.stdout.split("--- run ")[1:]
    with np.load(out_path) as z:
        records = json.loads(str(z["records"]))
        got = [{"stdout": text.split("\n", 1)[1], "record": rec,
                **{k.split(".", 1)[1]: z[k] for k in z.files if k.startswith(f"{i}.")}}
               for i, (text, rec) in enumerate(zip(stdouts, records))]
    check(len(got) == len(runs), f"{script}: {len(got)} of {len(runs)} runs reported")
    return got, secs


def dense_gate(on, off, what):
    diff = float(np.abs(on - off).max())
    tol = 1e-4 * max(1.0, float(np.abs(off).max()))
    check(diff <= tol, f"{what}: kernels on and off differ by {diff} (tol {tol})")
    return diff, tol


def quickstart_run(tmp):
    """examples/quickstart_torch.py with and without --kernels."""
    (on, off), secs = run_example("examples/quickstart_torch.py", [["--kernels"], []],
                                  tmp / "quickstart.npz")
    print(f"  quickstart --kernels, then without (one child, {secs:.1f} s with start-up):")
    for run in (on, off):
        rec = run["record"]
        print("    " + " | ".join(run["stdout"].strip().splitlines())
              + f"; launches {rec['launches']}")
        check(rec["max_err"] < QUICKSTART_ERR_GATE, f"quickstart max err {rec['max_err']}")
        check(rec["mode"] == "wide", f"quickstart mode {rec['mode']}")
    diff, tol = dense_gate(on["x"], off["x"], "quickstart")
    launches = on["record"]["launches"]
    print(f"    max |x_kernels - x_plain| {diff:.3e} (tol {tol:.1e}); launches with --kernels "
          f"{launches} (expected {QUICKSTART_LAUNCHES})")
    check(launches == QUICKSTART_LAUNCHES, f"quickstart --kernels launches {launches}")
    return {"kernels": on["record"], "plain": off["record"], "max_abs_diff_vs_plain": diff,
            "seconds_with_startup": secs}


def solve_sparse_run(tmp):
    """examples/solve_sparse_torch.py: --full --kernels at the paper's shape
    (its lines, launches and acceleration; every number finite), then the
    default n = 1141 with and without --kernels, held at the gates. The
    gates are not held at --full: there every J = 4 block is square and
    numerically rank-deficient (the smallest singular value 1e-9 to 3e-6
    of the largest), so the trisolve amplifies rounding into x (a 1e-7
    relative change of b moves x by ~6 of its max 14-30 on the CPU) and the
    batched error to the truth is O(1) in both packages (the JAX package's
    1.33 on the CPU): SPARSE_FULL_REFERENCE."""
    runs = (("full", ["--full", "--kernels"]), ("kernels", ["--kernels"]), ("plain", []))
    got, secs = run_example("examples/solve_sparse_torch.py", [argv for _, argv in runs],
                            tmp / "solve_sparse.npz")
    print(f"  solve_sparse --full --kernels, then --kernels and no flag at n = 1141 (one child, "
          f"{secs:.1f} s with start-up):")
    out = dict(zip([label for label, _ in runs], got))
    for (label, argv), run in zip(runs, got):
        rec = run["record"]
        print(f"    {' '.join(argv) or '(no flag)'}:")
        for line in run["stdout"].strip().splitlines():
            print(f"      {line}" if line else "")
        print(f"      launches {rec['launches']}")
        numbers = [v for m in rec["methods"].values() for v in m.values() if not isinstance(v, str)]
        check(all(np.isfinite(numbers)) and np.isfinite(run["x"]).all()
              and np.isfinite(run["batched_x"]).all(), f"solve_sparse {label}: a non-finite number")
        check(rec["methods"]["dapc"]["mode"] == "tall",
              f"solve_sparse {label}: mode {rec['methods']['dapc']['mode']}")
        if "--kernels" in argv:
            check(rec["launches"] == SPARSE_LAUNCHES, f"solve_sparse {argv} launches {rec['launches']}")
        if label != "full":
            check(rec["batched_rel_err"] < SPARSE_BATCHED_GATE,
                  f"solve_sparse {label}: batched max rel err {rec['batched_rel_err']}")
    on, off = out["kernels"], out["plain"]
    diff, tol = dense_gate(on["x"], off["x"], "solve_sparse dapc")
    bdiff, btol = dense_gate(on["batched_x"], off["batched_x"], "solve_sparse batched")
    mse = [r["record"]["methods"]["dapc"]["final_mse"] for r in (on, off)]
    errs = [r["record"]["batched_rel_err"] for r in (on, off)]
    full = out["full"]["record"]
    print(f"    n = 1141, kernels on vs off: dapc max |dx| {diff:.3e} (tol {tol:.1e}), final MSE "
          f"{mse[0]:.6e} / {mse[1]:.6e}; batched max |dX| {bdiff:.3e} (tol {btol:.1e}), max rel "
          f"err {errs[0]:.3e} / {errs[1]:.3e} (gate {SPARSE_BATCHED_GATE:g}); launches "
          f"{on['record']['launches']} (expected {SPARSE_LAUNCHES})")
    print(f"    --full: acceleration {full['acceleration']:.4f}x (not gated); dapc final MSE "
          f"{full['methods']['dapc']['final_mse']:.4e}, batched max rel err "
          f"{full['batched_rel_err']:.4e} (the JAX package on the CPU: "
          f"{SPARSE_FULL_REFERENCE['batched_rel_err']:g}; not gated)")
    return {**{label: run["record"] for label, run in out.items()},
            "max_abs_diff_vs_plain": diff, "batched_max_abs_diff_vs_plain": bdiff,
            "seconds_with_startup": secs}


def train_lm_numbers(rec, batch, seq):
    """Step ms between the first and last logged step (the checkpoint saves
    in that window taken out), tokens/s, peak GB and the saves' seconds."""
    hist = rec["history"]
    first, last = hist[0], hist[-1]
    saved = sum(secs for step, secs in rec["checkpoint_saves"] if first["step"] < step < last["step"])
    step_ms = (last["seconds"] - first["seconds"] - saved) / (last["step"] - first["step"]) * 1e3
    return {"step_ms": step_ms, "tokens_per_s": batch * seq / step_ms * 1e3,
            "peak_gb": rec["peak_bytes"] / 1e9,
            "checkpoint_seconds": [secs for _, secs in rec["checkpoint_saves"]]}


def print_train_lm(label, rec, stdout, numbers):
    hist = rec["history"]
    print(f"    {label}: {stdout.strip().splitlines()[0]}; logged losses (steps "
          f"{hist[0]['step']}..{hist[-1]['step']}) " + " ".join(f"{h['loss']:.4f}" for h in hist)
          + f"; drop {rec['drop']:.4f}; {numbers['step_ms']:.2f} ms a step, "
          f"{numbers['tokens_per_s']:.0f} tokens/s, peak {numbers['peak_gb']:.3f} GB, "
          + ("checkpoint saves " + ", ".join(f"{s:.2f}" for s in numbers["checkpoint_seconds"])
             + " s" if numbers["checkpoint_seconds"] else "no checkpoints"))


def train_lm_control(torch):
    """lm-100m with the example's recipe and data but a learning rate of
    TRAIN_LM_CONTROL_LR, for the first TRAIN_LM_CONTROL_STEPS steps of the
    recipe's 300-step schedule, in this process through ``train_loop.train``:
    does the loss climb above ln 32000 at the lower rate too?"""
    import runpy

    from repro_torch.training import data as data_lib
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import OptConfig

    cfg = runpy.run_path(str(SRC.parent / "examples" / "train_lm_torch.py"))["lm_config"](False)
    steps = TRAIN_LM_STEPS["lm-100m"]
    tcfg = train_loop.TrainConfig(
        opt=OptConfig(learning_rate=TRAIN_LM_CONTROL_LR, warmup_steps=steps // 10,
                      total_steps=steps), num_steps=TRAIN_LM_CONTROL_STEPS,
        log_every=steps // 15)
    dcfg = data_lib.DataConfig(cfg.vocab_size, 128, 8, seed=0, repeat_prob=0.75)
    torch.cuda.reset_peak_memory_stats()
    _, hist = train_loop.train(cfg, tcfg, dcfg, device="cuda")
    rec = {"history": hist, "drop": hist[0]["loss"] - hist[-1]["loss"], "checkpoint_saves": [],
           "peak_bytes": torch.cuda.max_memory_allocated()}
    numbers = train_lm_numbers(rec, 8, 128)
    print_train_lm(f"the control, lm-100m at lr {TRAIN_LM_CONTROL_LR:g} for the first "
                   f"{TRAIN_LM_CONTROL_STEPS} steps (in this process, not gated)", rec,
                   f"model: {cfg.name}", numbers)
    return {"lr": TRAIN_LM_CONTROL_LR, "drop": rec["drop"], "history": hist, **numbers}


def train_lm_run(torch, tmp):
    """examples/train_lm_torch.py at its default lm-100m (300 steps) and the
    docstring's --small --steps 150, each on a fresh --ckpt-dir, in one
    child through ``run`` (``main`` without the gate); the reference's drop
    > 0.1 held for --small; for lm-100m printed and recorded, not gated: the
    recipe's lr 3e-3 makes its loss rise above ln 32000 after the warmup in
    the JAX package too (tests/test_torch_examples.py), and a control at
    TRAIN_LM_CONTROL_LR shows what the same model does at a lower rate. Then,
    in the same child, the default again on the first directory: it
    restores the step-300 checkpoint from disk and trains nothing."""
    ckpt = {name: str(tmp / f"ckpt_{name}") for name in TRAIN_LM_STEPS}
    runs = (("lm-100m", ["--ckpt-dir", ckpt["lm-100m"]]),
            ("lm-10m", ["--small", "--steps", str(TRAIN_LM_STEPS["lm-10m"]), "--ckpt-dir",
                        ckpt["lm-10m"]]))
    got, secs = run_example("examples/train_lm_torch.py",
                            [argv for _, argv in runs] + [runs[0][1]], tmp / "train_lm.npz", "run")
    *got, again = got
    print(f"  train_lm (defaults), then --small --steps {TRAIN_LM_STEPS['lm-10m']}, then the "
          f"defaults again on the first --ckpt-dir (one child, {secs:.1f} s with start-up):")
    out = {"seconds_with_startup": secs}
    for (name, argv), run in zip(runs, got):
        rec = run["record"]
        numbers = train_lm_numbers(rec, 8, 128)
        print_train_lm(" ".join(argv[:-2]) or "(defaults)", rec, run["stdout"], numbers)
        check(rec["name"] == name and rec["history"][-1]["step"] == TRAIN_LM_STEPS[name]
              and all(np.isfinite([h["loss"] for h in rec["history"]])),
              f"train_lm {name}: {rec['name']}, last step {rec['history'][-1]['step']}")
        if name == "lm-10m":
            check(rec["drop"] > TRAIN_LM_DROP_GATE, f"train_lm --small: loss drop {rec['drop']}")
        out[name] = {"params": rec["params"], "drop": rec["drop"], "history": rec["history"],
                     **numbers}
    rec = again["record"]
    print(f"    the defaults again on the same --ckpt-dir ({rec['seconds']:.1f} s): "
          f"{again['stdout'].strip().splitlines()[-1]}")
    check(rec["resumed_from"] == TRAIN_LM_STEPS["lm-100m"] and rec["history"] == [],
          f"train_lm rerun resumed from {rec['resumed_from']}, trained {len(rec['history'])} logs")
    out["rerun"] = {"resumed_from": rec["resumed_from"], "seconds": rec["seconds"]}
    out["control"] = train_lm_control(torch)
    return out


def report_counts(report):
    """Span kinds and the batch-size histogram off a trace report's text."""
    lines = report.splitlines()
    kinds = {line.split()[0] for line in lines[2:] if line and not line.startswith(" ")
             and not line.startswith(("batch sizes:", "slowest"))}
    sizes = {}
    if "batch sizes:" in lines:
        for line in lines[lines.index("batch sizes:") + 1:]:
            if not line.startswith("  "):
                break
            size, count = line.split(":")
            sizes[int(size)] = int(count.split()[0])
    return kinds, sizes


def trace_report_run(tmp):
    """serve_solver --kernels on the card at TRACE_REQUESTS requests with both
    exports, then tools/trace_report_torch.py on each file."""
    chrome, jsonl = tmp / "serve.json", tmp / "serve.jsonl"
    stdout, secs = run_module("repro_torch.launch.serve_solver",
                              ["--kernels", "--requests", str(TRACE_REQUESTS), "--trace-out",
                               str(chrome), "--trace-jsonl", str(jsonl)], timeout=EXAMPLE_TIMEOUT)
    print(f"  serve_solver --kernels --requests {TRACE_REQUESTS} ({secs:.1f} s with start-up): "
          + " | ".join(stdout.strip().splitlines()[-4:]))
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    reports = {}
    for path in (chrome, jsonl):
        out = subprocess.run([sys.executable, str(SRC.parent / "tools" / "trace_report_torch.py"),
                              str(path)], capture_output=True, text=True, env=env,
                             timeout=EXAMPLE_TIMEOUT)
        if out.returncode:
            print(out.stderr[-4000:], file=sys.stderr)
        check(out.returncode == 0, f"trace_report_torch.py {path.name} exited {out.returncode}")
        reports[path.suffix] = out.stdout
    print("  tools/trace_report_torch.py serve.json:")
    print("\n".join(f"    {line}" for line in reports[".json"].splitlines()))
    kinds, sizes = report_counts(reports[".json"])
    served = sum(size * count for size, count in sizes.items())
    print(f"    kinds {sorted(kinds)}; batch sizes {sizes} ({served} requests); the jsonl "
          f"report {'equals' if reports['.jsonl'] == reports['.json'] else 'differs from'} it")
    check({"queue", "solve", "batch"} <= kinds, f"trace report kinds {sorted(kinds)}")
    check(served == TRACE_REQUESTS, f"trace report batches hold {served} requests")
    check(reports[".jsonl"] == reports[".json"], "the two exports give different reports")
    return {"kinds": sorted(kinds), "batch_sizes": sizes, "serve_seconds": secs}


def example_cases(torch, tri_case, proj_case):
    """The two dense kernels against their plain versions at the shapes the
    quickstart and solve_sparse --full give them, on Gaussian factors (as
    the kernel phase): the quickstart's wide W (8, 256, 512) at k = 1, and
    solve_sparse's tall W (4, 4563, 4563) at k = 1 (its dapc solve) and
    k = 8 (its batched solve)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    w, r = gaussian_factors(torch, gen, 8, 256, 512, torch.float32, tall=False)
    tri_case("trisolve.quickstart", 8, 256, 1, torch.float32, True, True, r)
    proj_case("consensus_update.quickstart", w, 1, torch.float32, with_x=False)
    w, r = gaussian_factors(torch, gen, 4, 4563, 4563, torch.float32, tall=True)
    tri_case("trisolve.solve_sparse_full", 4, 4563, 1, torch.float32, False, False, r)
    tri_case("trisolve.solve_sparse_full.k8", 4, 4563, 8, torch.float32, False, False, r)
    proj_case("consensus_update.solve_sparse_full", w, 8, torch.float32, with_x=False)


def examples_phase(torch, tri_case, proj_case):
    """Phase 16: the examples and the trace report on the card."""
    import tempfile

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        print("  (a) examples/quickstart_torch.py:")
        out["quickstart"] = quickstart_run(tmp)
        print("  (b) examples/solve_sparse_torch.py, --full (the paper's 18252 x 4563) and n = 1141:")
        out["solve_sparse"] = solve_sparse_run(tmp)
        print("  (c) the kernels at those paths' shapes, against their plain versions:")
        example_cases(torch, tri_case, proj_case)
        print("  (d) examples/train_lm_torch.py:")
        out["train_lm"] = train_lm_run(torch, tmp)
        print("  (e) tools/trace_report_torch.py on a trace served on the card:")
        out["trace_report"] = trace_report_run(tmp)
    out["seconds"] = time.perf_counter() - t0
    print(f"  examples phase: {out['seconds']:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not at {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build
    from repro_torch.kernels.project import ops as project_ops
    from repro_torch.kernels.project.ref import consensus_update_ref, project_ref
    from repro_torch.kernels.residual import ops as residual_ops
    from repro_torch.kernels.residual.ref import residual_sq_ref
    from repro_torch.kernels.spmm import ops as spmm_ops
    from repro_torch.kernels.spmm.ref import spmm_fused_packed_plain, spmm_packed_plain, spmm_plain
    from repro_torch.kernels.trisolve import ops as trisolve_ops
    from repro_torch.kernels.trisolve.ref import trisolve_ref
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core import prepare
    from repro_torch.launch import linear_probe, serve
    from repro_torch.launch import solve as launch_solve
    from repro_torch.models import blocks, costs, moe, transformer
    from repro_torch.serving import decode
    from repro_torch.sparse import make_problem

    ops = SimpleNamespace(trisolve=trisolve_ops, project=project_ops, spmm=spmm_ops,
                          residual=residual_ops)
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch.cuda.get_device_name(): {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    per_source = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall, per source {per_source}")
    for name, log in _build.BUILD_LOG.items():
        print(f"--- nvcc {name}.cu -Xptxas -v ---\n{log.strip()}")

    print("kernel phase (kernel vs plain version on the card):")
    cases = kernel_phase(torch, trisolve_ops, trisolve_ref, project_ops, project_ref,
                         consensus_update_ref)
    print("residual kernel phase (kernel vs a float64 residual on the card):")
    cases.update(residual_phase(torch, residual_ops, residual_sq_ref))

    print("main path (repro_torch.launch.solve --kernels --implicit-p --device cuda):")
    runs = {J: main_path_run(torch, launch_solve, ops, 2327, 9308, J, 32, gate=True)
            for J in (2, 8)}
    print("scale run (timed, not gated):")
    scale = main_path_run(torch, launch_solve, ops, 4096, 16384, 8, 64, gate=False)

    print("matrix-free path (repro_torch.launch.solve --mode matfree --kernels --device cuda):")
    mf_small = matfree_run(torch, launch_solve, ops, 2327, "matfree", 300)
    resid = mf_small["record"]["final_residual_sq_max"]
    ref = JAX_CPU_MATFREE_RESIDUAL
    print(f"    residual {resid:.6e} vs JAX CPU {ref:.6e} (ratio {resid / ref:.4f}, "
          f"allowed 1/{RESIDUAL_FACTOR:g}..{RESIDUAL_FACTOR:g})")
    check(ref / RESIDUAL_FACTOR <= resid <= ref * RESIDUAL_FACTOR,
          f"matfree n=2327: residual {resid} not within {RESIDUAL_FACTOR}x of {ref}")
    check(mf_small["prep"].gram_solver == "direct", "matfree n=2327: expected the direct Gram solver")
    print("matrix-free path at n=16384 (--mode auto must resolve matfree with PCG):")
    mf_big = matfree_run(torch, launch_solve, ops, 16384, "auto", 100)
    check(mf_big["prep"].gram_solver == "pcg", "matfree n=16384: expected the PCG Gram solver")
    # 15 Gram products per epoch (the PCG depth) over 100 epochs, all packed
    check(mf_big["launches"]["spmm"] >= 1500,
          f"matfree n=16384: {mf_big['launches']['spmm']} packed SpMM launches, expected >= 1500")

    print("SpMM kernel phase (kernel vs plain version on the card, operators of the runs above):")
    cases.update(spmm_phase(torch, spmm_ops, spmm_plain, spmm_packed_plain,
                            spmm_fused_packed_plain, mf_small["prep"].op, mf_big["prep"].op))

    print("baselines at the Table 1 width (repro_torch.launch.solve --method dgd|cgnr --device cuda):")
    t0 = time.perf_counter()
    for method in ("dgd", "cgnr"):
        baseline_run(torch, launch_solve, ops, method)
    print(f"  baseline phase: {time.perf_counter() - t0:.1f} s")
    print(f"sessions: {STREAM_UPDATES} updates of {STREAM_COLS} drifting streams through the "
          f"kernels-on solvers, cap {STREAM_CAP} epochs:")
    t0 = time.perf_counter()
    sessions = {path: session_phase(torch, ops, path, make_problem, prepare)
                for path in ("dense", "matfree")}
    print(f"  session phases: {time.perf_counter() - t0:.1f} s")
    print("watchdog and per-block diagnostics on the card:")
    t0 = time.perf_counter()
    watchdog_phase(sessions)
    print(f"  watchdog phase: {time.perf_counter() - t0:.1f} s")
    print(f"serving (repro_torch.serving.SolveServer, kernels on, max_batch {SERVE_BATCH}, "
          f"{SERVE_WAIT_MS:g} ms window, cap {STREAM_CAP}) on {card}:")
    served = serving_phases(torch, ops, make_problem, sessions, card)
    print(f"multi-device (torch.distributed; {MESH_RANKS} ranks share the one card through "
          f"gloo) on {card}:")
    mesh = mesh_phase(torch, ops, prepare, mf_small, mf_big, card)
    print("SpMM kernels on the shards of the multi-device runs (kernel vs plain version):")
    cases.update(spmm_phase(torch, spmm_ops, spmm_plain, spmm_packed_plain,
                            spmm_fused_packed_plain, None, None, only=mesh["shards"]))
    print(f"model serving (repro_torch.models, serving.decode, launch.serve) on {card}:")
    t0 = time.perf_counter()
    mods = SimpleNamespace(get_config=get_config, reduced_config=reduced_config,
                           transformer=transformer, blocks=blocks, moe=moe, costs=costs,
                           decode=decode, serve=serve, linear_probe=linear_probe)
    model_reduced = model_parity_reduced(torch, mods)
    model = model_serving_phase(torch, mods, card)
    print("the linear probe (repro_torch.launch.linear_probe):")
    tri_case, proj_case = kernel_cases(torch, trisolve_ops, trisolve_ref, project_ops, project_ref,
                                       consensus_update_ref,
                                       torch.Generator(device="cuda").manual_seed(1), cases)
    probe = probe_phase(torch, ops, mods, prepare, tri_case, proj_case)
    print(f"  model phase: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"model": {"card": card, "reduced": model_reduced, "full_width": model,
                                "probe": probe}}))
    print(f"the other six families at full width (repro_torch.models, serving.decode, "
          f"launch.serve) on {card}:")
    t0 = time.perf_counter()
    families = family_phase(torch, mods, card)
    print(f"  families phase: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"families": {"card": card, **families}}))
    print(f"training (repro_torch.training, models.losses, launch.train) on {card}:")
    train = train_phase(torch, train_mods(mods), card)
    print(json.dumps({"train": {"card": card, **train}}, default=float))
    print(f"the mesh rules and the dry run (repro_torch.distributed.sharding, launch.dryrun, "
          f"launch.multihost, checkpoint.restore(shardings=)) on {card}:")
    dry = dryrun_phase(torch, card)
    print(json.dumps({"dryrun": {"card": card, **{k: v for k, v in dry.items() if k != "sweep"},
                                 "sweep": {k: v for k, v in dry["sweep"].items()
                                           if k != "argument_bytes"}}}))
    print(f"the examples and the trace report (examples/*_torch.py, "
          f"tools/trace_report_torch.py) on {card}:")
    examples = examples_phase(torch, tri_case, proj_case)
    print(json.dumps({"examples": {"card": card, **examples}}, default=float))

    def entry(name, source, replaces, launches, case, extra=(), **notes):
        out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches, **cases[case], **notes}
        if extra:
            out["cases"] = [{"name": e, **cases[e]} for e in extra]
        return out

    on_session = {"path": f"one warm update of the session phase (update {STREAM_UPDATES // 2})"}

    def on_served(path):
        run = served[path]
        return {"path": "a served batch of the Poisson phase", "launches_per": "served batch",
                "batches": run["batches"], "launches_in_replay": run["launches"]}

    def per_batch(path, kernel):
        value = served[path]["per_batch"][kernel]
        return int(value) if float(value).is_integer() else value

    kernels = [
        entry("trisolve.upper", TRISOLVE_SRC, TRISOLVE_TPU,
              runs[2]["launches"]["trisolve"], "trisolve.upper"),
        entry("trisolve.lower_t", TRISOLVE_SRC, TRISOLVE_TPU,
              runs[8]["launches"]["trisolve"], "trisolve.lower_t", ["trisolve.lower_t.f64"]),
        entry("consensus_update.tall", PROJECT_SRC, PROJECT_TPU,
              runs[2]["launches"]["consensus_update"], "consensus_update.tall"),
        entry("consensus_update.wide", PROJECT_SRC, PROJECT_TPU,
              runs[8]["launches"]["consensus_update"], "consensus_update.wide",
              ["consensus_update.wide.x_gamma", "consensus_update.wide.bf16"]),
        entry("consensus_update.scale", PROJECT_SRC, PROJECT_TPU,
              scale["launches"]["consensus_update"], "consensus_update.scale"),
        entry("residual.table1_tall", RESIDUAL_SRC, RESIDUAL_TPU,
              runs[2]["launches"]["residual"], "residual.table1_tall"),
        entry("residual.table1_wide", RESIDUAL_SRC, RESIDUAL_TPU,
              runs[8]["launches"]["residual"], "residual.table1_wide",
              ["residual.s5", "residual.t1", "residual.t1.f64", "residual.s5.k1"]),
        entry("residual.scale", RESIDUAL_SRC, RESIDUAL_TPU, scale["launches"]["residual"],
              "residual.scale"),
        entry("spmm.matfree_2327", SPMM_SRC, SPMM_TPU, mf_small["launches"]["spmm"],
              "spmm.fwd.n2327", ["spmm.fwd.n2327.k1", "spmm.tile16x8"]),
        entry("spmm.matfree_16384", SPMM_SRC, SPMM_TPU, mf_big["launches"]["spmm"],
              "spmm.gram.n16384", ["spmm.fwd.n16384", "spmm.tra.n16384"]),
        entry("spmm_fused_packed.matfree_2327", SPMM_SRC, SPMM_FUSED_TPU,
              mf_small["launches"]["spmm_fused_packed"], "spmm_fused_packed.n2327"),
        entry("spmm_fused_packed.matfree_16384", SPMM_SRC, SPMM_FUSED_TPU,
              mf_big["launches"]["spmm_fused_packed"], "spmm_fused_packed.n16384"),
        # one warm session update; the operands have the shapes of the rows
        # whose measured case each row carries
        entry("trisolve.session_dense", TRISOLVE_SRC, TRISOLVE_TPU,
              sessions["dense"]["launches"]["trisolve"], "trisolve.lower_t", **on_session),
        entry("consensus_update.session_dense", PROJECT_SRC, PROJECT_TPU,
              sessions["dense"]["launches"]["consensus_update"], "consensus_update.wide",
              **on_session),
        entry("residual.session_dense", RESIDUAL_SRC, RESIDUAL_TPU,
              sessions["dense"]["launches"]["residual"], "residual.table1_wide", **on_session),
        entry("spmm.session_matfree", SPMM_SRC, SPMM_TPU, sessions["matfree"]["launches"]["spmm"],
              "spmm.fwd.n2327", **on_session),
        entry("spmm_fused_packed.session_matfree", SPMM_SRC, SPMM_FUSED_TPU,
              sessions["matfree"]["launches"]["spmm_fused_packed"], "spmm_fused_packed.n2327",
              **on_session),
        # one served batch of the Poisson phases (launches per batch: the
        # replay's counts over its batches); same operand shapes as the cases
        entry("trisolve.served_dense", TRISOLVE_SRC, TRISOLVE_TPU,
              per_batch("dense", "trisolve"), "trisolve.lower_t", **on_served("dense")),
        entry("consensus_update.served_dense", PROJECT_SRC, PROJECT_TPU,
              per_batch("dense", "consensus_update"), "consensus_update.wide",
              **on_served("dense")),
        entry("residual.served_dense", RESIDUAL_SRC, RESIDUAL_TPU,
              per_batch("dense", "residual"), "residual.table1_wide", **on_served("dense")),
        entry("spmm.served_matfree", SPMM_SRC, SPMM_TPU, per_batch("matfree", "spmm"),
              "spmm.fwd.n2327", **on_served("matfree")),
        entry("spmm_fused_packed.served_matfree", SPMM_SRC, SPMM_FUSED_TPU,
              per_batch("matfree", "spmm_fused_packed"), "spmm_fused_packed.n2327",
              **on_served("matfree")),
    ]
    on_mesh = {"path": "the multi-device phase", "backend": "gloo, 4 ranks on one card",
               "launches_per": "rank (rank 0's count; every rank's is checked)"}
    r2327, r16384 = mesh["d4"]["n2327"]["ranks"][0], mesh["d4"]["n16384"]["ranks"][0]
    served_mesh = mesh["served"]
    per_served = {k: v / served_mesh["batches"] for k, v in served_mesh["launches_rank0"].items()}
    per_served = {k: int(v) if float(v).is_integer() else v for k, v in per_served.items()}
    kernels += [
        entry("spmm_fused_packed.mesh_nccl1", SPMM_SRC, SPMM_FUSED_TPU,
              mesh["d1"]["launches"]["spmm_fused_packed"], "spmm_fused_packed.mesh_d1",
              path="one nccl rank, the reference's sharded configuration"),
        entry("spmm.mesh_nccl1", SPMM_SRC, SPMM_TPU, mesh["d1"]["launches"]["spmm"],
              "spmm.fwd.mesh_d1", path="one nccl rank, the reference's sharded configuration"),
        entry("spmm_fused_packed.mesh4_2327", SPMM_SRC, SPMM_FUSED_TPU,
              r2327["launches"]["spmm_fused_packed"], "spmm_fused_packed.shard4_n2327", **on_mesh),
        entry("spmm.mesh4_2327", SPMM_SRC, SPMM_TPU, r2327["launches"]["spmm"],
              "spmm.fwd.shard4_n2327", **on_mesh),
        entry("spmm_fused_packed.mesh4_16384", SPMM_SRC, SPMM_FUSED_TPU,
              r16384["launches"]["spmm_fused_packed"], "spmm_fused_packed.shard4_n16384",
              **on_mesh),
        entry("spmm.mesh4_16384", SPMM_SRC, SPMM_TPU, r16384["launches"]["spmm"],
              "spmm.gram.shard4_n16384", **on_mesh),
        entry("spmm_fused_packed.served_mesh4", SPMM_SRC, SPMM_FUSED_TPU,
              per_served["spmm_fused_packed"], "spmm_fused_packed.shard4_n2327",
              path="a served batch of the mesh replay", launches_per="served batch (rank 0)",
              batches=served_mesh["batches"]),
        entry("spmm.served_mesh4", SPMM_SRC, SPMM_TPU, per_served["spmm"],
              "spmm.fwd.shard4_n2327", path="a served batch of the mesh replay",
              launches_per="served batch (rank 0)", batches=served_mesh["batches"]),
    ]
    on_probe = {"path": "the full-width linear probe's solve (launch.linear_probe --kernels: "
                        "granite-3-2b features (8192, 2048), J = 8, 150 epochs)"}
    kernels += [
        entry("trisolve.probe", TRISOLVE_SRC, TRISOLVE_TPU, probe["full"]["launches"]["trisolve"],
              "trisolve.probe", **on_probe),
        entry("consensus_update.probe", PROJECT_SRC, PROJECT_TPU,
              probe["full"]["launches"]["consensus_update"], "consensus_update.probe",
              **on_probe),
    ]
    on_example = {"quickstart": "examples/quickstart_torch.py --kernels (n = 512, m = 2048, "
                                "J = 8 wide, 100 epochs)",
                  "solve_sparse": "examples/solve_sparse_torch.py --full --kernels (the paper's "
                                  "18252 x 4563, J = 4 tall: the dapc solve and the batched "
                                  "k = 8 solve)"}
    for label, key, run in (("quickstart", "quickstart", "kernels"),
                            ("solve_sparse_full", "solve_sparse", "full")):
        launches = examples[key][run]["launches"]
        extra = ["trisolve.solve_sparse_full.k8"] if key == "solve_sparse" else []
        kernels += [
            entry(f"trisolve.{label}", TRISOLVE_SRC, TRISOLVE_TPU, launches["trisolve"],
                  f"trisolve.{label}", extra, path=on_example[key]),
            entry(f"consensus_update.{label}", PROJECT_SRC, PROJECT_TPU,
                  launches["consensus_update"], f"consensus_update.{label}",
                  path=on_example[key]),
        ]
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--restart-check"]:
        sys.exit(restart_check(sys.argv[2]))
    sys.exit(main())
