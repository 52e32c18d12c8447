"""Serving a mesh-backed system from a multi-controller program.

In the JAX package one process drives every device of a mesh, so a
``SolveServer`` whose pool registers ``mesh=`` simply solves on it. Under
``torch.distributed`` every rank is its own process, and a sharded prepare or
solve is a collective: every rank must make the same call, in the same
order. So rank 0 runs the ``SolveServer``, and ranks > 0 run
``serve_follower(pool)``:

  * before each mesh-backed prepare or solve, rank 0's pool broadcasts a small
    command — the op, the fingerprint, the prepare kwargs (without the
    placement) or B and the solve kwargs — and the followers make the same
    call on their own shards;
  * rank 0 broadcasts a command only after the rank-local work that can raise
    (an injected fault, a failed pool lookup), right before the call it
    announces. Every check inside the call runs on every rank with the same
    inputs, so a failing solve fails on every rank before its first
    collective, and no follower is left waiting in one;
  * ``stop_followers(mesh)`` ends the followers' loops.

A single-rank mesh has no followers and announces nothing.
"""
from __future__ import annotations

import traceback

import torch.distributed as dist

PLACEMENT_KWARGS = ("mesh", "block_axes", "device")


def _spans_ranks(prepare_kwargs: dict) -> bool:
    """Whether a registration's mesh spans more than this process."""
    mesh = prepare_kwargs.get("mesh")
    return mesh is not None and mesh.mesh.numel() > 1


def _broadcast(command: dict | None) -> dict:
    box = [command]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def announce(prepare_kwargs: dict, op: str, fingerprint: str, **payload) -> None:
    """Rank 0: tell the followers to make the same ``op`` call (``prepare``
    or ``solve``) for ``fingerprint``; nothing for a single-rank mesh."""
    if not _spans_ranks(prepare_kwargs):
        return
    if dist.get_rank() != 0:
        raise RuntimeError("only rank 0 of a served mesh announces its calls")
    _broadcast({"op": op, "fingerprint": fingerprint, **payload})


def public_kwargs(prepare_kwargs: dict) -> dict:
    """The prepare kwargs a command carries: all but the placement, which
    each rank has its own of."""
    return {k: v for k, v in prepare_kwargs.items() if k not in PLACEMENT_KWARGS}


def stop_followers(mesh) -> None:
    """Rank 0: end every follower's ``serve_follower`` loop."""
    if mesh is not None and mesh.mesh.numel() > 1:
        _broadcast({"op": "stop"})


def serve_follower(pool) -> int:
    """Ranks > 0 of a served mesh: receive rank 0's commands and make the same
    prepare and solve calls on this rank's shards until a stop command.

    ``pool`` holds this rank's registrations (the same systems rank 0
    registered, with this rank's mesh): a ``prepare`` command prepares the
    registered matrix with rank 0's kwargs and this rank's placement, a
    ``solve`` command solves on the latest prepare of that fingerprint. A
    call that raises here raised on rank 0 too (same inputs, same checks);
    it is printed and the loop goes on. Returns the number of commands
    served.
    """
    from repro_torch.core import prepare

    preps: dict = {}
    served = 0
    while True:
        cmd = _broadcast(None)
        if cmd["op"] == "stop":
            return served
        served += 1
        fp = cmd["fingerprint"]
        try:
            if cmd["op"] == "prepare":
                A, kwargs = pool.system(fp)
                placement = {k: kwargs[k] for k in PLACEMENT_KWARGS if k in kwargs}
                preps[fp] = prepare(A, **{**cmd["kwargs"], **placement})
            else:
                preps[fp].solve(cmd["b"], **cmd["kwargs"])
        except Exception:  # the loop must keep serving rank 0's next call
            traceback.print_exc()
