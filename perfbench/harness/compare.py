"""What decides ``correct``: the timed path's answers against the plain
reference, at the timed sizes.

Every answer carries its right-hand side b, the solution x̄ it returned, the
number of epochs it ran before it froze (its ``iterations``; the cap when no
``tol`` is set) and the residuals it reported: the whole history of a
closed-loop solve, or the final residual of a served request. The reference
runs the same right-hand sides and is read at each answer's own epoch, so a
column that froze early is judged by the x̄ the reference holds at that
epoch. Three numbers are compared, each against its limit:

- ``x_gap``: the widest ‖x̄ − x̄_ref‖ / ‖x̄_ref‖ over the answers;
- ``resid_gap``: the widest |√r − √r_ref| / √r_ref over every residual an
  answer reported (x̄(0) and each epoch up to its freeze);
- ``stop_gap`` (with ``tol``): how far the reference's residual at the
  answer's freeze epoch lies above tol, or before it below tol, as a share
  of tol — a column that stopped too early or too late.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

@dataclasses.dataclass
class Answer:
    """One solve's (or one request's) columns as the program returned them."""

    b: np.ndarray  # (m, k) right-hand sides
    x: np.ndarray  # (n, k)
    iterations: np.ndarray  # (k,)
    history: np.ndarray | None  # (epochs + 1, k): x̄(0)'s residual, then each epoch
    final: np.ndarray | None = None  # (k,) reported final residual (served)


def _col_gap(x, ref):
    num = np.linalg.norm(x - ref, axis=0)
    den = np.maximum(np.linalg.norm(ref, axis=0), np.finfo(np.float64).tiny)
    return num / den


def _resid_gap(r, ref):
    a = np.sqrt(np.maximum(np.asarray(r, np.float64), 0.0))
    b = np.sqrt(np.maximum(np.asarray(ref, np.float64), 0.0))
    return np.abs(a - b) / np.maximum(b, np.finfo(np.float64).tiny)


def _stop_gap(ref_hist, it, epochs, tol):
    """ref_hist (E' + 1, k) covers epochs 0..E' ≥ max(it)."""
    cols = np.arange(it.size)
    r_at = np.sqrt(ref_hist[it, cols]) / tol
    r_before = np.sqrt(ref_hist[it - 1, cols]) / tol
    late_or_early = np.where(it < epochs, np.maximum(r_at - 1.0, 1.0 - r_before),
                             1.0 - r_at)
    return np.maximum(late_or_early, 0.0)


def judge(ref, answers, epochs: int, tol: float | None, chunk: int = 64) -> dict:
    """The compared numbers over ``answers`` (a list of ``Answer``), against
    ``ref`` (a ``DapcReference``). Columns that share their right-hand side
    array, column and freeze epoch (a closed loop cycles a pool of batches)
    run through the reference once, in batches of at most ``chunk``. A
    non-finite answer reads as inf."""
    keys: dict = {}
    for a in answers:
        for c in range(a.x.shape[1]):
            keys.setdefault((id(a.b), c, int(a.iterations[c])), (a.b, c))
    order = list(keys)
    ref_x, ref_h = {}, {}
    for lo in range(0, len(order), chunk):
        part = order[lo:lo + chunk]
        B = np.stack([keys[key][0][:, keys[key][1]] for key in part], axis=1)
        it = np.array([key[2] for key in part], np.int64)
        hist_t, xr_t = ref.run(B, epochs if tol is None else int(it.max()), capture=it)
        hist, xr = hist_t.cpu().numpy(), xr_t.cpu().numpy()
        del hist_t, xr_t
        for i, key in enumerate(part):
            ref_x[key], ref_h[key] = xr[:, i], hist[:, i]
    gaps = {"x_gap": 0.0, "resid_gap": 0.0}
    if tol is not None:
        gaps["stop_gap"] = 0.0
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        for a in answers:
            for c in range(a.x.shape[1]):
                key = (id(a.b), c, int(a.iterations[c]))
                e, h = key[2], ref_h[key]
                xg = _col_gap(a.x[:, c:c + 1].astype(np.float64), ref_x[key][:, None])[0]
                if a.history is not None:
                    rg = _resid_gap(a.history[:e + 1, c], h[:e + 1]).max()
                else:
                    rg = _resid_gap(a.final[c], h[e])
                gaps["x_gap"] = max(gaps["x_gap"], _finite_or_inf(xg))
                gaps["resid_gap"] = max(gaps["resid_gap"], _finite_or_inf(rg))
                if tol is not None:
                    sg = _stop_gap(h[:, None], np.array([e]), epochs, float(tol))[0]
                    gaps["stop_gap"] = max(gaps["stop_gap"], _finite_or_inf(sg))
    return gaps


def _finite_or_inf(v) -> float:
    v = float(v)
    return v if np.isfinite(v) else float("inf")


def control_answers(ref_lower, answers, epochs: int, tol: float | None, chunk: int = 64):
    """The control in the program's place: ``ref_lower`` (the reference in
    the next precision below the configuration's) solves the same
    right-hand sides, freezing each column as the program does, at the
    first epoch its own residual reaches tol; returns ``Answer``s."""
    out = []
    cols = [(a, c) for a in answers for c in range(a.x.shape[1])]
    for lo in range(0, len(cols), chunk):
        part = cols[lo:lo + chunk]
        B = np.stack([a.b[:, c] for a, c in part], axis=1)
        hist, _ = ref_lower.run(B, epochs)
        hist = hist.cpu().numpy()
        if tol is None:
            it = np.full(len(part), epochs, np.int64)
        else:
            trace = hist[1:] <= float(tol) ** 2
            it = np.where(trace.any(axis=0), trace.argmax(axis=0) + 1, epochs).astype(np.int64)
        _, x = ref_lower.run(B, epochs, capture=it)
        x = x.cpu().numpy()
        # frozen columns keep their residual from the freeze on
        frozen = hist.copy()
        for i in range(len(part)):
            frozen[it[i] + 1:, i] = hist[it[i], i]
        out.append(Answer(b=B, x=x, iterations=it, history=frozen,
                          final=frozen[-1]))
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(all within limit, {name: {"value", "limit"}}) for the numbers that
    have a limit; a number without one is an error of the cell's files."""
    shown = {}
    ok = True
    for name, value in numbers.items():
        if name not in limits:
            raise KeyError(f"no limit for the compared number {name!r}")
        limit = float(limits[name])
        shown[name] = {"value": value, "limit": limit}
        ok = ok and bool(np.isfinite(value)) and value <= limit
    return ok, shown


def free_device():
    """Let the allocator return what the program's state held."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
