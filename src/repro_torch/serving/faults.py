"""Deterministic fault injection + the structured failure surface.

Robustness claims that are not exercised are fiction, so this module makes
failure a first-class, *reproducible* input to the serving stack: a
``FaultPlan`` is a committed, JSON-serializable list of ``FaultRule``s, and
a ``FaultInjector`` evaluates it at well-defined sites inside
``SolveServer`` / ``PreparedPool`` / ``CheckpointStore``:

  * ``prepare``          — make the factorization raise;
  * ``solve``            — throw mid-batch, return NaN/Inf columns for a
    targeted request, or freeze a request's residual progress (stall);
  * ``checkpoint.load``  — corrupt or truncate the ``.npz`` on disk before
    the store reads it (exercises quarantine + restore-only fallback);
  * ``checkpoint.save``  — fail the write (exercises best-effort saves);
  * any site             — add artificial latency through the injectable
    ``repro_torch.obs.clock`` (a ``ManualClock`` advances, a real clock
    sleeps).

The injector is a zero-cost-when-None hook, same pattern as ``tracer=None``:
components hold ``faults=None`` by default and the hot path never touches
it. Determinism: rules fire on exact match counts (``after``/``times``) or
from a per-rule ``numpy`` Generator seeded by ``(plan.seed, rule_index)`` —
the same plan over the same request sequence injects the same faults,
which is what lets the JAX package's ``benchmarks/chaos.py`` gate recovery
behavior in CI, and lets one seeded plan poison the same request sequence
numbers in both packages.

The module is the JAX package's ``repro.serving.faults``, copied:
``corrupt_result`` doctors the port's host-side ``SolveResult``, whose
``x`` and ``history`` are numpy.

``SolveFailure`` also lives here: the structured terminal error the
serving recovery ladder (retry → fallback → fresh-prepare) sets on a
request's future once every containment stage is exhausted — callers get
``fingerprint`` / ``reason`` / ``attempts`` / ``request`` fields instead
of a stringly traceback.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

import numpy as np


class InjectedFault(RuntimeError):
    """The synthetic failure a matched ``FaultRule`` raises."""

    def __init__(self, site: str, kind: str, detail: str = ""):
        self.site = site
        self.kind = kind
        super().__init__(f"injected fault [{site}/{kind}] {detail}".strip())


class InjectedIOError(OSError):
    """Synthetic IO failure (checkpoint.save site — the store treats it
    like any other ``OSError``: best-effort save, no checkpoint)."""


class SolveFailure(RuntimeError):
    """Structured terminal failure for ONE request's future.

    Set by the serving recovery ladder only after containment is exhausted
    (or refused: expired timeout, open circuit breaker) — never scattered
    batch-wide, so innocent batchmates keep their results.
    """

    def __init__(
        self,
        fingerprint: str,
        reason: str,
        attempts: int = 0,
        request: int | None = None,
        cause: BaseException | None = None,
    ):
        self.fingerprint = fingerprint
        self.reason = reason  # "error" | "nan" | "stalled" | "timeout" | ...
        self.attempts = attempts
        self.request = request
        self.cause = cause
        msg = (
            f"solve failed [{reason}] system={fingerprint} "
            f"request={request} attempts={attempts}"
        )
        if cause is not None:
            msg += f": {cause!r}"
        super().__init__(msg)


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One deterministic injection: WHERE (site + filters) and WHAT (kind).

    Filters are conjunctive and ``None`` means "any": ``request`` targets
    one submit-order sequence number (solve site), ``fingerprint`` one
    system, ``path`` one solver path (``"dense"``/``"matfree"``/... —
    lets a rule stop firing once the recovery ladder swapped the path).
    ``after`` skips the first N matching calls, ``times`` caps total
    fires (``None`` = every match: a *poison* rule), ``prob`` fires each
    match with seeded probability instead of always.
    """

    site: str  # "prepare" | "solve" | "checkpoint.load" | "checkpoint.save"
    kind: str  # "error" | "nan" | "stall" | "corrupt" | "truncate" | "delay"
    request: int | None = None
    fingerprint: str | None = None
    path: str | None = None
    times: int | None = None
    after: int = 0
    prob: float | None = None
    delay_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A committed, replayable set of fault rules."""

    rules: tuple[FaultRule, ...] = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(
            self,
            "rules",
            tuple(
                r if isinstance(r, FaultRule) else FaultRule(**r)
                for r in self.rules
            ),
        )

    @property
    def poisoned_requests(self) -> frozenset[int]:
        """Request seqs a PERSISTENT solve rule dooms (``times=None`` and
        no ``prob``/``path`` escape hatch) — the set a replay expects
        ``SolveFailure`` on, and nothing else."""
        return frozenset(
            r.request
            for r in self.rules
            if r.site == "solve"
            and r.request is not None
            and r.times is None
            and r.prob is None
            and r.path is None
            and r.kind in ("error", "nan", "stall")
        )

    def to_json(self) -> str:
        return json.dumps(
            {
                "seed": self.seed,
                "rules": [dataclasses.asdict(r) for r in self.rules],
            },
            indent=2,
        )

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        data = json.loads(text)
        return cls(
            rules=tuple(FaultRule(**r) for r in data.get("rules", ())),
            seed=int(data.get("seed", 0)),
        )

    @classmethod
    def load(cls, path: str | os.PathLike) -> "FaultPlan":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_json(f.read())


class _RuleState:
    __slots__ = ("rule", "matches", "fires", "rng")

    def __init__(self, rule: FaultRule, seed: int, index: int):
        self.rule = rule
        self.matches = 0
        self.fires = 0
        self.rng = (
            np.random.default_rng((seed, index))
            if rule.prob is not None
            else None
        )


class FaultInjector:
    """Evaluates a ``FaultPlan`` at the serving fault sites.

    Thread-safe (sites run on both the event loop and the solver thread).
    ``clock`` is the latency-injection channel: a ``ManualClock`` advances
    deterministically, anything else sleeps for real.
    """

    def __init__(self, plan: FaultPlan | None = None, clock=None):
        self.plan = plan or FaultPlan()
        self.clock = clock
        self._lock = threading.Lock()
        self._states = [
            _RuleState(r, self.plan.seed, i)
            for i, r in enumerate(self.plan.rules)
        ]

    # -- bookkeeping --------------------------------------------------------

    @property
    def fired_total(self) -> int:
        with self._lock:
            return sum(s.fires for s in self._states)

    def stats(self) -> list[dict]:
        with self._lock:
            return [
                {
                    "site": s.rule.site,
                    "kind": s.rule.kind,
                    "matches": s.matches,
                    "fires": s.fires,
                }
                for s in self._states
            ]

    def _fires(
        self,
        site: str,
        fingerprint: str | None = None,
        request: int | None = None,
        requests: tuple[int, ...] | None = None,
        path: str | None = None,
    ) -> list[tuple[FaultRule, int | None]]:
        """The rules firing for this call, as ``(rule, hit_request)``."""
        out = []
        with self._lock:
            for s in self._states:
                r = s.rule
                if r.site != site:
                    continue
                if r.fingerprint is not None and r.fingerprint != fingerprint:
                    continue
                if r.path is not None and r.path != path:
                    continue
                hit = request
                if r.request is not None:
                    if requests is not None:
                        if r.request not in requests:
                            continue
                        hit = r.request
                    elif request != r.request:
                        continue
                s.matches += 1
                if s.matches <= r.after:
                    continue
                if r.times is not None and s.fires >= r.times:
                    continue
                if s.rng is not None and s.rng.random() >= r.prob:
                    continue
                s.fires += 1
                out.append((r, hit))
        return out

    def _delay(self, seconds: float) -> None:
        if seconds <= 0:
            return
        clock = self.clock
        if clock is not None and hasattr(clock, "advance"):
            clock.advance(seconds)  # deterministic tests: no real sleep
        else:
            time.sleep(seconds)

    # -- sites --------------------------------------------------------------

    def on_prepare(self, fingerprint: str) -> None:
        """``PreparedPool`` calls this right before ``prepare(A)``."""
        for rule, _ in self._fires("prepare", fingerprint=fingerprint):
            self._delay(rule.delay_s)
            if rule.kind == "error":
                raise InjectedFault(
                    "prepare", "error", f"system={fingerprint}"
                )

    def on_solve(
        self,
        fingerprint: str,
        requests: tuple[int, ...],
        path: str | None = None,
    ) -> dict[int, str]:
        """``SolveServer`` calls this on the solver thread, before the
        batched solve. Raises for ``kind="error"`` (the whole dispatch
        fails — containment must bisect); returns ``{request: kind}``
        post-corruption actions for ``"nan"``/``"stall"`` rules."""
        actions: dict[int, str] = {}
        for rule, hit in self._fires(
            "solve", fingerprint=fingerprint, requests=tuple(requests),
            path=path,
        ):
            self._delay(rule.delay_s)
            if rule.kind == "error":
                raise InjectedFault(
                    "solve", "error",
                    f"system={fingerprint} request={hit}",
                )
            if rule.kind in ("nan", "stall") and hit is not None:
                actions[hit] = rule.kind
        return actions

    def corrupt_result(self, result, actions: dict[int, str], columns: dict):
        """Apply post-solve ``on_solve`` actions: NaN out or flatline the
        targeted request's column of a ``SolveResult`` (``columns`` maps
        request seq → batch column index). Returns a doctored copy; the
        original result is never mutated."""
        if not actions:
            return result
        x = np.array(
            np.asarray(result.x) if np.asarray(result.x).ndim == 2
            else np.asarray(result.x)[:, None]
        )
        history = dict(result.history)
        trace = np.array(np.asarray(history["residual_sq"]))
        if trace.ndim == 1:
            trace = trace[:, None]
        for seq, kind in actions.items():
            col = columns.get(seq)
            if col is None:
                continue
            if kind == "nan":
                x[:, col] = np.nan
                trace[-1, col] = np.nan
            elif kind == "stall":
                # frozen progress: the residual never moves off epoch 0
                # (and stays far from any plausible tolerance)
                trace[:, col] = max(float(trace[0, col]), 1.0)
        history["residual_sq"] = trace
        return dataclasses.replace(result, x=x, history=history)

    def on_checkpoint_load(self, fingerprint: str, target) -> None:
        """``CheckpointStore.load`` calls this before reading ``target`` —
        corrupt/truncate rules damage the file in place (the store's
        robustness + quarantine then handle the damage for real)."""
        for rule, _ in self._fires(
            "checkpoint.load", fingerprint=fingerprint
        ):
            self._delay(rule.delay_s)
            if rule.kind == "error":
                raise InjectedIOError(
                    f"injected checkpoint.load failure system={fingerprint}"
                )
            try:
                if rule.kind == "corrupt" and os.path.exists(target):
                    size = os.path.getsize(target)
                    with open(target, "r+b") as f:  # stomp the zip header
                        f.write(b"\xde\xad\xbe\xef" * 8)
                        f.truncate(min(size, 4096))
                elif rule.kind == "truncate" and os.path.exists(target):
                    size = os.path.getsize(target)
                    with open(target, "r+b") as f:
                        f.truncate(max(1, size // 2))
            except OSError:
                pass  # damaging the file is best-effort; a read-only
                # filesystem just means no fault today

    def on_checkpoint_save(self, fingerprint: str) -> None:
        """``CheckpointStore.save`` calls this before writing."""
        for rule, _ in self._fires(
            "checkpoint.save", fingerprint=fingerprint
        ):
            self._delay(rule.delay_s)
            if rule.kind == "error":
                raise InjectedIOError(
                    f"injected checkpoint.save failure system={fingerprint}"
                )
