"""Persistent factor checkpoints: warm-restore prepared solvers from disk.

``prepare`` is the expensive half of the prepare/solve split — per-block QR
(dense path) or the partitioned ELL build + Gram pseudo-inverses (matfree) —
and the serving pool throws that work away on every LRU eviction and process
restart. This store persists the prepared state keyed by
``matrix_fingerprint`` so a miss restores in file-IO time instead of
re-factorizing (the restore-only checkpointing idiom: serving never *needs*
a save to make progress, so every load failure of the file degrades to a
fresh ``prepare``).

The format is the JAX package's (``repro.serving.checkpoint``,
``FORMAT_VERSION`` 2), and so is the key: one directory serves both
packages. One ``<fingerprint>.npz`` per system: the solver's ``to_state()``
arrays plus one ``__meta__`` JSON string (stored as a 0-d unicode array —
loadable with ``allow_pickle=False``, so a corrupt or hostile file can at
worst fail to parse). Writes go through a UNIQUE per-writer temp file +
``os.replace`` so readers never observe a half-written checkpoint,
concurrent writers (multi-process serving) never tear each other's temp
file, and a crashed writer leaves the previous checkpoint intact.

Load validates before trusting: format version, solver path, and a
``prepare_key`` digest of the prepare kwargs that built the saved state — a
checkpoint written under different prepare settings (other method, block
count, dtype, ...) MUST miss, because the pool would otherwise serve factors
that disagree with its registration. ``device`` places the state and does
not change its values, so it stays out of the key (with ``mesh`` and
``block_axes``): a checkpoint written by either package on any device
restores onto ``prepare_kwargs["device"]`` (``None`` = the card) through the
port's ``from_state(arrays, meta, device=...)``. A placement that fails
(no card, out of device memory) raises to the caller: it says nothing about
the file, which is neither quarantined nor replaced by a CPU restore.

Corrupt/unparseable files are *quarantined* on the miss: the store renames
``<fp>.npz`` to ``<fp>.npz.bad`` (keeping the evidence for forensics)
instead of re-reading and re-failing the same bytes on every future pool
miss — without this, an LRU-thrashing pool pays a doomed ``np.load`` of a
truncated file per miss, forever. A *valid* checkpoint that merely
mismatches (older format version, different ``prepare_key``) is left in
place: it belongs to a different, legitimate configuration.

``faults=`` threads a ``repro_torch.serving.faults.FaultInjector``
(zero-cost when ``None``): injection can damage the file right before a
load or fail a save, which is how the chaos tests prove the quarantine +
best-effort paths for real.
"""
from __future__ import annotations

import json
import os
import pathlib
import tempfile

import numpy as np

from repro_torch.device import resolve_device

# v2: solver states may carry a PartitionPlan (plan_assignment /
# mixer_gather arrays, plan meta) and per-block dynamics state (spectral
# weights + spectra). v1 checkpoints miss cleanly on the version check and
# re-prepare — no migration path needed, the store is a cache.
FORMAT_VERSION = 2

# prepare kwargs that do not change the PREPARED STATE's values, only its
# placement/runtime — excluded from the compatibility digest
_PLACEMENT_KWARGS = ("mesh", "block_axes", "device")


def prepare_key(prepare_kwargs: dict) -> str:
    """Canonical digest of the prepare settings a checkpoint was built
    under; equality is the load-time compatibility test."""
    items = sorted(
        (k, repr(v)) for k, v in prepare_kwargs.items()
        if k not in _PLACEMENT_KWARGS
    )
    return repr(items)


def _solver_class(path: str):
    if path == "dense":
        from repro_torch.core.prepared import PreparedSolver

        return PreparedSolver
    if path == "matfree":
        from repro_torch.core.matfree import MatrixFreePreparedSolver

        return MatrixFreePreparedSolver
    return None


class CheckpointStore:
    """Directory of ``<fingerprint>.npz`` factor checkpoints.

    ``save`` is best-effort (returns False for unsupported solvers);
    ``load`` is restore-only robust (returns None on ANY mismatch or
    corruption of the file — the caller falls back to ``prepare``; corrupt
    files are quarantined to ``.npz.bad`` so they fail at most once).
    Counters (``saves``/``loads``/``load_misses``/``quarantined``) are
    observability only; the pool's ``PoolStats`` tracks the serving-level
    restore metrics.
    """

    def __init__(self, directory: str | os.PathLike, faults=None):
        self.directory = pathlib.Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.faults = faults  # FaultInjector | None (None = zero cost)
        self.saves = 0
        self.loads = 0
        self.load_misses = 0
        self.quarantined = 0

    def path(self, fingerprint: str) -> pathlib.Path:
        return self.directory / f"{fingerprint}.npz"

    def __contains__(self, fingerprint: str) -> bool:
        return self.path(fingerprint).exists()

    def save(self, fingerprint: str, prep, prepare_kwargs: dict) -> bool:
        """Persist a prepared solver; returns whether it was checkpointed.

        Skips solvers without serialization hooks and mesh-backed state;
        those systems simply keep re-preparing, they never error.
        """
        to_state = getattr(prep, "to_state", None)
        if to_state is None or prepare_kwargs.get("mesh") is not None:
            return False
        arrays, meta = to_state()
        meta = {
            "format": FORMAT_VERSION,
            "prepare_key": prepare_key(prepare_kwargs),
            **meta,
        }
        target = self.path(fingerprint)
        tmp = None
        try:
            if self.faults is not None:
                self.faults.on_checkpoint_save(fingerprint)
            # unique temp name per writer: concurrent saves of the same
            # fingerprint each build their own complete file, and whichever
            # replace lands last wins — never a torn byte range
            fd, tmp = tempfile.mkstemp(
                prefix=target.name + ".", suffix=".tmp", dir=self.directory
            )
            with os.fdopen(fd, "wb") as f:
                np.savez(f, __meta__=np.array(json.dumps(meta)), **arrays)
            os.replace(tmp, target)  # atomic: readers see old or new, whole
        except OSError:
            if tmp is not None:
                pathlib.Path(tmp).unlink(missing_ok=True)
            return False
        self.saves += 1
        return True

    def quarantine(self, fingerprint: str) -> pathlib.Path | None:
        """Move a damaged checkpoint aside as ``<fp>.npz.bad`` (evidence
        preserved, never re-read); returns the new path, or None if the
        rename failed (another process may have raced us to it)."""
        target = self.path(fingerprint)
        bad = target.with_name(target.name + ".bad")
        try:
            os.replace(target, bad)
        except OSError:
            return None
        self.quarantined += 1
        return bad

    def load(self, fingerprint: str, prepare_kwargs: dict):
        """Restore the prepared solver for ``fingerprint`` onto
        ``prepare_kwargs["device"]``, or None.

        None on: no checkpoint, placement kwargs demanding a mesh, format
        or ``prepare_key`` mismatch, or a corrupt/unreadable file — every
        path the pool can recover from by preparing fresh. Corruption
        additionally quarantines the file (see class docstring);
        mismatches do not, because the bytes are a valid checkpoint for a
        different configuration. Placing the state on the device may
        raise (``RuntimeError``): the file is not at fault, so that error
        reaches the caller unchanged.
        """
        if prepare_kwargs.get("mesh") is not None:
            return None
        device = resolve_device(prepare_kwargs.get("device"))
        target = self.path(fingerprint)
        try:
            if self.faults is not None:
                self.faults.on_checkpoint_load(fingerprint, target)
            # the store owns the file handle: np.load leaks its own when
            # the bytes are a torn zip
            with open(target, "rb") as fh, np.load(fh, allow_pickle=False) as z:
                meta = json.loads(str(z["__meta__"][()]))
                if meta.get("format") != FORMAT_VERSION:
                    self.load_misses += 1
                    return None
                if meta.get("prepare_key") != prepare_key(prepare_kwargs):
                    self.load_misses += 1
                    return None
                cls = _solver_class(meta.get("path"))
                if cls is None:
                    self.load_misses += 1
                    return None
                arrays = {k: z[k] for k in z.files if k != "__meta__"}
        except FileNotFoundError:
            return None
        except OSError:  # transient IO failure: miss, but the bytes may
            # be fine — do not quarantine on a read error
            self.load_misses += 1
            return None
        except Exception:  # corrupt/truncated/foreign file: restore-only,
            # and quarantined so the SAME bytes never fail a second miss
            self.load_misses += 1
            self.quarantine(fingerprint)
            return None
        try:
            prep = cls.from_state(arrays, meta, device=device)
        except RuntimeError:  # the device refused the state (see above)
            raise
        except Exception:  # a parseable file holding a malformed state
            self.load_misses += 1
            self.quarantine(fingerprint)
            return None
        self.loads += 1
        return prep
