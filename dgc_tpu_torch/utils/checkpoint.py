"""Checkpoint/resume of the minimal-k sweep (port of
``dgc_tpu.utils.checkpoint``, its on-disk format unchanged).

The sweep state — the next k to try, the best valid coloring so far,
whether the sweep already hit its terminating failure — is saved after
every attempt (every block, blocked) as ``sweep_state.json`` and
``best_colors.npy``, each by an atomic rename, so a resumed run continues
exactly where it stopped. The manifest holds a SHA-256 of the colors file
and a fingerprint of the (graph, engine, mode) triple; ``restore()`` treats
any defect (an unreadable manifest, a missing or partial colors file, a
checksum mismatch) as "no checkpoint" with a warning on stderr, and a
different fingerprint as another run's. A directory written by
``dgc_tpu`` restores here, and the other way round.

:class:`WriteBehindCheckpointManager` takes the write off the sweep clock:
``save()`` copies the attempt state into a one-deep pending slot and
returns; a writer thread lands the newest snapshot through the same atomic
save. ``restore``/``clear``/``close`` flush first.

Not ported: the JAX package's fault-injection hook at the end of ``save``
(``faults.fault_point``), which belongs to its resilience layer (ROADMAP
A12).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np

from dgc_tpu_torch.engine.base import AttemptResult, AttemptStatus

_MANIFEST = "sweep_state.json"
_COLORS = "best_colors.npy"


def _sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, fingerprint: str | None = None):
        """``fingerprint`` identifies the (graph, engine) pair; a stored
        checkpoint with a different fingerprint is ignored on restore, so a
        stale directory can never hand a previous graph's coloring to a new
        run. Use :func:`graph_fingerprint` to derive one."""
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.fingerprint = fingerprint

    def save(self, k: int, best: AttemptResult | None, failed: bool) -> None:
        state = {
            "fingerprint": self.fingerprint,
            "next_k": int(k),
            "done": bool(failed),
            "best": None
            if best is None
            else {
                "k": int(best.k),
                "status": int(best.status),
                "supersteps": int(best.supersteps),
            },
        }
        if best is not None:
            tmp = self.dir / ("tmp_" + _COLORS)  # np.save appends .npy to bare names
            np.save(tmp, best.colors)
            state["colors_sha256"] = _sha256_file(tmp)
            os.replace(tmp, self.dir / _COLORS)
        tmp = self.dir / (_MANIFEST + ".tmp")
        tmp.write_text(json.dumps(state))
        os.replace(tmp, self.dir / _MANIFEST)

    def _reject(self, why: str):
        print(f"# WARNING: ignoring checkpoint in {self.dir}: {why}",
              file=sys.stderr)
        return None

    def restore(self) -> tuple[int, AttemptResult | None, bool] | None:
        """Returns (next_k, best_attempt, done), or None if there is no
        usable checkpoint — a corrupt/partial one is warned about and
        treated as absent, never raised on."""
        manifest = self.dir / _MANIFEST
        if not manifest.exists():
            return None
        try:
            state = json.loads(manifest.read_text())
        except (OSError, ValueError) as e:
            return self._reject(f"unreadable manifest ({e})")
        if not isinstance(state, dict) or "next_k" not in state:
            return self._reject("manifest missing required fields")
        if state.get("fingerprint") != self.fingerprint:
            return None  # checkpoint belongs to a different graph/engine
        best = None
        if state.get("best") is not None:
            colors_path = self.dir / _COLORS
            if not colors_path.exists():
                return self._reject(f"manifest references missing {_COLORS}")
            expected = state.get("colors_sha256")
            if expected is not None and _sha256_file(colors_path) != expected:
                return self._reject(f"{_COLORS} checksum mismatch (partial write?)")
            try:
                colors = np.load(colors_path)
            except (OSError, ValueError) as e:
                return self._reject(f"undecodable {_COLORS} ({e})")
            b = state["best"]
            try:
                best = AttemptResult(
                    status=AttemptStatus(b["status"]),
                    colors=colors,
                    supersteps=b["supersteps"],
                    k=b["k"],
                )
            except (KeyError, TypeError, ValueError) as e:
                return self._reject(f"malformed best-attempt record ({e})")
        try:
            return int(state["next_k"]), best, bool(state["done"])
        except (KeyError, TypeError, ValueError) as e:
            return self._reject(f"malformed sweep state ({e})")

    def clear(self) -> None:
        for name in (_MANIFEST, _COLORS):
            p = self.dir / name
            if p.exists():
                p.unlink()


class WriteBehindCheckpointManager(CheckpointManager):
    """Write-behind (streamed) checkpointing off the sweep clock.

    ``save()`` snapshots the attempt state into a one-deep pending slot
    (newest wins — the double buffer: a burst of attempt boundaries
    coalesces to the last one, which is the only state a resume can use
    anyway) and returns without touching the filesystem; the writer
    thread lands it through :meth:`CheckpointManager.save` — the same
    atomic-rename + sha-256 path, so on-disk artifacts are
    indistinguishable from the synchronous manager's and every restore
    hardening applies verbatim.

    A crash between ``save()`` and the writer landing it costs at most
    one attempt (one block, blocked) of progress (resume re-runs it
    deterministically — exact, just not free); ``restore``/``clear``/
    ``close`` flush first, so a resume always reads the newest landed
    state. Writer errors are re-raised on the next ``flush`` — a
    checkpoint write can fail without crashing the sweep mid-attempt.

    Managers over the same directory (one draining while another
    restores) serialize on a process-wide per-directory lock, so two
    writers can never interleave one directory's rename pair."""

    _dir_locks: dict = {}                    # guarded-by: _dir_locks_lock
    _dir_locks_lock = threading.Lock()

    def __init__(self, directory: str | os.PathLike,
                 fingerprint: str | None = None):
        super().__init__(directory, fingerprint=fingerprint)
        key = str(Path(directory).resolve())
        with WriteBehindCheckpointManager._dir_locks_lock:
            self._dir_lock = WriteBehindCheckpointManager._dir_locks \
                .setdefault(key, threading.Lock())
        self._cond = threading.Condition()
        self._pending = None        # guarded-by: _cond (newest snapshot)
        self._writing = False       # guarded-by: _cond
        self._error = None          # guarded-by: _cond (writer's raise)
        self._closed = False        # guarded-by: _cond
        self._thread = None         # guarded-by: _cond

    # -- the async save -------------------------------------------------
    def save(self, k: int, best, failed: bool) -> None:
        # double-buffer: copy the colors vector NOW (the caller may
        # reuse its buffers the moment save returns), then hand
        # the snapshot to the writer — newest pending wins
        snap_best = best
        if best is not None:
            snap_best = type(best)(
                status=best.status,
                colors=np.array(best.colors, copy=True),
                supersteps=int(best.supersteps), k=int(best.k))
        with self._cond:
            if self._closed:
                raise RuntimeError("checkpoint manager is closed")
            self._pending = (int(k), snap_best, bool(failed))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._writer, daemon=True,
                    name="dgc-ckpt-writebehind")
                self._thread.start()
            self._cond.notify_all()

    def _writer(self) -> None:
        while True:
            with self._cond:
                while self._pending is None and not self._closed:
                    self._cond.wait()
                if self._pending is None and self._closed:
                    return
                snap, self._pending = self._pending, None
                self._writing = True
            try:
                with self._dir_lock:
                    CheckpointManager.save(self, *snap)
            except BaseException as e:   # surfaced on the next flush,
                with self._cond:         # never lost
                    self._error = e
                    self._writing = False
                    self._cond.notify_all()
                return
            with self._cond:
                self._writing = False
                self._cond.notify_all()

    def flush(self, timeout: float = 60.0) -> None:
        """Block until every pending snapshot has landed (or re-raise
        the writer's stored error)."""
        deadline = time.perf_counter() + timeout
        with self._cond:
            while ((self._pending is not None or self._writing)
                   and self._error is None):
                left = deadline - time.perf_counter()
                if left <= 0:
                    raise TimeoutError(
                        f"write-behind checkpoint flush exceeded "
                        f"{timeout:g}s")
                self._cond.wait(timeout=left)
            err, self._error = self._error, None
        if err is not None:
            raise err

    # -- flush-first overrides ------------------------------------------
    def restore(self):
        self.flush()
        with self._dir_lock:
            return super().restore()

    def clear(self) -> None:
        self.flush()
        with self._dir_lock:
            super().clear()

    def close(self) -> None:
        """Drain and stop the writer (idempotent)."""
        try:
            self.flush()
        finally:
            with self._cond:
                self._closed = True
                self._cond.notify_all()
                t = self._thread
            if t is not None:
                t.join(timeout=10)


def graph_fingerprint(arrays, backend: str, strict_decrement: bool) -> str:
    """Cheap structural fingerprint of (graph, engine config) for checkpoint
    safety: vertex/edge counts plus a hash of the CSR arrays."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(arrays.indptr).tobytes())
    h.update(np.ascontiguousarray(arrays.indices).tobytes())
    return (
        f"v{arrays.num_vertices}-e{arrays.num_directed_edges}-{backend}"
        f"-{'strict' if strict_decrement else 'jump'}-{h.hexdigest()[:16]}"
    )
