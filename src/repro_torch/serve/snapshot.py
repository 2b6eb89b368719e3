"""Crash-safe serving: snapshot files and the append-only request journal
(DESIGN.md §5.6).

The port's copy of ``repro.serve.snapshot``, which imports no framework:
the formats are the reference's, so a snapshot or journal written by
either package restores in the other.

Crash recovery rests on one invariant the lifecycle layer already holds at
slot granularity (§5.5): every byte of device KV is a deterministic
function of host-side truth (prompt and emitted tokens, seeds and token
indices) through the recompute prefill, and the ``(seed, token index)``
sampler keys make the regenerated stream the same stream whatever the
schedule.  So a snapshot serializes only host-side truth; no device buffer
is written to disk, and restore rebuilds all device state through ordinary
re-admission.

Two artifacts cooperate:

* **Snapshot file**: one JSON document ``{"magic", "version", "checksum",
  "payload"}`` written atomically (tmp + fsync + rename).  The checksum is
  a SHA-256 over the canonical payload encoding, so a torn or bit-rotted
  snapshot is rejected with a typed ``SnapshotError`` before any state is
  touched.  The payload carries a config fingerprint (every knob but the
  chaos, strict and adaptive ones: a restore may legitimately run with
  crash injection off), the engine's geometry, every request record
  (terminal ones keep their streams; in-flight ones re-enter the queue),
  allocator refcounts and page tables (audited, then rebuilt live), the
  quarantine set, and the journal offset at snapshot time.
* **Request journal**: an append-only JSON-lines file of ``submit`` events
  (the full request) and ``terminal`` events (id, final status, emitted
  tokens), fsync'd at every chunk boundary.  After an unplanned kill,
  ``restore`` replays the journal past the snapshot's offset: re-submitted
  requests regenerate their streams deterministically, and journaled
  terminal events re-retire requests with the exact tokens they had
  emitted, so recovery lands on the last flushed chunk boundary.

The module is engine-agnostic (it does not import ``serve.engine``): it
reads and writes plain dicts, and the engine maps them to and from live
``Request`` objects.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Iterator

SNAPSHOT_MAGIC = "repro-serve-snapshot"
SNAPSHOT_VERSION = 1

# Knobs excluded from the config fingerprint: fault injection, the
# strict-invariant sweep, and the adaptive cache policy change no
# observable stream (that is their acceptance gate — adaptation is
# placement-only), and recovery typically runs with the crash knobs OFF
# that the crashed run had on.  Excluding the adaptive knobs also lets
# an adaptive engine restore a static engine's snapshot and vice versa.
_FINGERPRINT_EXCLUDE = (
    "chaos_alloc_fail_p", "chaos_preempt_p", "chaos_seed",
    "chaos_share_fail_p", "chaos_corrupt_p", "chaos_crash_after_wave",
    "strict_invariants", "kv_integrity",
    "adaptive", "warm_pages", "adaptive_replan_every",
)


class SnapshotError(RuntimeError):
    """A snapshot/journal that must not be restored, with a
    machine-readable ``reason``: "unreadable" (missing/torn/not JSON),
    "bad_magic", "version", "checksum" (payload bytes don't hash to the
    recorded digest), "config_mismatch", "geometry_mismatch",
    "inconsistent" (internal audit failed, e.g. refcounts vs. page
    tables), or "no_source" (restore with neither snapshot nor
    journal)."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


def cfg_fingerprint(cfg) -> dict[str, Any]:
    """JSON-safe view of every identity-relevant config knob."""
    import dataclasses
    d = dataclasses.asdict(cfg)
    return {k: v for k, v in d.items() if k not in _FINGERPRINT_EXCLUDE}


def _canonical(payload: dict) -> str:
    return json.dumps(payload, sort_keys=True, separators=(",", ":"))


def _digest(payload: dict) -> str:
    return hashlib.sha256(_canonical(payload).encode()).hexdigest()


def write_snapshot(path: str, payload: dict) -> None:
    """Atomically write a checksummed snapshot: tmp file + fsync +
    rename, so a crash DURING snapshotting leaves either the previous
    snapshot or none — never a torn one."""
    doc = {
        "magic": SNAPSHOT_MAGIC,
        "version": SNAPSHOT_VERSION,
        "checksum": _digest(payload),
        "payload": payload,
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_snapshot(path: str) -> dict:
    """Read + validate a snapshot, returning its payload.  Every failure
    mode raises a typed ``SnapshotError`` — a corrupt snapshot is
    rejected before the engine discards any live state."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise SnapshotError("unreadable", f"snapshot {path!r}: {e}") from e
    if not isinstance(doc, dict) or doc.get("magic") != SNAPSHOT_MAGIC:
        raise SnapshotError("bad_magic", f"{path!r} is not a serve snapshot")
    if doc.get("version") != SNAPSHOT_VERSION:
        raise SnapshotError("version", (
            f"snapshot version {doc.get('version')!r}, "
            f"engine speaks {SNAPSHOT_VERSION}"
        ))
    payload = doc.get("payload")
    if not isinstance(payload, dict) or _digest(payload) != doc.get("checksum"):
        raise SnapshotError("checksum", (
            f"snapshot {path!r} failed its integrity check "
            "(torn write or bit rot)"
        ))
    return payload


class RequestJournal:
    """Append-only JSON-lines request journal with explicit fsync.

    Events are buffered in memory and durably flushed at chunk
    boundaries (``ServeEngine.step`` calls ``flush``), so the on-disk
    journal always ends at a scheduling boundary — exactly the point
    recovery replays to.  An event that was buffered but never flushed
    when the process died is indistinguishable from the request
    finishing a moment later; determinism regenerates it.
    """

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")
        self._pending: list[str] = []

    def append(self, event: dict) -> None:
        self._pending.append(json.dumps(event, sort_keys=True))

    def flush(self) -> None:
        if not self._pending:
            return
        self._f.write("".join(line + "\n" for line in self._pending))
        self._pending.clear()
        self._f.flush()
        os.fsync(self._f.fileno())

    def offset(self) -> int:
        """Durable byte offset after flushing — recorded in snapshots so
        replay starts exactly past the events the snapshot subsumes."""
        self.flush()
        return self._f.tell()

    def close(self) -> None:
        self.flush()
        self._f.close()

    @staticmethod
    def replay(path: str, offset: int = 0) -> Iterator[dict]:
        """Yield events from ``offset`` on.  A trailing partial line
        (the write the crash interrupted) is skipped, not an error — the
        journal is only ever appended to, so everything before it is
        intact."""
        try:
            f = open(path)
        except OSError as e:
            raise SnapshotError(
                "unreadable", f"journal {path!r}: {e}"
            ) from e
        with f:
            f.seek(offset)
            for line in f:
                if not line.endswith("\n"):
                    break
                try:
                    ev = json.loads(line)
                except ValueError:
                    break
                if isinstance(ev, dict):
                    yield ev


def request_record(r, status: str | None = None) -> dict:
    """Serialize a live ``Request`` (duck-typed) to a JSON-safe record.
    ``slot``/``admit_seq`` are deliberately absent: residency is rebuilt
    by ordinary re-admission, never deserialized."""
    return {
        "id": r.id,
        "prompt": [int(t) for t in r.prompt],
        "max_new_tokens": int(r.max_new_tokens),
        "seed": None if r.seed is None else int(r.seed),
        "deadline_s": r.deadline_s,
        "max_queue_wait_s": r.max_queue_wait_s,
        "generated": [int(t) for t in r.generated],
        "status": status or r.status,
        "preempted_n": int(r.preempted_n),
        "cancel_requested": bool(r.cancel_requested),
        "ttft_s": r.ttft_s,
        "queue_wait_s": r.queue_wait_s,
    }


def submit_event(r) -> dict:
    return {
        "ev": "submit",
        "id": r.id,
        "prompt": [int(t) for t in r.prompt],
        "max_new_tokens": int(r.max_new_tokens),
        "seed": None if r.seed is None else int(r.seed),
        "deadline_s": r.deadline_s,
        "max_queue_wait_s": r.max_queue_wait_s,
    }


def terminal_event(r) -> dict:
    return {
        "ev": "terminal",
        "id": r.id,
        "status": r.status,
        "generated": [int(t) for t in r.generated],
    }
