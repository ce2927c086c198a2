"""Poison-contract quarantine sidecar for the serve worker pool.

A contract whose analysis keeps killing worker processes (a bytecode
that tickles a segfault, an out-of-memory kill, a wedged kernel) must not
be allowed to crash-loop the pool — or, worse, to keep poisoning shared
fleet micro-batches. The supervisor records every worker death against
the victim request's bytecode hash; once a hash accumulates
``quarantine_after`` deaths (default 2 — i.e. the
first dispatch *and* its one retry both died) the contract is
quarantined: further ``analyze`` requests for it are refused with a
typed ``quarantined`` protocol error before any worker is risked.

The store is a sidecar beside the warmset manifest
(``warmset.json`` → ``warmset.quarantine.json``) and follows the same
persistence rules as the manifest and the taint-summary store
(serve/warmset.py): versioned JSON, monotone union-merge on save (a
fleet of daemons sharing one sidecar only ever accumulates evidence),
fsync-atomic writes via ``support/checkpoint.fsync_replace``, and
tolerant loads that degrade to an empty store — a corrupt sidecar can
refuse nobody, never crash the daemon.

Store format::

    {"version": 1,
     "contracts": {"<sha256 of runtime hex>": {
         "crashes": 2, "classes": ["worker_segv"], "quarantined": true}}}

Stdlib-only (json/hashlib/os): the protocol unit tests load this
without paying an accelerator import.

The port's copy of mythril_tpu/serve/quarantine.py, writing the same
sidecar format (through the port's ``support/checkpoint.fsync_replace``),
so either package reads the other's sidecar. The supervisor passes the
threshold, whose default is the JAX knob's
(MYTHRIL_TPU_SERVE_QUARANTINE_AFTER, :data:`QUARANTINE_AFTER`).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
from typing import Dict, Optional

from ..support.checkpoint import fsync_replace

log = logging.getLogger(__name__)

QUARANTINE_VERSION = 1

#: worker deaths that quarantine a contract (MYTHRIL_TPU_SERVE_QUARANTINE_AFTER)
QUARANTINE_AFTER = 2


class QuarantinedContract(Exception):
    """Raised at admission for a contract in the poison sidecar; the
    service answers it with the typed ``quarantined`` protocol error."""

    def __init__(self, key: str, entry: Optional[dict] = None):
        self.key = key
        self.entry = dict(entry or {})
        crashes = self.entry.get("crashes", "?")
        classes = ",".join(self.entry.get("classes", [])) or "unknown"
        super().__init__(
            f"contract {key[:16]}… is quarantined after {crashes} worker "
            f"death(s) ({classes}); refusing to risk another worker")


def contract_key(code: Optional[str]) -> str:
    """Stable poison key for a request: sha256 of the normalized hex
    bytecode (case-folded, ``0x`` stripped) — the same identity under
    which the warmset stores taint summaries."""
    normalized = (code or "").strip().lower()
    normalized = normalized.removeprefix("0x")
    return hashlib.sha256(normalized.encode("utf-8")).hexdigest()


def quarantine_path_for(manifest_path: str) -> str:
    """The poison sidecar sits beside the shape manifest:
    ``warmset.json`` → ``warmset.quarantine.json``."""
    base, _ = os.path.splitext(manifest_path)
    return f"{base}.quarantine.json"


def load_quarantine(path: str) -> Dict[str, dict]:
    """Per-contract crash records keyed by bytecode hash; {} for
    missing, malformed, or unknown-version sidecars (logged, never
    raised)."""
    try:
        with open(path, "r", encoding="utf-8") as handle:
            doc = json.load(handle)
    except FileNotFoundError:
        return {}
    except (OSError, ValueError) as error:
        log.warning("quarantine sidecar %s unreadable (%s) — starting "
                    "with an empty poison list", path, error)
        return {}
    if not isinstance(doc, dict) or doc.get("version") != QUARANTINE_VERSION:
        log.warning("quarantine sidecar %s has unsupported version %r — "
                    "starting with an empty poison list", path,
                    doc.get("version") if isinstance(doc, dict) else None)
        return {}
    contracts = {}
    for key, entry in (doc.get("contracts") or {}).items():
        if isinstance(key, str) and isinstance(entry, dict):
            contracts[key] = {
                "crashes": int(entry.get("crashes", 0) or 0),
                "classes": sorted({str(c)
                                   for c in entry.get("classes", []) or []}),
                "quarantined": bool(entry.get("quarantined", False)),
            }
        else:
            log.warning("quarantine sidecar %s: skipping malformed entry "
                        "%r", path, key)
    return contracts


def _merge_entry(disk: dict, mem: dict) -> dict:
    """Union of two crash records: evidence only accumulates (max of
    crash counts — two daemons counting the same death must not double
    it — union of classes, OR of the quarantine verdict)."""
    return {
        "crashes": max(disk.get("crashes", 0), mem.get("crashes", 0)),
        "classes": sorted(set(disk.get("classes", []))
                          | set(mem.get("classes", []))),
        "quarantined": bool(disk.get("quarantined")
                            or mem.get("quarantined")),
    }


def save_quarantine(path: str, contracts: Dict[str, dict]) -> int:
    """Merge `contracts` into the sidecar at `path` (entry-wise union
    with what is already there) and write it fsync-atomically. Returns
    the merged entry count."""
    merged = load_quarantine(path)
    for key, entry in contracts.items():
        if isinstance(key, str) and isinstance(entry, dict):
            merged[key] = _merge_entry(merged.get(key, {}), entry)
    payload = {"version": QUARANTINE_VERSION,
               "contracts": {key: merged[key] for key in sorted(merged)}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as handle:
        json.dump(payload, handle, indent=1)
    fsync_replace(tmp, path)
    return len(merged)


class QuarantineStore:
    """The supervisor's view of the poison list: check → record → flush.

    ``path=None`` disables persistence (crash accounting still works in
    memory, so a path-less daemon is protected for its own lifetime)."""

    def __init__(self, path: Optional[str] = None,
                 threshold: int = QUARANTINE_AFTER):
        self.path = path
        self.threshold = max(1, int(threshold))
        self._lock = threading.Lock()
        self._contracts: Dict[str, dict] = \
            load_quarantine(path) if path else {}

    def entry(self, key: str) -> Optional[dict]:
        with self._lock:
            found = self._contracts.get(key)
            return dict(found) if found else None

    def is_quarantined(self, key: str) -> bool:
        with self._lock:
            return bool(self._contracts.get(key, {}).get("quarantined"))

    def check(self, key: str) -> None:
        """Raise QuarantinedContract when `key` is poison (the
        admission-time gate)."""
        with self._lock:
            entry = self._contracts.get(key)
            if entry and entry.get("quarantined"):
                raise QuarantinedContract(key, entry)

    def record_crash(self, key: str, failure_class: str) -> bool:
        """Charge one worker death to `key`; returns True when this
        crash newly quarantined the contract. Persists on every call —
        deaths are rare and the sidecar must survive a daemon crash."""
        with self._lock:
            entry = self._contracts.setdefault(
                key, {"crashes": 0, "classes": [], "quarantined": False})
            entry["crashes"] += 1
            if failure_class not in entry["classes"]:
                entry["classes"] = sorted(set(entry["classes"])
                                          | {failure_class})
            newly = (not entry["quarantined"]
                     and entry["crashes"] >= self.threshold)
            if newly:
                entry["quarantined"] = True
                log.error(
                    "contract %s… QUARANTINED after %d worker death(s) "
                    "(%s): further requests are refused", key[:16],
                    entry["crashes"], ",".join(entry["classes"]))
            snapshot = {key: dict(entry)}
        self._flush(snapshot)
        return newly

    def _flush(self, contracts: Dict[str, dict]) -> None:
        if not self.path:
            return
        try:
            save_quarantine(self.path, contracts)
        except OSError as error:
            log.warning("could not persist quarantine sidecar %s: %s",
                        self.path, error)

    def quarantined_count(self) -> int:
        with self._lock:
            return sum(1 for entry in self._contracts.values()
                       if entry.get("quarantined"))

    def status(self) -> dict:
        with self._lock:
            return {
                "sidecar": self.path,
                "threshold": self.threshold,
                "tracked": len(self._contracts),
                "quarantined": sum(1 for e in self._contracts.values()
                                   if e.get("quarantined")),
            }
