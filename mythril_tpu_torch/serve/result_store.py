"""Content-addressed analysis-result store for the serve daemon.

Mainnet bytecode is heavily duplicated (the same proxy/implementation
bytes behind thousands of addresses — the DTVM result-commoditization
argument, PAPERS.md), so a daemon that re-analyzes every repeat codehash
wastes its scarcest resource. This store answers a repeat ``analyze``
request *at admission*, before the priority queue and before any worker
dispatch: the cheapest possible form of load shedding.

Keying: ``result_key`` is the sha256 of the normalized bytecode (the
same case-folded, ``0x``-stripped hex identity the quarantine sidecar
uses) **plus the effective analysis config** — modules, transaction
count, strategy, solver, engine, max_depth, bin_runtime, and a schema
version. Two requests for one codehash under different configs are
different keys (a config change must miss, never serve a stale verdict);
the request's ``deadline_ms`` and ``priority`` are deliberately *not* in
the key — they shape scheduling, not the analysis result.

Persistence follows the quarantine/verdict sidecar pattern
(serve/quarantine.py, serve/warmset.py): a versioned JSON sidecar beside
the warmset manifest (``warmset.json`` → ``warmset.results.json``),
union-merge on save under an exclusive flock (two daemons sharing the
sidecar accumulate each other's results, never clobber), fsync-atomic
writes via ``support/checkpoint.fsync_replace``, tolerant loads that
degrade to an empty store, and age-ordered eviction beyond
``max_entries`` (:data:`RESULT_STORE_MAX`).

Two hard refusals in :meth:`ResultStore.put`:

* **incomplete payloads** — a deadline-drained partial report is a
  scheduling artifact, not the contract's analysis; caching it would
  serve truncated verdicts forever;
* **quarantined hashes** — a contract in the poison sidecar must never
  have a cached answer either (the cache would mask the quarantine and
  hide that the result predates the crashes that condemned it).

Stdlib-only (json/hashlib/os): protocol-level tests load this without
paying an accelerator import.

The port's copy of mythril_tpu/serve/result_store.py, with the same keys
and sidecar format; the bound is a keyword default, the JAX knob's
(MYTHRIL_TPU_RESULT_STORE_MAX).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
from typing import Dict, Optional

from .quarantine import contract_key
from ..support.checkpoint import fsync_replace

log = logging.getLogger(__name__)

RESULTS_VERSION = 1

#: entries the store keeps (MYTHRIL_TPU_RESULT_STORE_MAX)
RESULT_STORE_MAX = 4096

#: params that shape the analysis result (deadline/priority excluded:
#: they shape scheduling, not the verdict)
_CONFIG_FIELDS = ("bin_runtime", "transaction_count", "strategy",
                  "solver", "engine", "max_depth")


def result_key(params: Dict, solver: str = "cdcl", engine: str = "host",
               strategy: str = "bfs", op: str = "analyze") -> str:
    """Content address for one request: sha256 over the normalized
    bytecode hash plus the *effective* analysis config (the daemon
    defaults applied, so an explicit ``"solver": "cdcl"`` and an omitted
    solver under a cdcl daemon hash identically). The request ``op`` is
    part of the key material: an ``analyze`` verdict and an ``optimize``
    report for the same bytecode are different results and must never
    answer each other."""
    config = {
        "v": RESULTS_VERSION,
        "op": op,
        "code": contract_key(params.get("code")),
        "modules": sorted(params.get("modules") or []) or None,
        "bin_runtime": bool(params.get("bin_runtime", False)),
        "transaction_count": params.get("transaction_count"),
        "strategy": params.get("strategy") or strategy,
        "solver": params.get("solver") or solver,
        "engine": params.get("engine") or engine,
        "max_depth": params.get("max_depth"),
    }
    blob = json.dumps(config, sort_keys=True)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def results_path_for(manifest_path: str) -> str:
    """The result sidecar sits beside the shape manifest:
    ``warmset.json`` → ``warmset.results.json``."""
    base, _ = os.path.splitext(manifest_path)
    return f"{base}.results.json"


def load_results(path: str) -> Dict[str, dict]:
    """Entries keyed by result key, each ``{"seq": n, "payload": {...}}``;
    {} for missing, malformed, or unknown-version sidecars (logged,
    never raised — a corrupt sidecar serves nobody, but can never crash
    the daemon)."""
    try:
        with open(path, "r", encoding="utf-8") as handle:
            doc = json.load(handle)
    except FileNotFoundError:
        return {}
    except (OSError, ValueError) as error:
        log.warning("result sidecar %s unreadable (%s) — cold result "
                    "store", path, error)
        return {}
    if not isinstance(doc, dict) or doc.get("version") != RESULTS_VERSION:
        log.warning("result sidecar %s has unsupported version %r — cold "
                    "result store", path,
                    doc.get("version") if isinstance(doc, dict) else None)
        return {}
    entries: Dict[str, dict] = {}
    for key, entry in (doc.get("results") or {}).items():
        if (isinstance(key, str) and isinstance(entry, dict)
                and isinstance(entry.get("payload"), dict)):
            entries[key] = {"seq": int(entry.get("seq", 0) or 0),
                            "payload": entry["payload"]}
        else:
            log.warning("result sidecar %s: skipping malformed entry %r",
                        path, key)
    return entries


def save_results(path: str, entries: Dict[str, dict],
                 max_entries: int = RESULT_STORE_MAX) -> int:
    """Union-merge `entries` into the sidecar at `path` under an
    exclusive flock and write it fsync-atomically. On a key collision
    the entry with the higher ``seq`` wins (both daemons computed the
    same analysis; the newer write is at least as fresh). Age-ordered
    eviction (lowest seq first) keeps the store under the
    ``max_entries`` bound. Returns the entry count
    written."""
    from ..observe import metrics

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    lock_handle = None
    try:
        import fcntl

        lock_handle = open(f"{path}.lock", "w", encoding="utf-8")
        fcntl.flock(lock_handle, fcntl.LOCK_EX)
    except (ImportError, OSError):
        lock_handle = None  # non-POSIX: rename atomicity still holds
    try:
        merged = load_results(path)
        top = max((e["seq"] for e in merged.values()), default=0)
        for key, entry in entries.items():
            disk = merged.get(key)
            if disk is None or entry["seq"] > disk["seq"]:
                top = max(top, entry["seq"])
                merged[key] = entry
        bound = max(1, int(max_entries))
        if len(merged) > bound:
            victims = sorted(merged, key=lambda k: merged[k]["seq"])
            evicted = len(merged) - bound
            for key in victims[:evicted]:
                del merged[key]
            metrics.inc("cache.result.evicted", evicted)
        payload = {"version": RESULTS_VERSION,
                   "results": {key: merged[key] for key in sorted(merged)}}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as handle:
            json.dump(payload, handle, indent=1)
        fsync_replace(tmp, path)
        return len(merged)
    finally:
        if lock_handle is not None:
            lock_handle.close()


class ResultStore:
    """The daemon's view of the result sidecar: get → put → flush.

    ``path=None`` disables persistence (the in-memory map still
    short-circuits repeats within this daemon's lifetime). An optional
    ``quarantine`` (serve/quarantine.py QuarantineStore) enforces the
    poison interaction: a quarantined bytecode hash is never cached and
    never answered from cache."""

    def __init__(self, path: Optional[str] = None,
                 max_entries: int = RESULT_STORE_MAX,
                 quarantine=None):
        self.path = path
        self.max_entries = max(1, int(max_entries))
        self.quarantine = quarantine
        self._lock = threading.Lock()
        self._entries: Dict[str, dict] = \
            load_results(path) if path else {}
        self._seq = max((e["seq"] for e in self._entries.values()),
                        default=0)
        self.hits = 0
        self.misses = 0

    def get(self, key: str,
            contract_hash: Optional[str] = None) -> Optional[Dict]:
        """The cached payload for `key`, or None. Counts
        ``cache.result.hits``/``misses``; refuses to answer for a
        quarantined `contract_hash` (the caller's typed ``quarantined``
        refusal must win over a stale cached verdict)."""
        from ..observe import metrics

        if (contract_hash and self.quarantine is not None
                and self.quarantine.is_quarantined(contract_hash)):
            return None
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                metrics.inc("cache.result.misses")
                return None
            self.hits += 1
            metrics.inc("cache.result.hits")
            return json.loads(json.dumps(entry["payload"]))

    def put(self, key: str, payload: Dict,
            contract_hash: Optional[str] = None) -> bool:
        """Cache one *complete* analysis payload; returns True when
        stored. Refuses incomplete reports and quarantined hashes (see
        module docstring), and flushes the sidecar on every accepted
        put — results are expensive and must survive a daemon crash."""
        from ..observe import metrics

        if not isinstance(payload, dict) or payload.get("incomplete"):
            return False
        if (contract_hash and self.quarantine is not None
                and self.quarantine.is_quarantined(contract_hash)):
            log.info("result store: refusing to cache quarantined "
                     "contract %s…", (contract_hash or "")[:16])
            return False
        clean = {name: value for name, value in payload.items()
                 if name not in ("cached",)}
        with self._lock:
            self._seq += 1
            entry = {"seq": self._seq, "payload": clean}
            self._entries[key] = entry
            if len(self._entries) > self.max_entries:
                victims = sorted(self._entries,
                                 key=lambda k: self._entries[k]["seq"])
                evicted = len(self._entries) - self.max_entries
                for victim in victims[:evicted]:
                    del self._entries[victim]
                metrics.inc("cache.result.evicted", evicted)
            snapshot = {key: entry}
        metrics.inc("cache.result.stored")
        self._flush(snapshot)
        return True

    def _flush(self, entries: Dict[str, dict]) -> None:
        if not self.path:
            return
        try:
            save_results(self.path, entries, self.max_entries)
        except OSError as error:
            log.warning("could not persist result sidecar %s: %s",
                        self.path, error)

    def status(self) -> dict:
        with self._lock:
            entries = len(self._entries)
        total = self.hits + self.misses
        return {
            "sidecar": self.path,
            "entries": entries,
            "max_entries": self.max_entries,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / total, 4) if total else 0.0,
        }
