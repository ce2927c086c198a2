"""WarmSet: the persisted registry of hot K11 shape buckets.

The port's copy of mythril_tpu/serve/warmset.py. Every process records
the shape keys its SAT chunks ran under
(``device_solver.observed_shape_keys()``, the accounting behind
``xla.bucket_compiles``/``xla.bucket_reuses``); the daemon replays the
manifest through ``device_solver.warm_shape_key`` at startup, inside the
``serve.warmup`` trace span, so that the requests after it count their
buckets as reuses. In the port a first run of a bucket pays no compile
(K11 is built once for every shape, `kernels/build.py`), and a warmed key
spares no CUDA-graph capture either: the graphs are keyed by the tensors'
storage (`kernels/ops._SAT_GRAPHS`), and a request's problem tensors are
new. So in the port ``xla.bucket_reuses`` (a reply's ``warm_hits``, the
``/healthz`` totals) counts chunks whose shape key this process had run
before, not captures or compiles saved.

Manifest format (JSON, versioned), the JAX package's::

    {"version": 1,
     "shapes": [["single", 1, 256, 5, 1, 1024, 32],
                ["batch", 256, 5, 1, 1024, 4, 32], ...]}

Shape entries are exactly the JAX runner shape keys. The manifest merges
monotonically: saving unions the shapes already on disk with the ones
observed this process. Writes go through the port's fsync-atomic
``support/checkpoint.fsync_replace``. Unknown versions and malformed
entries load as empty/skipped — a stale manifest degrades to a cold
start, never a crash.

Beside the shape manifest live the **taint-summary store**
(``<manifest>.summaries.json``: per-contract
``staticanalysis.ContractSummary`` JSON keyed by runtime-bytecode hash,
pre-seeded onto a repeat contract's disassembly with
``staticanalysis.install_summary``) and the **verdict sidecar**
(``<manifest>.verdicts.json``: the canonical-CNF SAT/UNSAT verdict cache
of smt/solver/dispatch.py, loaded at warmup through
``dispatch.import_verdicts``, union-merged at request end under a flock
from ``dispatch.export_verdicts``, bounded by ``verdict_sidecar_max``).
The files are the JAX package's formats, so either package reads the
other's. The knobs MYTHRIL_TPU_SERVE_MANIFEST, MYTHRIL_TPU_DIR,
MYTHRIL_TPU_VERDICT_SIDECAR and MYTHRIL_TPU_VERDICT_SIDECAR_MAX are
arguments here, with the knobs' defaults; the default manifest lives
under ``~/.mythril_tpu_torch/``.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Tuple

from . import state_dir
from ..exceptions import DeviceUnavailable
from ..kernels import build
from ..observe import metrics, trace
from ..support.checkpoint import fsync_replace

log = logging.getLogger(__name__)

MANIFEST_VERSION = 1
SUMMARIES_VERSION = 1
VERDICTS_VERSION = 1

#: verdict-sidecar entries kept (MYTHRIL_TPU_VERDICT_SIDECAR_MAX)
VERDICT_SIDECAR_MAX = 65536


def default_manifest_path() -> str:
    """~/.mythril_tpu_torch/warmset.json."""
    return os.path.join(state_dir(), "warmset.json")


def load_manifest(path: str) -> List[Tuple]:
    """Shape keys from a manifest file; [] for missing, malformed, or
    unknown-version manifests (each skip is logged, never raised)."""
    try:
        with open(path, "r", encoding="utf-8") as handle:
            doc = json.load(handle)
    except FileNotFoundError:
        return []
    except (OSError, ValueError) as error:
        log.warning("warmset manifest %s unreadable (%s) — cold start",
                    path, error)
        return []
    if not isinstance(doc, dict) or doc.get("version") != MANIFEST_VERSION:
        log.warning("warmset manifest %s has unsupported version %r — "
                    "cold start", path,
                    doc.get("version") if isinstance(doc, dict) else None)
        return []
    shapes = []
    for entry in doc.get("shapes") or []:
        if isinstance(entry, list) and entry \
                and isinstance(entry[0], str) \
                and all(isinstance(dim, int) for dim in entry[1:]):
            shapes.append(tuple(entry))
        else:
            log.warning("warmset manifest %s: skipping malformed entry %r",
                        path, entry)
    return shapes


def save_manifest(path: str, shapes: List[Tuple]) -> int:
    """Merge `shapes` into the manifest at `path` (union with what is
    already there) and write it fsync-atomically. Returns the merged
    shape count."""
    merged = sorted(set(load_manifest(path)) | {tuple(s) for s in shapes})
    payload = {"version": MANIFEST_VERSION,
               "shapes": [list(shape) for shape in merged]}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as handle:
        json.dump(payload, handle, indent=1)
    fsync_replace(tmp, path)
    return len(merged)


def summaries_path_for(manifest_path: str) -> str:
    """The taint-summary store sits beside the shape manifest:
    ``warmset.json`` → ``warmset.summaries.json``."""
    base, _ = os.path.splitext(manifest_path)
    return f"{base}.summaries.json"


def load_summaries(path: str) -> Dict[str, dict]:
    """Per-contract summary JSON keyed by bytecode hash; {} for missing,
    malformed, or unknown-version stores (logged, never raised). Entries
    are returned verbatim — ``ContractSummary.from_json`` does its own
    version/shape validation at install time."""
    try:
        with open(path, "r", encoding="utf-8") as handle:
            doc = json.load(handle)
    except FileNotFoundError:
        return {}
    except (OSError, ValueError) as error:
        log.warning("summary store %s unreadable (%s) — summaries will "
                    "be rebuilt", path, error)
        return {}
    if not isinstance(doc, dict) or doc.get("version") != SUMMARIES_VERSION:
        log.warning("summary store %s has unsupported version %r — "
                    "summaries will be rebuilt", path,
                    doc.get("version") if isinstance(doc, dict) else None)
        return {}
    summaries = {}
    for key, entry in (doc.get("summaries") or {}).items():
        if isinstance(key, str) and isinstance(entry, dict):
            summaries[key] = entry
        else:
            log.warning("summary store %s: skipping malformed entry %r",
                        path, key)
    return summaries


def save_summaries(path: str, summaries: Dict[str, dict]) -> int:
    """Merge `summaries` into the store at `path` (union by bytecode
    hash, this process's entries winning ties) and write it
    fsync-atomically. Returns the merged entry count."""
    merged = load_summaries(path)
    merged.update({k: v for k, v in summaries.items()
                   if isinstance(k, str) and isinstance(v, dict)})
    payload = {"version": SUMMARIES_VERSION,
               "summaries": {key: merged[key] for key in sorted(merged)}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as handle:
        json.dump(payload, handle, indent=1)
    fsync_replace(tmp, path)
    return len(merged)


def verdicts_path_for(manifest_path: str) -> str:
    """The verdict sidecar sits beside the shape manifest:
    ``warmset.json`` → ``warmset.verdicts.json``."""
    base, _ = os.path.splitext(manifest_path)
    return f"{base}.verdicts.json"


def _verdict_key(entry: list) -> str:
    """Dedup key for one sidecar entry: the canonical CNF itself (the
    verdict is a property of the clause set, so colliding entries are
    interchangeable)."""
    return json.dumps([entry[0], entry[1]])


def load_verdicts(path: str) -> List[list]:
    """Sidecar entries (JSON-shaped, see ``dispatch.export_verdicts``);
    [] for missing, malformed, or unknown-version sidecars (logged,
    never raised). Entries are shallow-checked here — deep validation
    happens at ``dispatch.import_verdicts`` time."""
    try:
        with open(path, "r", encoding="utf-8") as handle:
            doc = json.load(handle)
    except FileNotFoundError:
        return []
    except (OSError, ValueError) as error:
        log.warning("verdict sidecar %s unreadable (%s) — cold verdict "
                    "cache", path, error)
        return []
    if not isinstance(doc, dict) or doc.get("version") != VERDICTS_VERSION:
        log.warning("verdict sidecar %s has unsupported version %r — "
                    "cold verdict cache", path,
                    doc.get("version") if isinstance(doc, dict) else None)
        return []
    entries = []
    for entry in doc.get("verdicts") or []:
        if isinstance(entry, list) and len(entry) == 4:
            entries.append(entry)
        else:
            log.warning("verdict sidecar %s: skipping malformed entry %r",
                        path, entry)
    return entries


def save_verdicts(path: str, entries: List[list],
                  max_entries: int = VERDICT_SIDECAR_MAX) -> int:
    """Union-merge `entries` into the sidecar at `path` and write it
    fsync-atomically: what is on disk loads first, this process's
    entries append (disk-order = age-order, so eviction under the
    ``max_entries`` bound drops the OLDEST entries).
    The load-merge-write runs under an exclusive flock on a ``.lock``
    file beside the sidecar, so two workers flushing concurrently
    serialize and neither's entries are lost (the lock guards the
    read-modify-write; the fsync-atomic rename guards readers). Returns
    the entry count written."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    lock_handle = None
    try:
        import fcntl

        lock_handle = open(f"{path}.lock", "w", encoding="utf-8")
        fcntl.flock(lock_handle, fcntl.LOCK_EX)
    except (ImportError, OSError):
        lock_handle = None  # non-POSIX: rename atomicity still holds
    try:
        merged: Dict[str, list] = {}
        for entry in load_verdicts(path):
            merged[_verdict_key(entry)] = entry
        fresh = 0
        for entry in entries:
            key = _verdict_key(entry)
            if key not in merged:
                fresh += 1
            merged[key] = entry
        if fresh:
            metrics.inc("cache.verdict.merged", fresh)
        ordered = list(merged.values())
        bound = max(1, int(max_entries))
        if len(ordered) > bound:
            metrics.inc("cache.verdict.evicted", len(ordered) - bound)
            ordered = ordered[len(ordered) - bound:]
        payload = {"version": VERDICTS_VERSION, "verdicts": ordered}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as handle:
            json.dump(payload, handle, indent=1)
        fsync_replace(tmp, path)
        return len(ordered)
    finally:
        if lock_handle is not None:
            lock_handle.close()


class WarmSet:
    """The daemon's view of the warm buckets: load → warm → record.

    ``path=None`` disables persistence. ``verdict_sidecar`` and
    ``verdict_sidecar_max`` are the JAX knobs MYTHRIL_TPU_VERDICT_SIDECAR
    and MYTHRIL_TPU_VERDICT_SIDECAR_MAX. ``device_required`` says whether
    the daemon asked for the card (``--engine tpu`` or ``--solver jax``):
    then a missing card raises at warmup; otherwise the manifest's buckets
    stay cold, as unwarmable, on a machine without one."""

    def __init__(self, path: Optional[str] = None,
                 verdict_sidecar: bool = True,
                 verdict_sidecar_max: int = VERDICT_SIDECAR_MAX,
                 device_required: bool = False):
        self.path = path
        self.verdict_sidecar = verdict_sidecar
        self.verdict_sidecar_max = verdict_sidecar_max
        self.device_required = device_required
        self.warmed: List[Tuple] = []
        self.failed: List[Tuple] = []
        #: verdict-cache entries loaded from the sidecar at warmup
        self.loaded_verdicts = 0
        # taint summaries recorded this process, pending persistence
        self._pending_summaries: Dict[str, dict] = {}
        # lazy-loaded view of the on-disk store (None = not loaded yet)
        self._stored_summaries: Optional[Dict[str, dict]] = None

    def _summaries_path(self) -> Optional[str]:
        return summaries_path_for(self.path) if self.path else None

    def _verdicts_path(self) -> Optional[str]:
        return verdicts_path_for(self.path) if self.path else None

    def summary_for(self, code_hash: str) -> Optional[dict]:
        """The persisted ContractSummary JSON for a bytecode hash, if any
        (this process's fresh records take precedence over disk)."""
        if code_hash in self._pending_summaries:
            return self._pending_summaries[code_hash]
        if self._stored_summaries is None:
            path = self._summaries_path()
            self._stored_summaries = load_summaries(path) if path else {}
        return self._stored_summaries.get(code_hash)

    def record_summary(self, code_hash: str, summary_json: dict) -> None:
        """Queue a freshly built summary for persistence (flushed by
        :meth:`record_observed` after each request and at shutdown)."""
        if code_hash and isinstance(summary_json, dict):
            self._pending_summaries[code_hash] = summary_json

    def warmup(self) -> int:
        """Run one K11 chunk at every manifest bucket, on the dispatch's
        device, inside one ``serve.warmup`` span (traceview attributes the
        first runs to warmup, not to the first request). Returns the bucket
        count actually warmed."""
        shapes = load_manifest(self.path) if self.path else []
        # the span is emitted even for an empty manifest: traceview's
        # serve section attributes warmup separately from request time,
        # and "0 buckets warmed" is a finding, not an absence
        with trace.span("serve.warmup", buckets=len(shapes)) as span:
            if shapes:
                self._warm_shapes(shapes)
            self.loaded_verdicts = self._load_verdicts()
            span.set(warmed=len(self.warmed), failed=len(self.failed),
                     exec_hits=int(metrics.value("cache.exec.hits")),
                     exec_misses=int(metrics.value("cache.exec.misses")),
                     verdicts_loaded=self.loaded_verdicts)
        if self.failed:
            log.warning("warmup skipped %d un-warmable manifest shapes "
                        "(a mesh that cannot host them, malformed, or no "
                        "card): %s",
                        len(self.failed), self.failed[:4])
        log.info("warmup ran %d clause-shape buckets (%d kernel libraries "
                 "found built), loaded %d verdicts",
                 len(self.warmed), int(metrics.value("cache.exec.hits")),
                 self.loaded_verdicts)
        return len(self.warmed)

    def _warm_shapes(self, shapes: List[Tuple]) -> None:
        from ..parallel import device_solver
        from ..smt.solver import dispatch

        try:
            device = dispatch.resolve_device()
        except DeviceUnavailable:
            if self.device_required:
                raise
            log.warning("no CUDA device: the manifest's %d K11 buckets stay "
                        "cold in this host daemon", len(shapes))
            self.failed.extend(shapes)
            return
        for shape in shapes:
            if device_solver.warm_shape_key(shape, device=device):
                self.warmed.append(shape)
                metrics.inc("serve.warmed_buckets")
            else:
                self.failed.append(shape)

    def _load_verdicts(self) -> int:
        """Seed the dispatch verdict cache from the persisted sidecar
        (worker spawn / daemon warmup). Best-effort: an unreadable or
        stale sidecar is a cold cache, never a failed startup."""
        path = self._verdicts_path()
        if not path or not self.verdict_sidecar:
            return 0
        from ..smt.solver import dispatch

        return dispatch.import_verdicts(load_verdicts(path))

    def _flush_verdicts(self) -> None:
        """Union-merge this process's verdict cache into the sidecar."""
        path = self._verdicts_path()
        if not path or not self.verdict_sidecar:
            return
        from ..smt.solver import dispatch

        entries = dispatch.export_verdicts()
        if not entries:
            return
        try:
            save_verdicts(path, entries, self.verdict_sidecar_max)
        except OSError as error:
            log.warning("could not persist verdict sidecar %s: %s",
                        path, error)

    def record_observed(self) -> int:
        """Persist every shape this process has compiled so far (warmup
        plus live traffic) back into the manifest. Called after each
        request and at shutdown — the next daemon starts at least this
        warm. No-op (returning 0) without a manifest path."""
        if not self.path:
            return 0
        self._flush_summaries()
        self._flush_verdicts()
        from ..parallel import device_solver

        observed = device_solver.observed_shape_keys()
        if not observed:
            return 0
        try:
            return save_manifest(self.path, observed)
        except OSError as error:
            log.warning("could not persist warmset manifest %s: %s",
                        self.path, error)
            return 0

    def _flush_summaries(self) -> None:
        if not self._pending_summaries:
            return
        path = self._summaries_path()
        try:
            save_summaries(path, self._pending_summaries)
        except OSError as error:
            log.warning("could not persist summary store %s: %s",
                        path, error)
            return
        # fold into the in-memory view so summary_for keeps answering
        # without a re-read, then clear the queue
        if self._stored_summaries is not None:
            self._stored_summaries.update(self._pending_summaries)
        self._pending_summaries.clear()

    def status(self) -> dict:
        from ..parallel import device_solver

        if self._stored_summaries is None:
            path = self._summaries_path()
            self._stored_summaries = load_summaries(path) if path else {}
        return {
            "manifest": self.path,
            "warmed_buckets": len(self.warmed),
            "unwarmable_buckets": len(self.failed),
            "observed_buckets": len(device_solver.observed_shape_keys()),
            "taint_summaries": len(set(self._stored_summaries)
                                   | set(self._pending_summaries)),
            "exec_cache": build.stats(),
            "verdicts_loaded": self.loaded_verdicts,
        }
