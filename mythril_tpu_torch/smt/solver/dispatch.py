"""Batched device SAT dispatch: the single funnel between every solver
caller and the device backend.

Every feasibility or detection query of `--solver jax` would otherwise pay
a whole device launch for one CNF; device SAT solvers pay off only when
many problems share a launch, so this layer batches the solver's queries
the way the frontier batches the interpreter's lanes.

The pieces, in query order:

- **Canonical form** (`canonicalize`): sorted-literal normal form — literals
  sorted and deduped within a clause, tautologies dropped, clauses deduped
  and sorted, an empty clause collapsing the CNF to falsum. Variables are
  NOT renumbered, so a model of the canonical CNF is a model of the
  original, and syntactically shuffled repeats of one query share a key.
- **Verdict cache**: bounded LRU over canonical CNFs holding SAT/UNSAT
  verdicts (+ model). Sound independent of the caller's conflict budget:
  the device answers UNKNOWN on exhaustion and UNKNOWN is never cached, so
  a cached verdict is a real decision. Purged whenever the device backend
  is quarantined — verdicts sourced from a device that has been caught
  lying are not worth keeping.
- **Deferred-flush queue**: `submit()` returns a lightweight future;
  identical in-flight queries dedup onto one entry (conflict budgets merge
  by max). The queue flushes when it reaches `flush` entries, when a
  submit finds the oldest entry older than `age_ms`, or — the engine being
  single-threaded — the moment any caller demands a result. Speculative
  prefetchers (solver.prefetch_formulas / model.prefetch_models / the
  frontier's escape-pruning slab) fill the queue so the first demanded
  result solves the whole batch in one launch.
- **Resilience contract** (support/resilience.py): one batch = one
  `fire(DEVICE)` visit, one breaker `allow()` gate, failures classified
  once per batch; the wall-overrun budget divides the batch's elapsed time
  by its occupancy before comparing (N queries in one launch taking N x
  the per-query budget is the whole point). `--device-crosscheck` keeps
  sampling INDIVIDUAL queries out of a batch against the host oracle; a
  mid-batch divergence quarantines the backend, hands the remaining
  entries to the CDCL ladder, and purges the cache.

`--no-batch-solve` bypasses queue and cache entirely (one query, one
launch — the legacy path, kept for A/B).

The port's copy of mythril_tpu/smt/solver/dispatch.py, on the port's
device SAT lane (`parallel/device_solver.solve_cnf_device` and
`solve_cnf_device_batch`: K11 on the card, its plain twin on the CPU).
Two differences:

- The JAX package reads MYTHRIL_TPU_BATCH_FLUSH, _BATCH_AGE_MS,
  _VERDICT_CACHE and _DEVICE_CLAUSE_CAP; here they are `configure(...)`
  arguments with the same defaults, beside the lane's `device` (None: the
  card; "cpu" runs the twin, for tests). `reset_settings()` restores them.
  MYTHRIL_TPU_SHARD and the mesh are the lane's own settings
  (`device_solver.configure`): a single-query flush shards its clauses
  over the mesh as the JAX lane does, a batch never.
- A device failure is classified and answered by the CDCL only when it is
  an injected fault (`resilience.BackendFailure`; `--inject-fault
  device_oom` raises one), or a host `MemoryError` of the plain twin on
  the CPU lane the tests configure. Anything else a solve raises — a
  kernel that does not build (kernels/build.py), a launch that fails, the
  card out of memory, no card — propagates: the ladder never moves K11's
  work to the host unseen.
Metrics, spans and the `dispatch.flush` structured log record go to the
port's registry, tracer and slog (observe/)."""

from __future__ import annotations

import logging
import time
from collections import OrderedDict
from typing import List, Optional, Tuple

from . import sat
from .solver_statistics import SolverStatistics
from ...observe import metrics, slog, trace

log = logging.getLogger(__name__)

Verdict = Tuple[int, Optional[List[bool]]]
CanonicalKey = Tuple[int, Tuple[Tuple[int, ...], ...]]

#: the JAX knobs' defaults (mythril_tpu/support/tpu_config.py)
DEFAULT_FLUSH = 16
DEFAULT_AGE_MS = 50.0
DEFAULT_VERDICT_CACHE = 4096
#: 0: the lane's own cap, `device_solver.DEFAULT_CLAUSE_CAP`
DEFAULT_CLAUSE_CAP = 0
#: the conflict budget's ceiling as a step budget of one flush
MAX_DEVICE_STEPS = 50_000

_DEFAULT_SETTINGS = {"flush": DEFAULT_FLUSH, "age_ms": DEFAULT_AGE_MS,
                     "verdict_cache": DEFAULT_VERDICT_CACHE,
                     "clause_cap": DEFAULT_CLAUSE_CAP, "device": None}
_settings = dict(_DEFAULT_SETTINGS)


def configure(flush: int = DEFAULT_FLUSH, age_ms: float = DEFAULT_AGE_MS,
              verdict_cache: int = DEFAULT_VERDICT_CACHE,
              clause_cap: int = DEFAULT_CLAUSE_CAP, device=None) -> None:
    """Set the queue's flush threshold (MYTHRIL_TPU_BATCH_FLUSH), its age
    trigger (MYTHRIL_TPU_BATCH_AGE_MS), the verdict cache's bound
    (MYTHRIL_TPU_VERDICT_CACHE), the clause cap of a flush
    (MYTHRIL_TPU_DEVICE_CLAUSE_CAP, 0 = the lane's own) and the lane's
    device (None: the CUDA card). Read at call time, like the JAX knobs."""
    _settings.update(flush=flush, age_ms=age_ms, verdict_cache=verdict_cache,
                     clause_cap=clause_cap, device=device)


def reset_settings() -> None:
    """Restore every `configure` setting's default."""
    _settings.update(_DEFAULT_SETTINGS)


def resolve_device():
    """The lane's device (`device.resolve`: the card unless `configure`
    named the CPU; raises DeviceUnavailable without a card)."""
    from ... import device as _device

    return _device.resolve(_settings["device"])


def flush_threshold() -> int:
    """Queue length that forces a flush."""
    return max(1, int(_settings["flush"]))


def flush_age_ms() -> float:
    """Oldest-entry age that forces a flush at the next submit."""
    return float(_settings["age_ms"])


def cache_size() -> int:
    """Verdict-cache bound."""
    return max(1, int(_settings["verdict_cache"]))


def canonicalize(clauses: List[List[int]], n_vars: int) -> CanonicalKey:
    """Sorted-literal normal form. Preserves equivalence AND variable
    numbering (models transfer verbatim); collapses an empty clause to the
    single-falsum CNF so every trivially-UNSAT query shares one key."""
    seen = set()
    canonical = []
    for clause in clauses:
        lit_set = set(clause)
        if not lit_set:
            return n_vars, ((),)
        if any(-lit in lit_set for lit in lit_set):
            continue  # tautology: satisfied by every assignment
        lits = tuple(sorted(lit_set))
        if lits in seen:
            continue
        seen.add(lits)
        canonical.append(lits)
    canonical.sort()
    return n_vars, tuple(canonical)


class _Entry:
    """One unique in-flight query (deduped submissions share it)."""

    __slots__ = ("key", "clauses", "n_vars", "max_conflicts", "created",
                 "result", "origins")

    def __init__(self, key: Optional[CanonicalKey], clauses: List[List[int]],
                 n_vars: int, max_conflicts: int):
        self.key = key
        self.clauses = clauses
        self.n_vars = n_vars
        self.max_conflicts = max_conflicts
        self.created = time.time()
        self.result: Optional[Verdict] = None
        #: contract ids whose analyses submitted this query (fleet mode
        #: tags the current origin per turn; dedup hits merge into it)
        self.origins: set = set()
        origin = get_query_origin()
        if origin is not None:
            self.origins.add(origin)


class QueryFuture:
    """Lightweight handle on a submitted query. `result()` blocks by
    flushing the queue (single-threaded engine: "blocking" is one device
    batch away)."""

    __slots__ = ("_queue", "_entry", "_result")

    def __init__(self, queue: Optional["DispatchQueue"] = None,
                 entry: Optional[_Entry] = None,
                 result: Optional[Verdict] = None):
        self._queue = queue
        self._entry = entry
        self._result = result

    def done(self) -> bool:
        return self._result is not None or (
            self._entry is not None and self._entry.result is not None)

    def result(self) -> Verdict:
        if self._result is not None:
            return self._result
        if self._entry.result is None:
            self._queue.flush()
        if self._entry.result is None:
            # a reset() raced the flush away; fail closed like any other
            # device trouble — the caller's CDCL ladder decides
            self._entry.result = (sat.UNKNOWN, None)
        return self._entry.result


def _ladder_error(error: BaseException, device) -> bool:
    """Whether a device solve's exception is answered by the CDCL ladder:
    an injected fault, or the host out of memory under the plain twin
    (`device` "cpu", the tests' lane). Every other error, the card's own
    out-of-memory included, is a defect of the lane and propagates."""
    from ...support import resilience

    if isinstance(error, resilience.BackendFailure):
        return True
    if not isinstance(error, MemoryError) or device is None:
        return False
    import torch

    return torch.device(device).type == "cpu"


class DispatchQueue:
    """Process-wide query queue + verdict cache (single-threaded, like the
    engine; solver.reset_solver_backend resets it per analysis)."""

    def __init__(self):
        self.pending: "OrderedDict[CanonicalKey, _Entry]" = OrderedDict()
        self.cache: "OrderedDict[CanonicalKey, Tuple[int, Optional[Tuple[bool, ...]]]]" \
            = OrderedDict()
        #: flushes whose entries carried >= 2 distinct query origins
        #: (diagnostic for fleet mode; survives reset())
        self.shared_flushes = 0

    # -- cache -----------------------------------------------------------------------

    def _cache_get(self, key: CanonicalKey):
        hit = self.cache.get(key)
        if hit is not None:
            self.cache.move_to_end(key)
        return hit

    def _cache_put(self, key: CanonicalKey, status: int,
                   model: Optional[List[bool]]) -> None:
        if status not in (sat.SAT, sat.UNSAT):
            return  # UNKNOWN is budget-dependent, never a cacheable verdict
        self.cache[key] = (status, tuple(model) if model is not None else None)
        self.cache.move_to_end(key)
        bound = cache_size()
        while len(self.cache) > bound:
            self.cache.popitem(last=False)

    # -- queue -----------------------------------------------------------------------

    def submit(self, clauses: List[List[int]], n_vars: int,
               max_conflicts: int) -> QueryFuture:
        """Queue one query; returns a future. Cache hits and in-flight
        duplicates never reach the device."""
        statistics = SolverStatistics()
        statistics.batch_submitted += 1
        key = canonicalize(clauses, n_vars)
        cached = self._cache_get(key)
        if cached is not None:
            statistics.batch_cache_hits += 1
            status, model = cached
            return QueryFuture(
                result=(status, list(model) if model is not None else None))
        entry = self.pending.get(key)
        if entry is not None:
            statistics.batch_dedup_hits += 1
            entry.max_conflicts = max(entry.max_conflicts, max_conflicts)
            origin = get_query_origin()
            if origin is not None:
                entry.origins.add(origin)
            return QueryFuture(queue=self, entry=entry)
        entry = _Entry(key, [list(lits) for lits in key[1]], n_vars,
                       max_conflicts)
        self.pending[key] = entry
        future = QueryFuture(queue=self, entry=entry)
        oldest = next(iter(self.pending.values()))
        if len(self.pending) >= flush_threshold() or \
                (time.time() - oldest.created) * 1000.0 >= flush_age_ms():
            self.flush()
        return future

    def solve(self, clauses: List[List[int]], n_vars: int,
              max_conflicts: int) -> Verdict:
        """Synchronous solve. With batching on, this drains whatever the
        prefetchers queued alongside; with `--no-batch-solve`, it is the
        legacy one-query-one-launch path."""
        if not enabled():
            entry = _Entry(None, clauses, n_vars, max_conflicts)
            self._execute_batch([entry], batched=False)
            return entry.result
        return self.submit(clauses, n_vars, max_conflicts).result()

    def flush(self) -> None:
        """Ship every pending entry to the device as one batch."""
        if not self.pending:
            return
        entries = list(self.pending.values())
        self.pending.clear()
        self._execute_batch(entries, batched=True)

    def reset(self, keep_verdicts: bool = False) -> None:
        """Fresh analysis: drop the queue (dangling futures fail closed as
        UNKNOWN) and, by default, the verdict cache.

        ``keep_verdicts=True`` is the serve-daemon mode: the cache keys are
        canonical CNFs, and SAT/UNSAT (plus any model) is a property of the
        clause set itself — independent of which analysis's variable
        numbering produced it — so verdicts stay sound across requests and
        repeat analyses of similar contracts start warm. The default stays
        conservative for single-analysis runs and tests that assert exact
        device-consultation counts."""
        for entry in self.pending.values():
            entry.result = (sat.UNKNOWN, None)
        self.pending.clear()
        if not keep_verdicts:
            self.cache.clear()

    # -- the device boundary ---------------------------------------------------------

    def _execute_batch(self, entries: List[_Entry], batched: bool) -> None:
        """One device launch for `entries`, under the full resilience
        contract (one fire(DEVICE), one breaker gate, failures classified
        per batch, wall budget divided by occupancy, crosscheck sampling
        individual queries)."""
        from ...parallel import device_solver
        from ...support import resilience
        from .solver import _crosscheck_device_verdict

        statistics = SolverStatistics()
        health = resilience.registry.backend(resilience.DEVICE)
        if not health.allow():
            if health.state == resilience.QUARANTINED:
                # quarantine can land between batches (divergence in another
                # code path): stale verdicts must not outlive it
                self.cache.clear()
            statistics.device_skipped += len(entries)
            for entry in entries:
                entry.result = (sat.UNKNOWN, None)
            return

        statistics.device_queries += len(entries)
        origins: set = set()
        for entry in entries:
            origins.update(entry.origins)
        if batched:
            statistics.batch_flushes += 1
            statistics.batch_flushed_queries += len(entries)
            metrics.observe("dispatch.flush.occupancy", len(entries))
            if origins:
                # fleet signal: how many contracts' queries share this
                # launch (>= 2 means the batch is genuinely merged)
                metrics.observe("dispatch.flush.contracts", len(origins))
                if len(origins) >= 2:
                    self.shared_flushes += 1
        max_steps = min(max(entry.max_conflicts for entry in entries),
                        MAX_DEVICE_STEPS)
        clause_cap = int(_settings["clause_cap"]) \
            or device_solver.DEFAULT_CLAUSE_CAP
        device = _settings["device"]
        started = time.time()
        try:
            # the span covers exactly the device launch (the flush's device
            # wall time), success or failure — the exception still propagates
            with trace.span("dispatch.flush", occupancy=len(entries),
                            batched=batched):
                resilience.fire(resilience.DEVICE)
                if len(entries) == 1:
                    entry = entries[0]
                    results = [device_solver.solve_cnf_device(
                        entry.clauses, entry.n_vars, max_steps=max_steps,
                        clause_cap=clause_cap, device=device)]
                else:
                    results = device_solver.solve_cnf_device_batch(
                        [(entry.clauses, entry.n_vars) for entry in entries],
                        max_steps=max_steps, clause_cap=clause_cap,
                        device=device)
        except Exception as error:
            if not _ladder_error(error, device):
                raise
            failure_class = resilience.classify_failure(error)
            log.warning(
                "device batch failed [%s] (%r) on %d queries — falling "
                "back to native CDCL", failure_class, error, len(entries))
            health.record_failure(failure_class, repr(error))
            statistics.device_fallbacks += len(entries)
            for entry in entries:
                entry.result = (sat.UNKNOWN, None)
            return

        elapsed = time.time() - started
        if batched:
            statistics.batch_device_time += elapsed
            metrics.observe("dispatch.flush.latency_ms", elapsed * 1000.0)
        if slog.enabled():
            # correlated flush record: the cid rides the caller's contextvar
            slog.event("dispatch.flush", occupancy=len(entries),
                       batched=batched, contracts=len(origins),
                       latency_ms=round(elapsed * 1000.0, 3))
        # wall budget per AMORTIZED query, not per batch: N queries sharing
        # one launch legitimately take up to N x the per-query budget
        overran = False
        budget_ms = resilience.device_wall_budget_ms()
        if budget_ms:
            elapsed_ms = elapsed * 1000.0
            per_query_ms = elapsed_ms / len(entries)
            if per_query_ms > budget_ms:
                overran = True
                log.warning(
                    "device batch answered but took %.0f ms for %d queries "
                    "(%.0f ms/query, budget %d ms) — recording wall_overrun",
                    elapsed_ms, len(entries), per_query_ms, budget_ms)
                health.record_failure(
                    resilience.WALL_OVERRUN,
                    f"{elapsed_ms:.0f}ms/{len(entries)} queries")

        decided_any = False
        for entry, (status, model) in zip(entries, results):
            if health.state == resilience.QUARANTINED:
                # an earlier entry in this batch diverged: the device's
                # remaining answers are untrusted — hand them to the ladder
                statistics.device_fallbacks += 1
                entry.result = (sat.UNKNOWN, None)
                continue
            if status == sat.UNKNOWN:
                statistics.device_fallbacks += 1
                entry.result = (sat.UNKNOWN, None)
                continue
            status, model = _crosscheck_device_verdict(
                entry.clauses, entry.n_vars, entry.max_conflicts, status,
                model)
            statistics.device_solved += 1
            if status != sat.UNKNOWN:
                decided_any = True
            if batched and entry.key is not None \
                    and health.state != resilience.QUARANTINED:
                self._cache_put(entry.key, status, model)
            entry.result = (status, model)
        if health.state == resilience.QUARANTINED:
            self.cache.clear()
        elif not overran and decided_any:
            health.record_success()


#: process-wide queue (solver.reset_solver_backend calls reset())
_QUEUE = DispatchQueue()

#: current query origin (a contract id): fleet mode tags every submission
#: with the analysis that produced it, so flush records can report how many
#: contracts shared one device launch. None outside fleet mode.
_QUERY_ORIGIN: Optional[str] = None


def set_query_origin(origin: Optional[str]) -> None:
    global _QUERY_ORIGIN
    _QUERY_ORIGIN = origin


def get_query_origin() -> Optional[str]:
    return _QUERY_ORIGIN


def shared_flush_count() -> int:
    """Flushes so far whose batch mixed queries from >= 2 contracts."""
    return _QUEUE.shared_flushes


def enabled() -> bool:
    """Batching on? (`--no-batch-solve` turns it off for A/B runs.)"""
    from ...support.support_args import args

    return bool(getattr(args, "batch_solve", True))


def submit(clauses: List[List[int]], n_vars: int,
           max_conflicts: int) -> QueryFuture:
    return _QUEUE.submit(clauses, n_vars, max_conflicts)


def solve(clauses: List[List[int]], n_vars: int,
          max_conflicts: int) -> Verdict:
    return _QUEUE.solve(clauses, n_vars, max_conflicts)


def flush() -> None:
    _QUEUE.flush()


def pending_count() -> int:
    return len(_QUEUE.pending)


def cached_verdicts() -> int:
    return len(_QUEUE.cache)


def reset(keep_verdicts: bool = False) -> None:
    _QUEUE.reset(keep_verdicts=keep_verdicts)


# -- verdict-cache persistence --------------------------------------------------------

def export_verdicts() -> List[list]:
    """The verdict cache as JSON-shaped entries, oldest first:
    ``[n_vars, [[lit, ...], ...], status, model-or-null]`` per entry.
    Only SAT/UNSAT ever enter the cache, so every exported entry is a
    real decision the next process can trust."""
    entries = []
    for (n_vars, clauses), (status, model) in _QUEUE.cache.items():
        entries.append([n_vars, [list(lits) for lits in clauses], status,
                        list(model) if model is not None else None])
    return entries


def _valid_entry(entry) -> Optional[Tuple[CanonicalKey, int,
                                          Optional[Tuple[bool, ...]]]]:
    """Shape-check one sidecar entry; None for anything malformed — a
    corrupt sidecar must degrade to a cold cache, never a crash."""
    try:
        n_vars, clauses, status, model = entry
        if not isinstance(n_vars, int) or isinstance(n_vars, bool) \
                or n_vars < 0:
            return None
        if status not in (sat.SAT, sat.UNSAT):
            return None
        key_clauses = []
        for lits in clauses:
            if not all(isinstance(lit, int) and not isinstance(lit, bool)
                       for lit in lits):
                return None
            key_clauses.append(tuple(lits))
        if model is not None:
            if not all(isinstance(bit, bool) for bit in model):
                return None
            model = tuple(model)
        return (n_vars, tuple(key_clauses)), status, model
    except (TypeError, ValueError):
        return None


def import_verdicts(entries: List[list]) -> int:
    """Load persisted sidecar entries into the verdict cache. In-memory
    verdicts win ties — they are at least as fresh — and malformed entries
    are skipped silently. Returns the count actually inserted."""
    loaded = 0
    for entry in entries:
        parsed = _valid_entry(entry)
        if parsed is None:
            continue
        key, status, model = parsed
        if key in _QUEUE.cache:
            continue
        _QUEUE._cache_put(key, status,
                          list(model) if model is not None else None)
        loaded += 1
    if loaded:
        metrics.inc("cache.verdict.loaded", loaded)
    return loaded
