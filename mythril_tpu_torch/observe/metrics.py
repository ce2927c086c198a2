"""Typed metrics registry: every metric the engine emits is declared here.

The port's copy of mythril_tpu/observe/metrics.py: the same names, kinds,
units and order, so that a snapshot of the port and one of the JAX
package compare key by key. Only the docs that spoke of jax or XLA are
reworded.

A metric has a name, a kind (``counter`` | ``gauge`` | ``histogram``), a
unit, and a one-line docstring; emitting an undeclared name raises
``KeyError`` at runtime.

``SolverStatistics`` (smt/solver/solver_statistics.py) is a facade over
this store: its scalar fields are properties reading/writing the
registry values, so `stats.query_count += 1` and
`metrics.value("solver.queries")` are the same number.

Counters accumulate (ints stay ints until a float lands — tests compare
with ``==``), gauges hold the last value, histograms keep
count/sum/min/max plus a bounded reservoir of recent observations and an
optional per-label breakdown (e.g. per-opcode instruction latency).

Stdlib only: tools read the snapshots it writes without importing torch.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict, List, NamedTuple, Optional

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

#: recent observations kept per histogram (aggregates are unbounded)
RESERVOIR = 4096


class MetricSpec(NamedTuple):
    """One declared metric."""

    name: str   #: dotted name, "<subsystem>.<metric>"
    kind: str   #: "counter" | "gauge" | "histogram"
    unit: str   #: "1", "s", "ms", "us", "clauses", "queries", "rows", ...
    doc: str    #: one-line description


_METRICS: List[MetricSpec] = [
    # -- solver core (SolverStatistics facade) -----------------------------------
    MetricSpec("solver.queries", COUNTER, "1",
               "Solver check() calls (stat_smt_query decorator)."),
    MetricSpec("solver.time", COUNTER, "s",
               "Cumulative wall time inside solver checks."),
    MetricSpec("solver.device.queries", COUNTER, "1",
               "Queries routed to the device SAT backend."),
    MetricSpec("solver.device.solved", COUNTER, "1",
               "Device queries decided SAT/UNSAT on device."),
    MetricSpec("solver.device.fallbacks", COUNTER, "1",
               "Device queries handed to the CDCL ladder (UNKNOWN/failure)."),
    MetricSpec("solver.last_query_clauses", GAUGE, "clauses",
               "CNF size of the most recent blasted query."),
    # -- word-level simplification (smt/solver/simplify.py) ----------------------
    MetricSpec("simplify.time", COUNTER, "s",
               "Wall time inside the word-level simplification pass."),
    MetricSpec("simplify.iterations", COUNTER, "1",
               "Fixpoint iterations across all simplification passes."),
    MetricSpec("simplify.rewrites", COUNTER, "1",
               "Total terms rewritten by the simplifier."),
    MetricSpec("simplify.const_props", COUNTER, "1",
               "Constants propagated through asserted equalities."),
    MetricSpec("simplify.keccak_rewrites", COUNTER, "1",
               "Keccak equalities decided via injectivity/disjointness."),
    MetricSpec("simplify.ite_collapses", COUNTER, "1",
               "ITE ladders folded branch-wise."),
    MetricSpec("simplify.selects_bounded", COUNTER, "1",
               "Symbolic-index selects answered by bounded enumeration."),
    MetricSpec("simplify.extract_fusions", COUNTER, "1",
               "Extract/Concat fusions and zext/sext eliminations."),
    MetricSpec("simplify.clauses_avoided", COUNTER, "clauses",
               "Estimated CNF clauses avoided by simplification."),
    # -- batched device dispatch (smt/solver/dispatch.py) ------------------------
    MetricSpec("dispatch.submitted", COUNTER, "1",
               "SAT queries submitted to the dispatch queue."),
    MetricSpec("dispatch.cache_hits", COUNTER, "1",
               "Submissions answered from the canonical-CNF verdict cache."),
    MetricSpec("dispatch.dedup_hits", COUNTER, "1",
               "Submissions merged into an identical in-flight entry."),
    MetricSpec("dispatch.flushes", COUNTER, "1",
               "Batched device flushes."),
    MetricSpec("dispatch.flushed_queries", COUNTER, "1",
               "Unique queries carried by batched flushes."),
    MetricSpec("dispatch.device_time", COUNTER, "s",
               "Wall seconds inside device batch calls."),
    MetricSpec("dispatch.flush.occupancy", HISTOGRAM, "queries",
               "Unique queries per batched device flush."),
    MetricSpec("dispatch.flush.latency_ms", HISTOGRAM, "ms",
               "Wall time of one batched device flush."),
    MetricSpec("dispatch.flush.contracts", HISTOGRAM, "contracts",
               "Distinct contracts whose queries shared one batched "
               "device flush (fleet mode tags submissions by origin; "
               ">= 2 means the batch was genuinely merged)."),
    # -- resilience / failure domains (support/resilience.py) --------------------
    MetricSpec("resilience.device_skipped", COUNTER, "1",
               "Queries skipped because a breaker was OPEN/QUARANTINED."),
    MetricSpec("resilience.breaker_trips", COUNTER, "1",
               "Circuit-breaker CLOSED->OPEN transitions."),
    MetricSpec("resilience.breaker_recoveries", COUNTER, "1",
               "Half-open probes that closed a breaker again."),
    MetricSpec("resilience.crosschecks", COUNTER, "1",
               "Device verdicts re-decided on the host oracle."),
    MetricSpec("resilience.divergences", COUNTER, "1",
               "Crosschecks where the device verdict was disproven."),
    # -- per-shape compile accounting: the JAX solver's; a CUDA kernel ----------
    # -- compiles once, so the port declares these and emits none --------------
    MetricSpec("xla.bucket_compiles", COUNTER, "1",
               "Solver runner invocations on a never-seen clause-shape "
               "bucket (pays a per-shape compile or a cache load)."),
    MetricSpec("xla.bucket_reuses", COUNTER, "1",
               "Solver runner invocations on an already-compiled bucket."),
    # -- durable warmth caches (kernels/build.py, serve/warmset.py) --------------
    MetricSpec("cache.exec.hits", COUNTER, "1",
               "Shape buckets warmed by deserializing a persisted "
               "executable instead of compiling."),
    MetricSpec("cache.exec.misses", COUNTER, "1",
               "Shape buckets that compiled because no usable persisted "
               "executable existed (then serialized for next spawn)."),
    MetricSpec("cache.exec.deserialize_ms", HISTOGRAM, "ms",
               "Wall time to load + deserialize one persisted solver "
               "executable."),
    MetricSpec("cache.verdict.loaded", COUNTER, "1",
               "Verdict-cache entries loaded from the persisted sidecar "
               "at spawn/warmup."),
    MetricSpec("cache.verdict.merged", COUNTER, "1",
               "In-memory verdicts union-merged into the sidecar at "
               "save time."),
    MetricSpec("cache.verdict.evicted", COUNTER, "1",
               "Sidecar verdict entries evicted by the "
               "MYTHRIL_TPU_VERDICT_SIDECAR_MAX bound."),
    # -- content-addressed result store (serve/result_store.py) ------------------
    MetricSpec("cache.result.hits", COUNTER, "1",
               "Analyze requests answered from the content-addressed "
               "result store at admission (zero worker dispatches)."),
    MetricSpec("cache.result.misses", COUNTER, "1",
               "Analyze requests whose (bytecode, config) key was not "
               "in the result store."),
    MetricSpec("cache.result.stored", COUNTER, "1",
               "Complete analysis payloads persisted into the result "
               "store (incomplete and quarantined results are never "
               "cached)."),
    MetricSpec("cache.result.evicted", COUNTER, "1",
               "Result-store entries evicted by the "
               "MYTHRIL_TPU_RESULT_STORE_MAX bound."),
    # -- device frontier (parallel/frontier.py) ----------------------------------
    MetricSpec("frontier.chunks", COUNTER, "1",
               "Fused lockstep chunks dispatched to the device."),
    MetricSpec("frontier.cold_sloads", COUNTER, "1",
               "Lanes paused on a cold SLOAD serviced by the host."),
    MetricSpec("frontier.drain.rows", HISTOGRAM, "rows",
               "Escape rows fetched per bulk host drain."),
    # -- device-resident frontier telemetry plane (parallel/symstep.py) ----------
    MetricSpec("frontier.telemetry.executed", COUNTER, "1",
               "Instruction-states stepped on device, decoded from the "
               "in-kernel opcode-class histogram."),
    MetricSpec("frontier.telemetry.forks", COUNTER, "1",
               "On-device JUMPI forks (lane claims + DFS-stack pushes + "
               "escape-buffer spills)."),
    MetricSpec("frontier.telemetry.escapes", COUNTER, "1",
               "Lanes that escaped to the host (buffered + frozen)."),
    MetricSpec("frontier.telemetry.reseeds", COUNTER, "1",
               "DEAD lanes reseeded from the device sibling stack."),
    MetricSpec("frontier.telemetry.deaths", COUNTER, "1",
               "Lanes killed on device (error exits + arena-overflow "
               "guards + invalid jump destinations)."),
    MetricSpec("frontier.telemetry.cold_sload_pauses", COUNTER, "1",
               "Lane pauses at a cold SLOAD counted in-kernel (the host "
               "service itself counts frontier.cold_sloads)."),
    MetricSpec("frontier.telemetry.occupancy", GAUGE, "lanes",
               "Mean running lanes per fused step, this device phase."),
    MetricSpec("frontier.telemetry.stack_hwm", GAUGE, "rows",
               "DFS sibling-stack depth high-water, this device phase."),
    MetricSpec("frontier.telemetry.esc_hwm", GAUGE, "rows",
               "Escape-buffer occupancy high-water, this device phase."),
    MetricSpec("frontier.telemetry.stack_bytes", GAUGE, "bytes",
               "DFS sibling-stack HBM bytes at the high-water mark "
               "(stack_hwm x packed row bytes), this device phase."),
    MetricSpec("frontier.telemetry.esc_bytes", GAUGE, "bytes",
               "Escape-buffer HBM bytes at the high-water mark "
               "(esc_hwm x packed row bytes), this device phase."),
    MetricSpec("frontier.telemetry.arena_bytes", GAUGE, "bytes",
               "Constraint-arena HBM bytes live on device (allocated "
               "nodes x per-node bytes), this device phase."),
    MetricSpec("frontier.telemetry.op_class", HISTOGRAM, "1",
               "Per-chunk executed instructions by opcode class "
               "(label = class, symstep.OP_CLASS_NAMES)."),
    MetricSpec("frontier.telemetry.esc_cause", HISTOGRAM, "1",
               "Per-chunk lane escapes by cause "
               "(label = cause, symstep.ESC_CAUSE_NAMES)."),
    MetricSpec("frontier.telemetry.lifecycle", HISTOGRAM, "1",
               "Per-chunk lane lifecycle transitions "
               "(label = transition, symstep.LIFECYCLE_NAMES)."),
    MetricSpec("frontier.telemetry.tag_occupancy", HISTOGRAM, "1",
               "Per-chunk running-lane-steps at tagged merge-point / "
               "loop-header pcs (label = merge@pc / loop@pc)."),
    # -- fleet packing (parallel/frontier.py FleetDriver) ------------------------
    MetricSpec("frontier.fleet.contracts", GAUGE, "contracts",
               "Contracts packed into the in-flight fleet frontier."),
    MetricSpec("frontier.fleet.lane_steps", HISTOGRAM, "1",
               "Per-chunk running-lane-steps per packed contract "
               "(label = contract id; the fairness signal)."),
    MetricSpec("frontier.fleet.drained", COUNTER, "lanes",
               "Lanes killed by the per-contract deadline drain (the "
               "owning contract's budget expired; lanes freed for the "
               "others)."),
    MetricSpec("frontier.fleet.phases", COUNTER, "1",
               "Shared device phases run by the fleet driver."),
    # -- mesh-sharded fleet (parallel/frontier.py shard block + steal pass) ------
    MetricSpec("frontier.shard.devices", GAUGE, "shards",
               "Logical shard blocks the fleet frontier is split into "
               "(lane-axis blocks with per-block scheduler segments)."),
    MetricSpec("frontier.shard.occupancy", HISTOGRAM, "lanes",
               "Per-shard running-lane count per chunk (label = dev<i>; "
               "the balance signal the steal pass acts on)."),
    MetricSpec("frontier.shard.steals_sent", HISTOGRAM, "rows",
               "Pending-pool rows donated per shard by the device-"
               "resident steal pass (label = dev<i>)."),
    MetricSpec("frontier.shard.steals_received", HISTOGRAM, "rows",
               "Pending-pool rows adopted per shard from steal passes "
               "(label = dev<i>)."),
    MetricSpec("frontier.shard.steal_rows", COUNTER, "rows",
               "Total pending-pool rows moved between shards by steal "
               "passes."),
    MetricSpec("frontier.shard.steal_passes", COUNTER, "1",
               "Device-resident steal passes dispatched (cadenced; the "
               "pass itself decides on device whether rows move)."),
    MetricSpec("frontier.shard.imbalance", GAUGE, "rows",
               "Last chunk's max-min per-shard load gap (running lanes "
               "+ pending rows)."),
    MetricSpec("frontier.shard.fairness", GAUGE, "1",
               "Jain fairness index of per-shard load, last chunk (1.0 "
               "= perfectly balanced)."),
    # -- on-device state merging (parallel/symstep.py merge_pass) ----------------
    MetricSpec("frontier.merge.passes", COUNTER, "1",
               "Merge-pass invocations dispatched to the device "
               "(telemetry-triggered or fixed-cadence)."),
    MetricSpec("frontier.merge.events", COUNTER, "1",
               "Sibling-lane pairs collapsed into one ITE-blended lane "
               "(each event drops one path condition and retires one "
               "lane)."),
    MetricSpec("frontier.merge.lanes_retired", COUNTER, "1",
               "Device lanes freed by state merging (DEAD, reclaimable "
               "by forks and reseeds)."),
    MetricSpec("frontier.merge.ites", COUNTER, "1",
               "Arena ITE nodes allocated to blend differing stack / "
               "storage slots across merged pairs."),
    MetricSpec("frontier.merge.tag_merges", HISTOGRAM, "1",
               "Merge events by post-dominator merge tag (label = "
               "merge@pc; 'untagged' = reconvergence past any tagged "
               "pc)."),
    MetricSpec("frontier.merge.ite_depth", HISTOGRAM, "1",
               "Merge events by blended-slot count per pair (label = "
               "bucket, symstep.MERGE_DEPTH_LABELS)."),
    MetricSpec("frontier.merge.blocked_by.memory", COUNTER, "1",
               "Otherwise-mergeable sibling pairs blocked because their "
               "concrete memory planes diverge outside any statically "
               "proven join region (ROADMAP item 4 gate sizing)."),
    MetricSpec("frontier.merge.blocked_by.mem_sym", COUNTER, "1",
               "Otherwise-mergeable sibling pairs blocked because "
               "diverged memory bytes carry symbolic-word encodings the "
               "window blend cannot ITE (dirty/partial symbolic words)."),
    MetricSpec("frontier.merge.blocked_by.storage_keys", COUNTER, "1",
               "Otherwise-mergeable sibling pairs blocked because their "
               "storage key sets differ (the blend covers values, not "
               "key-set shape)."),
    MetricSpec("frontier.merge.blocked_by.tstore", COUNTER, "1",
               "Otherwise-mergeable sibling pairs blocked because their "
               "transient-storage planes differ."),
    MetricSpec("frontier.merge.blocked_by.depth", COUNTER, "1",
               "Same-pc sibling pairs blocked because their path "
               "conditions differ beyond the final fork (different conds "
               "depths / prefixes — the partial-prefix merging gap)."),
    # -- checkpoints (support/checkpoint.py, parallel/frontier.py) ---------------
    MetricSpec("checkpoint.saves", COUNTER, "1",
               "Crash-safe checkpoint writes (host pickle + device npz)."),
    MetricSpec("checkpoint.write_ms", HISTOGRAM, "ms",
               "Wall time of one checkpoint write."),
    # -- static control-flow analysis (mythril_tpu/staticanalysis/) --------------
    MetricSpec("cfa.blocks", COUNTER, "1",
               "Basic blocks recovered by cfa builds."),
    MetricSpec("cfa.jumps_resolved", COUNTER, "1",
               "Jump sites whose targets the cfa dataflow pinned."),
    MetricSpec("cfa.jumps_unresolved", COUNTER, "1",
               "Jump sites left with conservative fan-out edges."),
    MetricSpec("cfa.merge_points", COUNTER, "1",
               "Post-dominator merge points found at branch sites."),
    MetricSpec("cfa.dead_bytes", COUNTER, "bytes",
               "Code bytes proven statically unreachable."),
    MetricSpec("cfa.screen.answered", COUNTER, "1",
               "Jump-validity queries answered from the CFA tables "
               "instead of dynamic instruction-list checks."),
    MetricSpec("cfa.screen.infeasible", COUNTER, "1",
               "Jump targets the screen proved invalid, pruning the "
               "branch before any solver work."),
    MetricSpec("cfa.frontier.merge_tagged", COUNTER, "1",
               "Materialized device lanes tagged with the merge pc "
               "their block reconverges at (groundwork for on-device "
               "state merging)."),
    MetricSpec("cfa.frontier.prefetch_skipped", COUNTER, "1",
               "Feasibility prefetches skipped for statically dead or "
               "invalid target pcs."),
    # -- source->sink taint analysis (staticanalysis/taint.py) -------------------
    MetricSpec("taint.functions", COUNTER, "1",
               "Public functions recovered from the dispatcher idiom by "
               "taint-summary builds (fallback partition included)."),
    MetricSpec("taint.loops", COUNTER, "1",
               "Natural loops (back edges over the dominator tree) found "
               "by taint-summary builds."),
    MetricSpec("taint.screen.modules_skipped", COUNTER, "1",
               "Detection modules skipped wholesale because none of "
               "their hook opcodes appear in reachable code."),
    MetricSpec("taint.screen.sites_skipped", COUNTER, "1",
               "Pre-hook firings skipped because the summary proves the "
               "module's sink operands untainted at that pc."),
    MetricSpec("taint.frontier.loop_tagged", COUNTER, "1",
               "Materialized device lanes tagged with the natural-loop "
               "header their pc sits inside (bounded-unroll budgeting)."),
    # -- value-range / memory-region absint (staticanalysis/absint.py) -----------
    MetricSpec("absint.build_ms", HISTOGRAM, "ms",
               "Wall time of one value-range/memory-region fixpoint "
               "build (staticanalysis/absint.py)."),
    MetricSpec("absint.widenings", COUNTER, "1",
               "Interval widenings applied at loop headers (and "
               "slow-converging joins) across absint builds."),
    MetricSpec("absint.regions_proven", COUNTER, "1",
               "Post-dominator join points whose diamond memory writes "
               "the absint pass bounded to finite byte regions."),
    MetricSpec("absint.merge.mem_blends", COUNTER, "1",
               "32-byte memory words ITE-blended by the widened merge "
               "phase (pairs that the identical-memory gate alone would "
               "have blocked)."),
    MetricSpec("absint.screen.range_answered", COUNTER, "1",
               "JUMPI sites answered from the interval tables (provably "
               "constant conditions — the infeasible side is dropped "
               "before any constraint or solver work)."),
    MetricSpec("absint.loop_bounds_applied", COUNTER, "1",
               "Loop-header budget decisions where a statically proven "
               "trip-count bound replaced the flat loop_bound default."),
    # -- gas superoptimization (mythril_tpu/superopt/) ----------------------------
    MetricSpec("superopt.blocks_scanned", COUNTER, "1",
               "CFA basic blocks walked by the superoptimizer (eligible "
               "or not)."),
    MetricSpec("superopt.candidates", COUNTER, "1",
               "Candidate rewrites that survived screening and became "
               "equivalence obligations."),
    MetricSpec("superopt.search_sequences", COUNTER, "1",
               "Sequences tried by the exhaustive stack-scheduling "
               "search (bounded by MYTHRIL_TPU_SUPEROPT_CANDIDATES)."),
    MetricSpec("superopt.proofs_syntactic", COUNTER, "1",
               "Obligations whose miter constant-folded to FALSE "
               "(equivalence proven without a SAT query)."),
    MetricSpec("superopt.proofs_unsat", COUNTER, "1",
               "Equivalence obligations proven UNSAT (rewrite accepted)."),
    MetricSpec("superopt.proofs_sat", COUNTER, "1",
               "Obligations decided SAT (a distinguishing entry state "
               "exists; rewrite rejected)."),
    MetricSpec("superopt.proofs_unknown", COUNTER, "1",
               "Obligations still UNKNOWN after the fallback ladder "
               "(rewrite conservatively rejected)."),
    MetricSpec("superopt.gas_saved", COUNTER, "gas",
               "Static gas saved by accepted rewrites, loop-bound "
               "weighted where absint proved a trip count."),
    MetricSpec("superopt.proof_flush.occupancy", HISTOGRAM, "queries",
               "Equivalence obligations carried per batched proof "
               "flush through the dispatch queue."),
    MetricSpec("superopt.crosschecks", COUNTER, "1",
               "Sampled accepted proofs re-decided on the host CDCL "
               "oracle (MYTHRIL_TPU_SUPEROPT_CROSSCHECK)."),
    MetricSpec("superopt.crosscheck_divergence", COUNTER, "1",
               "Crosschecks where the host oracle disagreed with the "
               "accepted verdict (must stay zero)."),
    # -- device memory accounting (observe/export.py, sampled at scrape) ---------
    MetricSpec("device.hbm.bytes_in_use", GAUGE, "bytes",
               "Live HBM bytes across visible devices (torch.cuda "
               "memory_stats), sampled host-side at scrape/snapshot "
               "time — never inside the chunk loop."),
    MetricSpec("device.hbm.peak_bytes", GAUGE, "bytes",
               "Peak HBM bytes across visible devices since process "
               "start (torch.cuda memory_stats allocated peak)."),
    # -- analysis service (mythril_tpu/serve/) -----------------------------------
    MetricSpec("serve.requests", COUNTER, "1",
               "Requests the analysis service answered (ok, error, or "
               "busy bounce)."),
    MetricSpec("serve.request_errors", COUNTER, "1",
               "Requests answered with an error reply (malformed input, "
               "failed analysis, unknown op)."),
    MetricSpec("serve.busy_rejections", COUNTER, "1",
               "Requests bounced with `busy` because the in-flight bound "
               "(MYTHRIL_TPU_SERVE_MAX_INFLIGHT) was reached."),
    MetricSpec("serve.warmed_buckets", COUNTER, "1",
               "Clause-shape buckets pre-compiled by the AOT warmup "
               "phase at daemon startup."),
    MetricSpec("serve.summary_seeded", COUNTER, "1",
               "Analysis requests whose contract taint summary was "
               "pre-seeded from the warmset summary store instead of "
               "rebuilt."),
    MetricSpec("serve.request_ms", HISTOGRAM, "ms",
               "Wall time of one analysis request, warmup excluded."),
    MetricSpec("serve.metrics_scrapes", COUNTER, "1",
               "Metrics scrapes answered (GET /metrics or the `metrics` "
               "protocol op); never takes the engine lock."),
    MetricSpec("serve.fleet.batched", COUNTER, "1",
               "Analysis requests that joined a fleet micro-batch "
               "instead of queueing on the engine lock."),
    MetricSpec("serve.fleet.windows", COUNTER, "1",
               "Fleet micro-batch windows closed (one shared fleet run "
               "each, leader request included)."),
    MetricSpec("serve.fleet.preempted", COUNTER, "1",
               "Bulk fleet-batch members preempted mid-flight by an "
               "interactive arrival: deadline-drained to their "
               "namespaced checkpoint and re-enqueued, never aborted."),
    # -- overload resilience (serve/admission.py, serve/autoscale.py) ------------
    MetricSpec("serve.queue.depth", GAUGE, "requests",
               "Requests waiting in the bounded priority admission "
               "queue (both classes), sampled at every transition."),
    MetricSpec("serve.queue.wait_ms", HISTOGRAM, "ms",
               "Admission-queue wait from enqueue to execution grant "
               "(label = priority class)."),
    MetricSpec("serve.shed.overload", COUNTER, "1",
               "Requests shed with a typed `overloaded` error because "
               "the admission queue passed its high-water mark."),
    MetricSpec("serve.shed.deadline", COUNTER, "1",
               "Requests rejected at admission by deadline triage: the "
               "deadline could not be met given queue depth x observed "
               "p95 service time."),
    MetricSpec("serve.shed.by_class", HISTOGRAM, "1",
               "Shed/triaged requests by priority class (label = "
               "interactive / bulk; the load harness asserts the "
               "interactive count stays zero)."),
    MetricSpec("serve.drain.shed", COUNTER, "1",
               "Queued requests shed with `shutting_down` by the "
               "graceful drain at shutdown."),
    MetricSpec("serve.autoscale.target", GAUGE, "workers",
               "Worker count the autoscaler currently wants (between "
               "MYTHRIL_TPU_SERVE_WORKERS_MIN and _MAX)."),
    MetricSpec("serve.autoscale.scale_ups", COUNTER, "1",
               "Autoscaler scale-up events (sustained backlog grew the "
               "pool by one warm worker)."),
    MetricSpec("serve.autoscale.scale_downs", COUNTER, "1",
               "Autoscaler scale-down events (sustained idle retired "
               "one worker)."),
    # -- serve worker-process pool (mythril_tpu/serve/supervisor.py) -------------
    MetricSpec("serve.worker.spawns", COUNTER, "1",
               "Worker processes spawned by the serve supervisor "
               "(initial pool fill plus every restart)."),
    MetricSpec("serve.worker.restarts", COUNTER, "1",
               "Worker processes respawned after a death (exponential "
               "per-slot backoff)."),
    MetricSpec("serve.worker.deaths", HISTOGRAM, "1",
               "Worker-process deaths by failure class (label = "
               "worker_segv / worker_hang / worker_oom / worker_crash; "
               "exit-status or heartbeat-timeout classified)."),
    MetricSpec("serve.worker.retries", COUNTER, "1",
               "Victim requests retried once on a fresh worker after a "
               "worker death (checkpoint resume or host-ladder restart)."),
    MetricSpec("serve.worker.quarantined", COUNTER, "1",
               "Contracts newly recorded as poison in the quarantine "
               "sidecar (crashed MYTHRIL_TPU_SERVE_QUARANTINE_AFTER "
               "workers)."),
    MetricSpec("serve.worker.quarantine_refusals", COUNTER, "1",
               "Analyze requests refused with a `quarantined` error "
               "because their bytecode hash is in the poison sidecar."),
    MetricSpec("serve.worker.pool", GAUGE, "workers",
               "Live worker processes in the serve supervisor pool."),
    # -- engine plugins (core/plugin/plugins/) -----------------------------------
    MetricSpec("profiler.instruction_us", HISTOGRAM, "us",
               "Per-opcode host-engine instruction latency "
               "(label = opcode; instruction-profiler plugin)."),
    MetricSpec("bench.instructions", COUNTER, "1",
               "Instructions executed under the benchmark plugin."),
    MetricSpec("bench.states_per_sec", GAUGE, "states/s",
               "Benchmark plugin throughput at stop_sym_exec."),
]

REGISTRY: Dict[str, MetricSpec] = {spec.name: spec for spec in _METRICS}


def declared(name: str) -> bool:
    """True when `name` is a registered metric."""
    return name in REGISTRY


def _spec(name: str, *kinds: str) -> MetricSpec:
    spec = REGISTRY[name]  # KeyError on undeclared names is the contract
    if kinds and spec.kind not in kinds:
        raise TypeError(
            f"{name} is declared as {spec.kind!r}, not {'/'.join(kinds)!r}")
    return spec


#: quantiles surfaced by as_dict()/snapshot()/the Prometheus exporter
QUANTILES = ((0.5, "p50"), (0.95, "p95"), (0.99, "p99"))


class _Hist:
    """Histogram state: aggregates + bounded reservoir."""

    __slots__ = ("count", "total", "min", "max", "recent")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.recent = deque(maxlen=RESERVOIR)

    def add(self, value: float) -> None:
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        self.recent.append(value)

    @property
    def dropped(self) -> int:
        """Observations that fell out of the bounded reservoir: count
        minus what ``recent`` still holds. Non-zero means quantiles are
        biased toward the *most recent* RESERVOIR observations — the
        aggregates (count/sum/min/max) stay exact."""
        return self.count - len(self.recent)

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile over the bounded reservoir (0 when
        nothing was observed). ``q`` in [0, 1]; q=0 is the reservoir
        min, q=1 the reservoir max. When ``dropped`` is non-zero this
        is a recency-biased estimate, not the lifetime quantile."""
        if not self.recent:
            return 0.0
        ordered = sorted(self.recent)
        if q <= 0.0:
            return ordered[0]
        if q >= 1.0:
            return ordered[-1]
        rank = int(math.ceil(q * len(ordered))) - 1
        return ordered[max(0, min(rank, len(ordered) - 1))]

    def as_dict(self) -> dict:
        if not self.count:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "avg": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
        out = {"count": self.count, "sum": self.total, "min": self.min,
               "max": self.max, "avg": self.total / self.count}
        for q, key in QUANTILES:
            out[key] = self.quantile(q)
        if self.dropped:
            # drop accounting: snapshots must say when the quantiles
            # cover a recency-biased window, not the whole run
            out["reservoir_dropped"] = self.dropped
        return out


class _Store:
    """Process-wide metric values (single store, like SolverStatistics)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.scalars: Dict[str, float] = {}
        #: name -> label -> _Hist ("" = unlabeled)
        self.hists: Dict[str, Dict[str, _Hist]] = {}


_STORE = _Store()


def inc(name: str, value=1) -> None:
    """Add `value` to a declared counter."""
    _spec(name, COUNTER)
    with _STORE.lock:
        _STORE.scalars[name] = _STORE.scalars.get(name, 0) + value


def set_gauge(name: str, value) -> None:
    """Set a declared gauge to `value`."""
    _spec(name, GAUGE)
    with _STORE.lock:
        _STORE.scalars[name] = value


def observe(name: str, value, label: str = "") -> None:
    """Record one observation on a declared histogram (optionally under a
    label, e.g. an opcode name)."""
    _spec(name, HISTOGRAM)
    with _STORE.lock:
        by_label = _STORE.hists.setdefault(name, {})
        hist = by_label.get(label)
        if hist is None:
            hist = by_label[label] = _Hist()
        hist.add(value)


def value(name: str):
    """Current value of a declared counter or gauge (0 when never set)."""
    _spec(name, COUNTER, GAUGE)
    return _STORE.scalars.get(name, 0)


def set_value(name: str, new_value) -> None:
    """Absolute assignment on a counter or gauge — the facade-property
    write path (``stats.query_count = 0``). Dynamic-name API: rule R6
    only audits literal emissions through inc/set_gauge/observe."""
    _spec(name, COUNTER, GAUGE)
    with _STORE.lock:
        _STORE.scalars[name] = new_value


def histogram(name: str, label: str = "") -> Optional[_Hist]:
    """The _Hist for (name, label), or None when nothing was observed."""
    _spec(name, HISTOGRAM)
    return _STORE.hists.get(name, {}).get(label)


def labels(name: str) -> List[str]:
    """Labels observed on a declared histogram."""
    _spec(name, HISTOGRAM)
    return sorted(_STORE.hists.get(name, {}))


def quantile(name: str, q: float, label: str = "") -> float:
    """Nearest-rank quantile of a declared histogram's reservoir (0.0
    when nothing was observed) — the read path the Prometheus exporter,
    bench extras, and traceview's serve rollup share."""
    hist = histogram(name, label)
    if hist is None:
        return 0.0
    return hist.quantile(q)


def snapshot() -> dict:
    """Every declared metric's current state, JSON-shaped (run manifests,
    bench extras, traceview)."""
    out: Dict[str, object] = {}
    with _STORE.lock:
        for spec in _METRICS:
            if spec.kind == HISTOGRAM:
                by_label = _STORE.hists.get(spec.name)
                if not by_label:
                    continue
                if set(by_label) == {""}:
                    out[spec.name] = by_label[""].as_dict()
                else:
                    out[spec.name] = {label: hist.as_dict()
                                      for label, hist in
                                      sorted(by_label.items())}
            else:
                raw = _STORE.scalars.get(spec.name, 0)
                if raw:
                    out[spec.name] = raw
    return out


def reset(prefix: str = "") -> None:
    """Zero every metric whose name starts with `prefix` ("" = all).
    SolverStatistics.reset() clears its own subsystems; plugins clear
    theirs at initialize()."""
    with _STORE.lock:
        for name in list(_STORE.scalars):
            if name.startswith(prefix):
                _STORE.scalars[name] = 0
        for name in list(_STORE.hists):
            if name.startswith(prefix):
                del _STORE.hists[name]


def write_snapshot(path: str) -> str:
    """Write :func:`snapshot` as JSON, fsync-atomically (tmp + fsync +
    rename, the support/checkpoint.py discipline — a crash mid-write must
    never leave a truncated snapshot where bench/frontierview will read
    it). Stdlib-only like the rest of this module; returns `path`."""
    import json
    import os

    payload = json.dumps(snapshot(), indent=2, sort_keys=True, default=str)
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as handle:
        handle.write(payload + "\n")
        handle.flush()
        os.fsync(handle.fileno())
    os.replace(tmp, path)
    directory = os.path.dirname(os.path.abspath(path))
    try:
        dir_fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return path  # platform without directory fds: rename is done
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)
    return path


def render_markdown_table() -> str:
    """The declared-metrics table (README "Observability" section)."""
    lines = [
        "| Metric | Kind | Unit | Meaning |",
        "| --- | --- | --- | --- |",
    ]
    for spec in _METRICS:
        lines.append(f"| `{spec.name}` | {spec.kind} | {spec.unit} "
                     f"| {spec.doc} |")
    return "\n".join(lines)


if __name__ == "__main__":
    print(render_markdown_table())
