"""The port's observability (mythril_tpu_torch/observe/) on the cases of
tests/test_observe.py and tests/test_export.py: the span tracer (Perfetto
export, the disabled fast path, the ring buffer's drop accounting), the
typed metric registry (the declared-name contract, counters, gauges,
histograms, snapshots), the SolverStatistics facade, the Prometheus
exposition, the snapshot ring, the CUDA memory gauges and the structured
log. The cases that set a MYTHRIL_TPU_* knob in the JAX package's files
are cases of `enable(...)` and keyword arguments here: the port reads no
knob. Beside them: the registry declares the JAX package's metrics (name,
kind, unit) in its order, and `collect_device_memory` returns {} without
CUDA."""

import json
import os
import re

import pytest
import torch

from mythril_tpu.observe import metrics as jmetrics
from mythril_tpu_torch.observe import export, metrics, slog, trace
from mythril_tpu_torch.smt.solver.solver_statistics import (FACADE_METRICS,
                                                            PORT_COUNTERS,
                                                            SolverStatistics,
                                                            stat_smt_query)


@pytest.fixture(autouse=True)
def _clean_observability():
    """Tracer, slog, ring and metric store are process singletons: every
    test starts and ends from the never-touched state."""
    trace.reset()
    slog.reset()
    export.reset_ring()
    metrics.reset()
    SolverStatistics().reset()
    yield
    trace.reset()
    slog.reset()
    export.reset_ring()
    metrics.reset()
    SolverStatistics().reset()


def test_registry_is_the_jax_registry():
    """Name, kind and unit of every declared metric, in order: snapshots
    of the two packages compare key by key."""
    assert [(spec.name, spec.kind, spec.unit) for spec in metrics._METRICS] \
        == [(spec.name, spec.kind, spec.unit) for spec in jmetrics._METRICS]
    assert metrics.QUANTILES == jmetrics.QUANTILES
    assert metrics.RESERVOIR == jmetrics.RESERVOIR


def test_registry_is_live_from_import():
    """Always live, as the JAX package's is: no enable step."""
    metrics.inc("frontier.chunks")
    assert metrics.snapshot() == {"frontier.chunks": 1}


def test_collect_device_memory_is_empty_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert export.collect_device_memory() == {}
    assert metrics.value("device.hbm.bytes_in_use") == 0

    def broken():
        raise RuntimeError("no driver")

    monkeypatch.setattr(torch.cuda, "is_available", broken)
    assert export.collect_device_memory() == {}


def test_port_counters_stay_off_the_registry():
    """The port's own two solver counters are plain attributes: the
    registry declares only the JAX package's names."""
    stats = SolverStatistics()
    for counter in PORT_COUNTERS:
        assert not metrics.declared("resilience." + counter)
        setattr(stats, counter, getattr(stats, counter) + 2)
    stats.reset()
    assert all(getattr(stats, counter) == 0 for counter in PORT_COUNTERS)
    assert metrics.snapshot() == {}


# -- tracer: disabled fast path ------------------------------------------------------


def test_disabled_span_is_one_shared_null_object():
    """The disabled-mode contract: no event, no timestamp, no per-call
    allocation — every call site gets the SAME null span."""
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b", attr=1)
    with trace.span("c") as sp:
        assert sp.set(x=1) is sp  # .set is a chainable no-op


def test_disabled_decorator_and_instant_are_noops():
    calls = []

    @trace.traced("never.recorded")
    def work(x):
        calls.append(x)
        return x * 2

    assert work(21) == 42
    trace.instant("never.recorded")
    assert calls == [21]
    assert trace.export() is None  # disabled export: no path, no file


def test_decorator_sees_tracer_enabled_after_definition(tmp_path):
    """The enabled check is per CALL: functions decorated at import time
    still record once the tracer turns on later."""

    @trace.traced("late.bind")
    def work():
        return 7

    work()  # disabled: nothing recorded
    out = str(tmp_path / "late.json")
    trace.enable(out)
    work()
    doc = json.load(open(trace.export()))
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
    assert names == ["late.bind"]


# -- tracer: recording + export ------------------------------------------------------


def test_export_is_valid_perfetto_trace_event_json(tmp_path):
    out = str(tmp_path / "trace.json")
    trace.enable(out)
    with trace.span("svm.tx", index=0):
        with trace.span("dispatch.flush", occupancy=4) as flush:
            flush.set(decided=3)
    trace.instant("resilience.breaker_trip", backend="device")
    trace.set_manifest(backend="cpu", argv="pytest")
    assert trace.export() == out

    doc = json.load(open(out))
    assert set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}
    events = doc["traceEvents"]
    # process/thread metadata present
    meta = [e for e in events if e["ph"] == "M"]
    assert {"process_name", "thread_name"} <= {e["name"] for e in meta}
    # X events carry numeric ts/dur in us, a cat, and pid/tid
    spans = [e for e in events if e["ph"] == "X"]
    assert [e["name"] for e in spans] == ["dispatch.flush", "svm.tx"]
    for event in spans:
        assert isinstance(event["ts"], (int, float))
        assert isinstance(event["dur"], (int, float))
        assert event["cat"] == event["name"].split(".", 1)[0]
        assert "pid" in event and "tid" in event
    flush_event, tx_event = spans
    assert flush_event["args"] == {"occupancy": 4, "decided": 3}
    # nesting: the inner span lies within the outer one
    assert tx_event["ts"] <= flush_event["ts"]
    assert flush_event["ts"] + flush_event["dur"] \
        <= tx_event["ts"] + tx_event["dur"] + 1e-3
    # instants are thread-scoped
    instants = [e for e in events if e["ph"] == "i"]
    assert len(instants) == 1
    assert instants[0]["s"] == "t"
    assert instants[0]["args"]["backend"] == "device"
    # manifest + accounting
    assert doc["otherData"]["backend"] == "cpu"
    assert doc["otherData"]["dropped_events"] == 0
    assert doc["otherData"]["total_events"] == 3


def test_counter_track_emission(tmp_path):
    """'C' counter samples: each kwarg is one series on the named track —
    ts + args only (no dur, no instant scope), the shape Perfetto renders
    as counter tracks and tools/frontierview.py sums per chunk."""
    out = str(tmp_path / "counters.json")
    trace.enable(out)
    trace.counter("frontier.lanes", running=14, stack=2, escaped=0)
    trace.counter("frontier.lanes", running=9, stack=5, escaped=4)
    trace.counter("frontier.arena", nodes=12)
    doc = json.load(open(trace.export()))
    counters = [e for e in doc["traceEvents"] if e["ph"] == "C"]
    assert [e["name"] for e in counters] == [
        "frontier.lanes", "frontier.lanes", "frontier.arena"]
    for event in counters:
        assert isinstance(event["ts"], (int, float))
        assert "dur" not in event and "s" not in event
        assert event["cat"] == "frontier"
    assert counters[0]["args"] == {"running": 14, "stack": 2, "escaped": 0}
    assert counters[1]["args"] == {"running": 9, "stack": 5, "escaped": 4}
    assert counters[2]["args"] == {"nodes": 12}
    # samples on the same track are time-ordered
    assert counters[0]["ts"] <= counters[1]["ts"]


def test_counter_is_noop_when_disabled():
    assert not trace.enabled()
    trace.counter("frontier.lanes", running=1)  # must not raise or record
    assert trace.export() is None


def test_enable_starts_the_tracer_and_no_knob_does(tmp_path, monkeypatch):
    """The JAX package's MYTHRIL_TPU_TRACE enables its tracer at first
    use; the port's reads no knob: only `enable(path)` starts it."""
    out = str(tmp_path / "enabled.json")
    monkeypatch.setenv("MYTHRIL_TPU_TRACE", str(tmp_path / "knob.json"))
    trace.reset()
    with trace.span("svm.tx"):
        pass
    assert not trace.enabled() and trace.out_path() is None
    trace.enable(out)
    with trace.span("svm.tx"):
        pass
    assert trace.enabled()
    assert trace.out_path() == out
    assert trace.export() == out
    assert os.path.exists(out)
    assert not os.path.exists(str(tmp_path / "knob.json"))


def test_ring_buffer_drops_oldest_and_counts_them(tmp_path):
    out = str(tmp_path / "drop.json")
    trace.enable(out, buffer_events=64)  # clamps to 1024
    for i in range(1500):
        with trace.span("tiny.span", i=i):
            pass
    doc = json.load(open(trace.export()))
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(spans) == 1024
    assert doc["otherData"]["total_events"] == 1500
    assert doc["otherData"]["dropped_events"] == 1500 - 1024
    # the oldest events dropped: the survivors are the most recent ones
    assert spans[0]["args"]["i"] == 1500 - 1024


def test_export_overwrites_atomically_and_is_idempotent(tmp_path):
    out = str(tmp_path / "twice.json")
    trace.enable(out)
    with trace.span("a.one"):
        pass
    trace.export()
    with trace.span("a.two"):
        pass
    doc = json.load(open(trace.export()))
    assert [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"] \
        == ["a.one", "a.two"]
    assert not os.path.exists(out + ".tmp")


# -- metrics registry ----------------------------------------------------------------


def test_undeclared_metric_is_loud():
    # dynamic names on purpose: R6 would (rightly) flag these as literals
    undeclared = "solver.not_a_metric"
    with pytest.raises(KeyError):
        metrics.inc(undeclared)
    with pytest.raises(KeyError):
        metrics.set_gauge(undeclared, 1)
    with pytest.raises(KeyError):
        metrics.observe(undeclared, 1.0)
    with pytest.raises(KeyError):
        metrics.value(undeclared)


def test_kind_mismatch_is_loud():
    with pytest.raises(TypeError):
        metrics.inc("dispatch.flush.occupancy")  # histogram, not counter
    with pytest.raises(TypeError):
        metrics.set_gauge("solver.queries", 3)  # counter, not gauge
    with pytest.raises(TypeError):
        metrics.observe("solver.queries", 3)  # counter, not histogram
    with pytest.raises(TypeError):
        metrics.value("dispatch.flush.occupancy")  # histograms have no value


def test_counters_stay_int_until_a_float_lands():
    metrics.inc("solver.queries")
    metrics.inc("solver.queries", 2)
    assert metrics.value("solver.queries") == 3
    assert isinstance(metrics.value("solver.queries"), int)
    metrics.inc("solver.time", 0.25)
    assert metrics.value("solver.time") == 0.25


def test_histogram_labels_and_aggregates():
    metrics.observe("profiler.instruction_us", 10.0, label="ADD")
    metrics.observe("profiler.instruction_us", 30.0, label="ADD")
    metrics.observe("profiler.instruction_us", 5.0, label="SSTORE")
    assert metrics.labels("profiler.instruction_us") == ["ADD", "SSTORE"]
    hist = metrics.histogram("profiler.instruction_us", "ADD")
    assert hist.as_dict() == {"count": 2, "sum": 40.0, "min": 10.0,
                              "max": 30.0, "avg": 20.0,
                              "p50": 10.0, "p95": 30.0, "p99": 30.0}
    assert metrics.histogram("profiler.instruction_us", "MUL") is None


def test_quantile_nearest_rank_and_edges():
    for value in (10.0, 20.0, 30.0, 40.0):
        metrics.observe("dispatch.flush.latency_ms", value)
    hist = metrics.histogram("dispatch.flush.latency_ms")
    assert hist.quantile(0.5) == 20.0   # ceil(0.5*4)=2 -> 2nd smallest
    assert hist.quantile(0.75) == 30.0
    assert hist.quantile(0.95) == 40.0
    assert hist.quantile(0.0) == 10.0   # q<=0 -> reservoir min
    assert hist.quantile(1.0) == 40.0   # q>=1 -> reservoir max
    assert metrics.quantile("dispatch.flush.latency_ms", 0.5) == 20.0
    # never-observed histograms read 0.0 — the exporter renders them
    # without blowing up on a fresh process
    assert metrics.quantile("serve.request_ms", 0.99) == 0.0


def test_reservoir_overflow_biases_quantiles_but_accounts_drops():
    """Past RESERVOIR observations the quantiles cover only the most
    recent window; `dropped` says exactly how many fell out, and the
    exact aggregates (count/sum/min/max) are unaffected."""
    extra = 1000
    total = metrics.RESERVOIR + extra
    for i in range(total):
        metrics.observe("serve.request_ms", float(i))
    hist = metrics.histogram("serve.request_ms")
    assert hist.count == total
    assert hist.dropped == extra
    assert hist.min == 0.0 and hist.max == float(total - 1)
    # the oldest `extra` observations are gone: the reservoir floor is
    # the first value that survived, not the lifetime minimum
    assert hist.quantile(0.0) == float(extra)
    assert hist.quantile(1.0) == float(total - 1)
    stats = hist.as_dict()
    assert stats["reservoir_dropped"] == extra
    assert stats["count"] == total and stats["min"] == 0.0
    assert stats["p50"] >= float(extra)
    # under-capacity histograms must NOT carry the drop marker
    metrics.observe("dispatch.flush.latency_ms", 1.0)
    small = metrics.histogram("dispatch.flush.latency_ms").as_dict()
    assert "reservoir_dropped" not in small


def test_snapshot_quantiles_roundtrip_frontierview(tmp_path):
    """snapshot() -> write_snapshot -> frontierview --metrics keeps the
    quantile keys end to end: the offline view renders the p95 computed
    by the live reservoir."""
    from tools import frontierview

    for value in (1.0, 2.0, 30.0):
        metrics.observe("frontier.telemetry.op_class", value, label="ADD")
    path = metrics.write_snapshot(str(tmp_path / "metrics.json"))
    snapshot = json.load(open(path))
    assert snapshot["frontier.telemetry.op_class"]["ADD"]["p95"] == 30.0
    report = frontierview.metrics_report(snapshot)
    assert "p95 30.0" in report


def test_snapshot_shape_and_prefix_reset():
    metrics.inc("dispatch.flushes")
    metrics.observe("dispatch.flush.occupancy", 8)
    metrics.inc("frontier.chunks", 5)
    snap = metrics.snapshot()
    assert snap["dispatch.flushes"] == 1
    assert snap["dispatch.flush.occupancy"]["count"] == 1
    assert snap["frontier.chunks"] == 5
    metrics.reset("dispatch.")
    assert metrics.value("dispatch.flushes") == 0
    assert metrics.histogram("dispatch.flush.occupancy") is None
    assert metrics.value("frontier.chunks") == 5  # other prefixes untouched


def test_write_snapshot_is_atomic_json(tmp_path):
    """write_snapshot: valid JSON of the full snapshot, written via a
    temp file + os.replace so a crashed writer never leaves a torn
    file at the destination path."""
    metrics.inc("frontier.telemetry.executed", 122)
    metrics.set_gauge("frontier.telemetry.occupancy", 4.5)
    metrics.observe("frontier.telemetry.op_class", 44, label="push")
    path = str(tmp_path / "metrics.json")
    metrics.write_snapshot(path)
    snap = json.load(open(path))
    assert snap["frontier.telemetry.executed"] == 122
    assert snap["frontier.telemetry.occupancy"] == 4.5
    assert snap["frontier.telemetry.op_class"]["push"]["sum"] == 44
    assert not os.path.exists(path + ".tmp")  # replaced, not left behind


def test_every_facade_field_is_declared():
    for metric_name in FACADE_METRICS.values():
        assert metrics.declared(metric_name), metric_name
    assert metrics.render_markdown_table().startswith("| Metric |")


# -- SolverStatistics facade back-compat ---------------------------------------------


def test_facade_fields_mirror_the_metric_store():
    stats = SolverStatistics()
    stats.query_count += 2
    stats.device_queries += 1
    assert metrics.value("solver.queries") == 2
    assert metrics.value("solver.device.queries") == 1
    metrics.inc("solver.queries", 3)  # writes on either side are one number
    assert stats.query_count == 5
    assert isinstance(stats.query_count, int)


def test_facade_reset_zeroes_scalars_and_reinits_containers():
    stats = SolverStatistics()
    stats.batch_submitted += 7
    stats.failure_counts["device:device_oom"] = 2
    stats.backends_quarantined.append("device")
    stats.batch_bucket_shapes.add((8, 256, 4))
    stats.reset()
    assert stats.batch_submitted == 0
    assert stats.failure_counts == {}
    assert stats.backends_quarantined == []
    assert stats.batch_bucket_shapes == set()


def test_stat_smt_query_decorator_counts_and_times():
    stats = SolverStatistics()

    @stat_smt_query
    def check():
        return "sat"

    assert check() == "sat"
    assert check() == "sat"
    assert stats.query_count == 2
    assert stats.solver_time >= 0.0


def test_batch_metrics_and_repr_preserve_legacy_shapes():
    stats = SolverStatistics()
    stats.batch_submitted += 12
    stats.batch_cache_hits += 3
    stats.batch_flushes += 2
    stats.batch_flushed_queries += 9
    stats.batch_bucket_shapes.add((8, 256, 8))
    batch = stats.batch_metrics()
    assert batch["submitted"] == 12
    assert batch["occupancy"] == 4.5
    assert batch["cache_hit_rate"] == 0.25
    assert batch["buckets_compiled"] == 1
    stats.query_count += 2
    text = repr(stats)
    assert "query count: 2," in text  # ints print as ints, not 2.0
    assert "12 submitted" in text


# -- end to end: a real host-engine run exports a loadable trace ---------------------


def test_host_engine_run_exports_covering_trace(tmp_path):
    from mythril_tpu_torch.analysis.symbolic import SymExecWrapper
    from mythril_tpu_torch.frontends.asm import assemble, creation_wrapper

    import tools.traceview as traceview

    out = str(tmp_path / "run.json")
    trace.enable(out)
    creation = creation_wrapper(assemble(
        "PUSH1 0x00\nCALLDATALOAD\nPUSH1 0x2a\nEQ\nPUSH @yes\nJUMPI\nSTOP\n"
        "yes:\nJUMPDEST\nPUSH1 0x01\nPUSH1 0x00\nSSTORE\nSTOP"))
    SymExecWrapper(
        creation.hex(), address=None, strategy="bfs", max_depth=64,
        execution_timeout=30, create_timeout=15, transaction_count=1,
        compulsory_statespace=False, run_analysis_modules=False)
    path = trace.export()

    events, other = traceview.load_trace(path)
    spans = [e for e in events if e["ph"] == "X"]
    names = {e["name"] for e in spans}
    assert "svm.create_tx" in names
    assert "svm.tx" in names
    # the engine-phase spans cover (>= 90%) of the traced wall window
    covered, wall = traceview.merged_coverage(spans)
    assert wall > 0
    assert covered / wall >= 0.9, f"span coverage {covered / wall:.1%}"
    # and the report renders a rollup over them
    text = traceview.report(events, other)
    assert "== per-phase wall time ==" in text
    assert "svm.tx" in text


# -- Prometheus exposition -----------------------------------------------------------

#: suffixes the renderer may append to a metric's Prometheus name
_SUFFIXES = ("_total", "_sum", "_count", "_reservoir_dropped")


def _base_name(series_line: str) -> str:
    """``mythril_tpu_x_total{a="b"} 3`` -> the declared-metric part."""
    name = re.split(r"[{ ]", series_line, maxsplit=1)[0]
    for suffix in _SUFFIXES:
        if name.endswith(suffix):
            candidate = name[: -len(suffix)]
            if candidate in _DECLARED_PROM:
                return candidate
    return name


_DECLARED_PROM = {export.prometheus_name(name) for name in metrics.REGISTRY}


def test_every_exposition_line_names_a_declared_metric():
    metrics.inc("serve.requests", 3)
    metrics.set_gauge("frontier.telemetry.occupancy", 0.5)
    metrics.observe("dispatch.flush.latency_ms", 12.5)
    metrics.observe("profiler.instruction_us", 7.0, label="ADD")
    text = export.render_prometheus()
    assert text.endswith("\n")
    docs = {export.prometheus_name(spec.name): spec.doc
            for spec in metrics._METRICS}
    for line in text.splitlines():
        assert line, "exposition must not contain blank lines"
        if line.startswith("# HELP "):
            name, doc = line[len("# HELP "):].split(" ", 1)
            assert name in _DECLARED_PROM, f"HELP for undeclared {name}"
            assert doc == docs[name].replace("\n", "\\n"), \
                f"HELP drifted from the registry doc for {name}"
        elif line.startswith("# TYPE "):
            name, kind = line[len("# TYPE "):].split(" ", 1)
            assert name in _DECLARED_PROM
            assert kind in ("counter", "gauge", "summary")
        else:
            assert _base_name(line) in _DECLARED_PROM, \
                f"series line for undeclared metric: {line!r}"
    # the whole declared surface renders, even never-touched metrics
    for prom in _DECLARED_PROM:
        assert f"# HELP {prom} " in text


def test_counter_and_gauge_rendering():
    metrics.inc("serve.requests", 3)
    metrics.set_gauge("frontier.telemetry.arena_bytes", 4096)
    text = export.render_prometheus()
    assert "\nmythril_tpu_serve_requests_total 3\n" in text
    assert "\nmythril_tpu_frontier_telemetry_arena_bytes 4096\n" in text
    # untouched scalars still render as 0
    assert "\nmythril_tpu_serve_busy_rejections_total 0\n" in text


def test_histogram_renders_as_summary_with_quantiles_and_labels():
    for value in (10.0, 20.0, 30.0, 40.0):
        metrics.observe("dispatch.flush.latency_ms", value)
    metrics.observe("profiler.instruction_us", 7.0, label="ADD")
    text = export.render_prometheus()
    prom = "mythril_tpu_dispatch_flush_latency_ms"
    assert f'{prom}{{quantile="0.5"}} 20.0' in text
    assert f'{prom}{{quantile="0.95"}} 40.0' in text
    assert f"{prom}_sum 100.0" in text
    assert f"{prom}_count 4" in text
    # the per-label breakdown rides a label="..." dimension
    assert ('mythril_tpu_profiler_instruction_us'
            '{label="ADD",quantile="0.5"} 7.0') in text
    # unobserved histograms render zero sum/count, no quantile series
    assert "mythril_tpu_serve_request_ms_sum 0.0" in text
    assert "mythril_tpu_serve_request_ms_count 0" in text
    assert "mythril_tpu_serve_request_ms{" not in text


def test_help_lines_escape_newlines_and_backslashes():
    assert export._escape_help("a\nb\\c") == "a\\nb\\\\c"
    assert export._escape_label('say "hi"\n') == 'say \\"hi\\"\\n'


def test_collect_device_memory_never_raises():
    stats = export.collect_device_memory()
    assert isinstance(stats, dict)
    if stats:  # a CUDA device with memory stats was visible
        assert stats["devices"] >= 1
        assert metrics.value("device.hbm.bytes_in_use") == \
            stats["bytes_in_use"]


# -- snapshot ring -------------------------------------------------------------------


def test_ring_is_bounded_and_sequenced():
    export.reset_ring()
    ring = export.ring(capacity=4)
    assert ring.capacity == 4
    for i in range(10):
        metrics.inc("serve.requests")
        ring.record(request_id=f"r{i}")
    assert len(ring) == 4
    entries = ring.tail()
    assert [entry["request_id"] for entry in entries] == \
        ["r6", "r7", "r8", "r9"]
    seqs = [entry["seq"] for entry in entries]
    assert seqs == sorted(seqs) and seqs[-1] == 10
    assert entries[-1]["metrics"]["serve.requests"] == 10
    assert ring.tail(2) == entries[-2:]


def test_record_snapshot_uses_the_process_ring():
    entry = export.record_snapshot(scrape="s1")
    assert entry["scrape"] == "s1" and "metrics" in entry
    assert export.ring().tail()[-1]["seq"] == entry["seq"]


# -- structured logging --------------------------------------------------------------


def test_slog_disabled_is_a_noop(tmp_path):
    sink = tmp_path / "never.slog"
    assert not slog.enabled()
    slog.event("frontier.chunk", running=8)  # must not raise or write
    assert not sink.exists()


def test_slog_writes_json_lines_with_correlation_scope(tmp_path):
    sink = str(tmp_path / "run.slog")
    slog.enable(sink)
    assert slog.enabled() and slog.sink_path() == sink
    slog.event("serve.listening", transport="stdio")
    cid = slog.new_correlation_id()
    with slog.correlated(cid) as scoped:
        assert scoped == cid and slog.correlation_id() == cid
        slog.event("frontier.chunk", running=8, stack=3)
    assert slog.correlation_id() is None  # scope restored
    records = [json.loads(line)
               for line in open(sink, encoding="utf-8")]
    assert [record["event"] for record in records] == \
        ["serve.listening", "frontier.chunk"]
    assert records[0]["cid"] is None
    assert records[1]["cid"] == cid
    assert records[1]["running"] == 8 and records[1]["stack"] == 3
    assert all("ts" in record for record in records)


def test_slog_enable_starts_it_and_no_knob_does(tmp_path, monkeypatch):
    """The JAX package's MYTHRIL_TPU_SLOG opens its sink at first use; the
    port's reads no knob: only `enable(sink)` opens one."""
    sink = str(tmp_path / "enabled.slog")
    monkeypatch.setenv("MYTHRIL_TPU_SLOG", str(tmp_path / "knob.slog"))
    slog.reset()
    slog.event("dispatch.flush", occupancy=4)
    assert not slog.enabled()
    assert not (tmp_path / "knob.slog").exists()
    slog.enable(sink)
    slog.event("dispatch.flush", occupancy=4)
    assert slog.enabled()
    record = json.loads(open(sink, encoding="utf-8").read())
    assert record["event"] == "dispatch.flush"
    assert record["occupancy"] == 4


def test_correlation_ids_are_unique_and_shaped():
    first = slog.new_correlation_id()
    second = slog.new_correlation_id()
    assert first != second
    assert re.fullmatch(r"c[0-9a-f]+-[0-9a-f]{6}-\d+", first)


def test_slog_survives_a_dead_sink(tmp_path):
    sink = str(tmp_path / "dead.slog")
    slog.enable(sink)
    slog._SLOGGER._handle.close()  # simulate the sink dying under us
    slog.event("serve.reply", ok=True)  # must not raise
    assert not slog.enabled()  # logger turned itself off
