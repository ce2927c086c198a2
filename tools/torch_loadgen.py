"""torch_loadgen — open-loop load/SLO harness against the PyTorch/CUDA
port's serve daemon.

The port's copy of tools/loadgen.py: the same workload, schedule, rollups
and SLO A/B, against ``mythril_tpu_torch``'s daemon. It imports only the
port and the standard library. The JAX tool passes some daemon settings in
the environment (the result store, the structured log, the queue bound,
the autoscaler's interval and patience, the worker heartbeat); the port
reads no environment, so its daemon is started by this module's launcher,
``python -m tools.torch_loadgen daemon ...``, which builds the service
through the port's library API as ``serve`` does (``AnalysisService``,
``install_sigterm_drain``, ``serve_socket``) and takes each of those
settings as an argument with the JAX knob's value. The tools beside it
(tools/torch_*_smoke.py) start their daemons through the same launcher.
``--engine tpu`` runs the daemon's analyses on the CUDA card; a daemon
that cannot reach the card exits 2, and nothing reruns on the CPU.

Replays a mainnet-shaped request mix at a configured arrival rate and
reports per-priority latency quantiles, shed rates, result-store hit
rate, and the autoscaler's pool trajectory:

    python -m tools.torch_loadgen --duration 60 --rate 4
    python -m tools.torch_loadgen --bulk-frac 0.8 --workers-max 3
    python -m tools.torch_loadgen --inject-fault worker_segv:5   # chaos
    python -m tools.torch_loadgen --slo-ab --engine tpu   # on the card

Shape of the load (the mainnet argument, PAPERS.md/DTVM: deployed
bytecode is heavily duplicated, interactive traffic rides on top of
batch sweeps):

* **duplicate-heavy** — requests draw from a small distinct-contract
  corpus with a skewed (zipf-ish) popularity curve, so repeat codehashes
  dominate exactly as they do on-chain and the content-addressed result
  store gets a realistic hit profile;
* **mixed priority** — a configurable fraction rides as ``bulk`` (the
  sweep), the rest as ``interactive`` (the user waiting on a reply);
* **open loop** — arrivals are scheduled from the clock, not from
  completions, so a slow daemon faces a growing queue instead of a
  politely self-throttling client (closed-loop load hides overload).

The daemon is spawned fresh (its own socket/manifest in a temp workdir)
unless ``--socket`` points at one already running. A sampler thread
polls the ``status`` op for queue-depth/pool/autoscaler trajectory.

Each reply's result is kept beside its outcome (``result``: the
reply's RESULT_KEYS) with the frontier counters of a reply the daemon
computed (``frontier``; a result-store hit has none), so that a caller
can hold a loaded reply to an unloaded one's.

Output protocol (the bench.py convention): progress as ``{"phase":...}``
JSON lines on stderr, exactly one summary JSON object on stdout. Exit 0
when the run completed (SLO *reporting* is this tool's job; SLO
*gating* is tools/torch_load_smoke.py's).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from mythril_tpu_torch.serve import client as serve_client  # noqa: E402
from mythril_tpu_torch.serve.autoscale import UP_AFTER  # noqa: E402


def _phase(name, **payload):
    print(json.dumps({"phase": name, **payload}), file=sys.stderr,
          flush=True)


# -- workload ------------------------------------------------------------------------


def build_corpus(n_contracts: int) -> List[str]:
    """`n_contracts` distinct tiny-but-real bytecodes: a PUSH1 pad makes
    each one unique, the shared suffix stores a calldata word — a few
    host-engine states each, so service time is dominated by dispatch
    (the thing under test), not symbolic execution."""
    suffix = "600035600055600160005260206000f3"  # calldataload;sstore;return
    return [f"60{i:02x}50{suffix}" for i in range(max(1, n_contracts))]


def pick_contract(corpus: List[str], rng: random.Random) -> str:
    """Zipf-ish popularity: rank r drawn with weight 1/(r+1) — the head
    of the corpus absorbs most of the traffic, like mainnet codehashes."""
    weights = [1.0 / (rank + 1) for rank in range(len(corpus))]
    return rng.choices(corpus, weights=weights, k=1)[0]


def arrival_times(duration_s: float, rate_hz: float,
                  rng: random.Random) -> List[float]:
    """Poisson arrivals (exponential gaps) over the run window —
    open-loop: the schedule exists before the first reply."""
    times, now = [], 0.0
    while now < duration_s:
        now += rng.expovariate(max(rate_hz, 1e-9))
        if now < duration_s:
            times.append(now)
    return times


# -- daemon lifecycle ----------------------------------------------------------------


def daemon_argv(args, socket_path: str, manifest_path: str,
                slog_path: Optional[str] = None) -> List[str]:
    """The launcher's arguments for one load profile: the JAX tool's CLI
    flags and, as arguments, what it puts in the daemon's environment
    (MYTHRIL_TPU_SLOG, SERVE_QUEUE_MAX, SERVE_AUTOSCALE_INTERVAL_MS),
    each only where the JAX tool sets it. The JAX tool's
    SERVE_AUTOSCALE_UP_AFTER (2 in the contended profile) is the
    autoscaler's default here, so it is not passed."""
    if args.autoscale_up_after not in (0, UP_AFTER):
        raise ValueError(f"--autoscale-up-after {args.autoscale_up_after}: "
                         f"the port's daemon scales up after {UP_AFTER}")
    argv = ["--socket", socket_path, "--manifest", manifest_path,
            "--solver", "cdcl", "--engine", args.engine,
            "--workers", str(args.workers)]
    if slog_path:
        argv += ["--slog", slog_path]
    if args.workers_min:
        argv += ["--workers-min", str(args.workers_min)]
    if args.workers_max:
        argv += ["--workers-max", str(args.workers_max)]
    if args.max_inflight:
        argv += ["--max-inflight", str(args.max_inflight)]
    if args.inject_fault:
        argv += ["--inject-fault", args.inject_fault]
    if args.queue_max:
        argv += ["--queue-max", str(args.queue_max)]
    if args.autoscale_interval_ms:
        argv += ["--autoscale-interval-ms", str(args.autoscale_interval_ms)]
    return argv


class SpawnedDaemon:
    """A fresh daemon in a private workdir (socket + manifest + slog),
    started by this module's launcher; its output goes to ``daemon.log``
    there."""

    def __init__(self, args):
        self.workdir = tempfile.mkdtemp(prefix="torch_loadgen_")
        self.socket_path = os.path.join(self.workdir, "serve.sock")
        self.manifest_path = os.path.join(self.workdir, "warmset.json")
        self.log_path = os.path.join(self.workdir, "daemon.log")
        argv = daemon_argv(args, self.socket_path, self.manifest_path,
                           os.path.join(self.workdir, "serve.slog"))
        with open(self.log_path, "wb") as log:
            self.process = subprocess.Popen(
                self.command(argv), cwd=_REPO, stdout=log,
                stderr=subprocess.STDOUT)

    def command(self, argv: List[str]) -> List[str]:
        """The daemon's command line (a harness may run it under a
        wrapper of its own)."""
        return [sys.executable, "-m", "tools.torch_loadgen", "daemon",
                *argv]

    def log_tail(self, size: int = 4000) -> str:
        try:
            with open(self.log_path, encoding="utf-8",
                      errors="replace") as handle:
                return handle.read()[-size:]
        except OSError:
            return ""

    def wait_ready(self, timeout_s: float = 180.0) -> None:
        deadline = time.monotonic() + timeout_s
        while not os.path.exists(self.socket_path):
            if self.process.poll() is not None:
                raise RuntimeError("daemon died before binding:\n"
                                   + self.log_tail())
            if time.monotonic() > deadline:
                raise RuntimeError("daemon socket never appeared")
            time.sleep(0.2)

    def shutdown(self) -> None:
        """Ask the daemon to drain and exit; kill it if it does not."""
        try:
            serve_client.request({"op": "shutdown"},
                                 socket_path=self.socket_path, timeout=30)
        except (serve_client.ServeClientError, OSError):
            pass
        try:
            self.process.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.process.kill()
            self.process.wait(timeout=10)

    def stop(self) -> None:
        self.shutdown()
        shutil.rmtree(self.workdir, ignore_errors=True)


# -- measurement ---------------------------------------------------------------------


#: the keys of an analyze reply that hold its result; the others are the
#: request's accounting (id, timing, cache, warmth, frontier counters)
RESULT_KEYS = ("issue_count", "incomplete", "coverage", "report")


def reply_result(reply: dict) -> Optional[dict]:
    """An answered reply's RESULT_KEYS; None for an error reply."""
    if not reply.get("ok"):
        return None
    return {key: reply.get(key) for key in RESULT_KEYS}


def _quantile(sorted_values: List[float], q: float) -> float:
    if not sorted_values:
        return 0.0
    index = min(len(sorted_values) - 1,
                max(0, int(round(q * (len(sorted_values) - 1)))))
    return sorted_values[index]


def summarize_class(records: List[dict]) -> dict:
    """Latency/outcome rollup for one priority class."""
    lat = sorted(r["elapsed_ms"] for r in records if r["outcome"] == "ok")
    outcomes: Dict[str, int] = {}
    for record in records:
        outcomes[record["outcome"]] = outcomes.get(record["outcome"], 0) + 1
    sent = len(records)
    shed = outcomes.get("overloaded", 0)
    return {
        "sent": sent,
        "ok": outcomes.get("ok", 0),
        "cached": sum(1 for r in records if r.get("cached")),
        "shed": shed,
        "shed_rate": round(shed / sent, 4) if sent else 0.0,
        "outcomes": outcomes,
        "p50_ms": round(_quantile(lat, 0.50), 1),
        "p95_ms": round(_quantile(lat, 0.95), 1),
        "p99_ms": round(_quantile(lat, 0.99), 1),
    }


def run_load(socket_path: str, corpus: List[str], schedule: List[float],
             bulk_frac: float, deadline_ms: Optional[int],
             timeout_s: float, rng: random.Random,
             sample_every_s: float = 0.5):
    """Fire the open-loop schedule at the daemon; returns (records,
    trajectory). One thread per in-flight request (arrivals never wait
    on completions), plus a sampler thread recording the ``status`` op's
    queue/pool/autoscaler view twice a second."""
    records: List[dict] = []
    records_lock = threading.Lock()
    trajectory: List[dict] = []
    stop_sampling = threading.Event()
    start = time.monotonic()

    def fire(at_s: float, priority: str, code: str, request_id: str):
        delay = at_s - (time.monotonic() - start)
        if delay > 0:
            time.sleep(delay)
        payload = {"op": "analyze", "id": request_id, "code": code,
                   "priority": priority}
        if priority == "bulk" and deadline_ms:
            payload["deadline_ms"] = deadline_ms
        sent_at = time.monotonic()
        try:
            reply = serve_client.request(payload, socket_path=socket_path,
                                         timeout=timeout_s)
            outcome = ("ok" if reply.get("ok")
                       else (reply.get("error") or {}).get("code",
                                                           "error"))
            cached = bool(reply.get("cached"))
            result, frontier = reply_result(reply), reply.get("frontier")
        except serve_client.ServeClientError as error:
            outcome, cached = f"transport:{type(error).__name__}", False
            result = frontier = None
        record = {"at_s": round(at_s, 3), "priority": priority,
                  "outcome": outcome, "cached": cached,
                  "elapsed_ms": (time.monotonic() - sent_at) * 1000.0,
                  "code": code, "result": result, "frontier": frontier}
        with records_lock:
            records.append(record)

    def sample():
        while not stop_sampling.wait(sample_every_s):
            try:
                status = serve_client.request(
                    {"op": "status"}, socket_path=socket_path, timeout=30)
            except (serve_client.ServeClientError, OSError):
                continue
            queue = status.get("queue") or {}
            scaler = status.get("autoscaler") or {}
            store = status.get("result_store") or {}
            trajectory.append({
                "t_s": round(time.monotonic() - start, 2),
                "depth": queue.get("depth"),
                "active": queue.get("active"),
                "shed": queue.get("shed"),
                "pool_target": scaler.get("target"),
                "pool_live": scaler.get("current"),
                "pool_busy": scaler.get("busy"),
                "scale_ups": scaler.get("scale_ups"),
                "store_hits": store.get("hits"),
                "store_hit_rate": store.get("hit_rate"),
            })

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    threads = []
    for n, at_s in enumerate(schedule):
        priority = "bulk" if rng.random() < bulk_frac else "interactive"
        code = pick_contract(corpus, rng)
        thread = threading.Thread(
            target=fire, args=(at_s, priority, code, f"load-{n}"),
            daemon=True)
        thread.start()
        threads.append(thread)
    for thread in threads:
        thread.join(timeout=timeout_s + 30)
    stop_sampling.set()
    sampler.join(timeout=5)
    return records, trajectory


def summarize(records: List[dict], trajectory: List[dict],
              args) -> dict:
    by_class = {"interactive": [], "bulk": []}
    for record in records:
        by_class[record["priority"]].append(record)
    classes = {name: summarize_class(rows)
               for name, rows in by_class.items()}
    total_cached = sum(c["cached"] for c in classes.values())
    total_ok = sum(c["ok"] for c in classes.values())
    last = trajectory[-1] if trajectory else {}
    peak_pool = max((t.get("pool_live") or 0 for t in trajectory),
                    default=0)
    return {
        "config": {
            "duration_s": args.duration,
            "rate_hz": args.rate,
            "bulk_frac": args.bulk_frac,
            "contracts": args.contracts,
            "workers": args.workers,
            "workers_min": args.workers_min,
            "workers_max": args.workers_max,
            "queue_max": args.queue_max,
            "inject_fault": args.inject_fault,
            "seed": args.seed,
        },
        "classes": classes,
        "cache": {
            "cached_replies": total_cached,
            "hit_rate_of_ok": round(total_cached / total_ok, 4)
            if total_ok else 0.0,
            "store_hits": last.get("store_hits"),
            "store_hit_rate": last.get("store_hit_rate"),
        },
        "autoscale": {
            "scale_ups": last.get("scale_ups"),
            "peak_pool": peak_pool,
            "final_target": last.get("pool_target"),
        },
        "trajectory": trajectory,
    }


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m tools.torch_loadgen",
        description="Open-loop load/SLO harness for the port's serve "
                    "daemon.")
    parser.add_argument("--duration", type=float, default=60.0,
                        help="load window in seconds (default 60)")
    parser.add_argument("--rate", type=float, default=4.0,
                        help="mean arrival rate, requests/s (default 4)")
    parser.add_argument("--bulk-frac", type=float, default=0.75,
                        help="fraction of arrivals sent as bulk "
                             "(default 0.75)")
    parser.add_argument("--contracts", type=int, default=6,
                        help="distinct bytecodes in the corpus "
                             "(default 6; the zipf head repeats)")
    parser.add_argument("--deadline-ms", type=int, default=None,
                        help="deadline_ms attached to BULK requests "
                             "(exercises admission triage)")
    parser.add_argument("--timeout", type=float, default=300.0,
                        help="per-request client timeout (default 300)")
    parser.add_argument("--seed", type=int, default=7,
                        help="workload RNG seed (default 7)")
    parser.add_argument("--socket", default=None,
                        help="target an already-running daemon instead "
                             "of spawning one")
    parser.add_argument("--workers", type=int, default=1,
                        help="spawned daemon's initial worker pool")
    parser.add_argument("--workers-min", type=int, default=1)
    parser.add_argument("--workers-max", type=int, default=2)
    parser.add_argument("--max-inflight", type=int, default=None)
    parser.add_argument("--queue-max", type=int, default=8)
    parser.add_argument("--autoscale-interval-ms", type=int, default=300)
    parser.add_argument("--autoscale-up-after", type=int, default=2,
                        help="the JAX tool's flag; the port's daemon runs "
                             "its autoscaler's UP_AFTER (2), so only 2 (or "
                             "0, unset) is taken")
    parser.add_argument("--inject-fault", default=None,
                        help="fault spec forwarded to the spawned daemon "
                             "(e.g. worker_segv:5 — the chaos variant)")
    parser.add_argument("--engine", default="host", choices=["host", "tpu"],
                        help="the spawned daemon's engine (tpu: the device "
                             "frontier on the CUDA card)")
    return parser


def run_profile(args, spawn=SpawnedDaemon) -> dict:
    """One full load run: spawn (or target) a daemon, fire the
    schedule, return the summary dict with every request's record
    (``records``). The reusable core behind ``main``,
    tools/torch_load_smoke.py and chip_smoke.py's load phase; ``spawn``
    builds the daemon (a SpawnedDaemon or a subclass)."""
    rng = random.Random(args.seed)
    corpus = build_corpus(args.contracts)
    schedule = arrival_times(args.duration, args.rate, rng)
    _phase("plan", requests=len(schedule), contracts=len(corpus),
           duration_s=args.duration, rate_hz=args.rate,
           bulk_frac=args.bulk_frac)
    daemon: Optional[SpawnedDaemon] = None
    socket_path = args.socket
    try:
        if socket_path is None:
            daemon = spawn(args)
            socket_path = daemon.socket_path
            daemon.wait_ready()
            _phase("daemon", socket=socket_path,
                   workers=args.workers, workers_max=args.workers_max,
                   inject_fault=args.inject_fault)
        records, trajectory = run_load(
            socket_path, corpus, schedule, args.bulk_frac,
            args.deadline_ms, args.timeout, rng)
        summary = summarize(records, trajectory, args)
        summary["records"] = records
    finally:
        if daemon is not None:
            daemon.stop()
    for name, rollup in summary["classes"].items():
        _phase(f"class.{name}", **{k: v for k, v in rollup.items()
                                   if k != "outcomes"})
    _phase("cache", **summary["cache"])
    _phase("autoscale", **summary["autoscale"])
    return summary


#: the SLO A/B's two profiles, the JAX tool's (tools/loadgen.py slo_ab)
BASELINE_PROFILE = [
    "--duration", "20", "--rate", "0.6", "--bulk-frac", "0.0",
    "--contracts", "5", "--workers", "1",
    "--workers-min", "1", "--workers-max", "0",
    "--queue-max", "32", "--timeout", "240",
]
CONTENDED_PROFILE = [
    "--duration", "30", "--rate", "4", "--bulk-frac", "0.75",
    "--contracts", "5", "--workers", "1",
    "--workers-min", "1", "--workers-max", "2",
    "--queue-max", "4", "--autoscale-interval-ms", "300",
    "--autoscale-up-after", "2", "--timeout", "240",
]


def slo_ab(baseline_args: Optional[List[str]] = None,
           contended_args: Optional[List[str]] = None,
           engine: str = "host", spawn=SpawnedDaemon) -> dict:
    """The SLO A/B behind BENCH_r09+ and the load_smoke latency gate:
    an *uncontended* interactive-only baseline run, then a *contended*
    run with bulk demand past capacity, composed into higher-is-better
    SLO series (benchview trends these):

    * ``interactive_p99_ratio`` — baseline p99 / contended p99; 0.5
      means contended p99 is exactly the acceptance bound (2x the
      uncontended baseline);
    * ``interactive_served_frac`` — 1 - interactive shed rate (must
      stay 1.0: shedding falls on bulk);
    * ``cache_hit_rate`` — the result store's hit rate over the
      duplicate-heavy contended mix.

    ``engine`` is both runs' daemon engine; ``spawn`` builds each daemon.
    """
    parser = build_parser()
    baseline = run_profile(parser.parse_args(
        [*(baseline_args or BASELINE_PROFILE), "--engine", engine]), spawn)
    contended = run_profile(parser.parse_args(
        [*(contended_args or CONTENDED_PROFILE), "--engine", engine]), spawn)
    base_p99 = baseline["classes"]["interactive"]["p99_ms"]
    load_p99 = contended["classes"]["interactive"]["p99_ms"]
    shed_rate = contended["classes"]["interactive"]["shed_rate"]
    slo = {
        "rate_hz": contended["config"]["rate_hz"],
        "baseline_interactive_p99_ms": base_p99,
        "contended_interactive_p99_ms": load_p99,
        "interactive_p99_ratio": round(base_p99 / max(load_p99, 1e-9), 4),
        "interactive_served_frac": round(1.0 - shed_rate, 4),
        "cache_hit_rate": contended["cache"]["store_hit_rate"] or 0.0,
        "scale_ups": contended["autoscale"]["scale_ups"],
        "bulk_shed": contended["classes"]["bulk"]["shed"],
    }
    _phase("slo", **slo)
    return {"slo": slo, "baseline": baseline, "contended": contended}


# -- the daemon launcher ------------------------------------------------------------


def build_daemon_parser() -> argparse.ArgumentParser:
    """The launcher's flags: the port's ``serve`` flags this harness uses
    and, as flags, the daemon settings the JAX tools pass in the
    environment."""
    parser = argparse.ArgumentParser(
        prog="python -m tools.torch_loadgen daemon",
        description="start the port's serve daemon on a unix socket with "
                    "the load harness's settings")
    parser.add_argument("--socket", required=True)
    parser.add_argument("--manifest", required=True)
    parser.add_argument("--solver", default="cdcl", choices=["cdcl", "jax"])
    parser.add_argument("--engine", default="host", choices=["host", "tpu"])
    parser.add_argument("--workers", type=int, default=None)
    parser.add_argument("--workers-min", type=int, default=None)
    parser.add_argument("--workers-max", type=int, default=None)
    parser.add_argument("--max-inflight", type=int, default=None)
    parser.add_argument("--queue-max", type=int, default=None,
                        help="MYTHRIL_TPU_SERVE_QUEUE_MAX's value")
    parser.add_argument("--inject-fault", default=None)
    parser.add_argument("--autoscale-interval-ms", type=int, default=None,
                        help="MYTHRIL_TPU_SERVE_AUTOSCALE_INTERVAL_MS's "
                             "value")
    parser.add_argument("--heartbeat-ms", type=int, default=None,
                        help="MYTHRIL_TPU_SERVE_WORKER_HEARTBEAT_MS's value")
    parser.add_argument("--no-result-store", action="store_true",
                        help="MYTHRIL_TPU_RESULT_STORE=0")
    parser.add_argument("--slog", default=None, metavar="SINK",
                        help="MYTHRIL_TPU_SLOG's value: the structured "
                             "log, which the workers write too")
    return parser


def service_settings(args) -> dict:
    """The keyword arguments of the port's ``AnalysisService`` for the
    launcher's parsed flags; a setting left unset keeps its default, the
    JAX knob's."""
    settings = {"solver": args.solver, "engine": args.engine,
                "manifest_path": args.manifest,
                "inject_fault": args.inject_fault}
    for name, value in (("workers", args.workers),
                        ("workers_min", args.workers_min),
                        ("workers_max", args.workers_max),
                        ("max_inflight", args.max_inflight),
                        ("queue_max", args.queue_max),
                        ("autoscale_interval_ms",
                         args.autoscale_interval_ms),
                        ("heartbeat_ms", args.heartbeat_ms)):
        if value is not None:
            settings[name] = value
    if args.no_result_store:
        settings["result_store"] = False
    return settings


def daemon_main(argv: List[str]) -> int:
    """Serve on ``--socket`` until a ``shutdown`` request, as
    ``python -m mythril_tpu_torch serve`` does: the service built, then
    the card resolved for a tpu or jax daemon (exit 2 without one), the
    structured log enabled before the service is built (its workers
    inherit the sink through their argv), SIGTERM drains."""
    import logging

    from mythril_tpu_torch.exceptions import DeviceUnavailable
    from mythril_tpu_torch.observe import slog
    from mythril_tpu_torch.plugin import MythrilPluginLoader
    from mythril_tpu_torch.serve.daemon import (install_sigterm_drain,
                                                serve_socket)
    from mythril_tpu_torch.serve.service import AnalysisService

    args = build_daemon_parser().parse_args(argv)
    logging.basicConfig(level=logging.ERROR,
                        format="%(levelname)s:%(name)s: %(message)s")
    MythrilPluginLoader().load_default_enabled()
    if args.slog:
        slog.enable(args.slog)
    # built first, so that the pool's fork server imports torch while
    # this process resolves the card
    service = AnalysisService(**service_settings(args))
    try:
        if args.engine == "tpu":
            from mythril_tpu_torch.parallel import frontier

            frontier.resolve_device()
        if args.solver == "jax":
            from mythril_tpu_torch.smt.solver import dispatch

            dispatch.resolve_device()
    except DeviceUnavailable as error:
        service.close()
        print(f"torch_loadgen daemon: {error}", file=sys.stderr)
        return 2
    install_sigterm_drain(service)
    serve_socket(service, socket_path=args.socket)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["daemon"]:
        return daemon_main(argv[1:])
    parser = build_parser()
    parser.add_argument("--slo-ab", action="store_true",
                        help="run the uncontended-baseline vs contended "
                             "A/B and emit the composed SLO series "
                             "(ignores the single-run flags)")
    args = parser.parse_args(argv)
    if args.slo_ab:
        print(json.dumps(slo_ab(engine=args.engine), sort_keys=True),
              flush=True)
        return 0
    print(json.dumps(run_profile(args), sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
