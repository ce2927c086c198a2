"""Worker-pool chaos smoke of the PyTorch/CUDA port for its pre-merge gate
(tools/check_torch.sh).

The port's copy of tools/chaos_smoke.py, with the same phases, checks and
bounds, against the port's daemon; it imports only the port and the
standard library. The JAX tool passes the structured log, the result
store's switch and the hang phase's heartbeat in the environment
(MYTHRIL_TPU_SLOG, MYTHRIL_TPU_RESULT_STORE=0,
MYTHRIL_TPU_SERVE_WORKER_HEARTBEAT_MS=3000); the port reads no
environment, so each daemon is started by tools/torch_loadgen.py's
launcher (``python -m tools.torch_loadgen daemon``) with those settings as
arguments (``--slog``, ``--no-result-store``, ``--heartbeat-ms``); the
supervisor hands the heartbeat and the log to its workers in their argv.

Process-level fault-injection soak against a live daemon running with a
supervised worker pool (host engine, CDCL only, one worker slot, so it
stays cheap). Three phases, each its own daemon:

1. **segv** (`--inject-fault worker_segv:2`): three analyze requests
   for the same contract over one connection. The second dispatched job
   carries the injection and its worker genuinely SIGSEGVs; the daemon
   must survive, retry the victim on a fresh worker, and answer it with
   a report byte-identical to the uninjured requests'. /healthz must
   show the restart and the death, the slog must carry the correlated
   death/retry records, and the poison sidecar must quarantine nobody
   (one crash is below the threshold — a healthy contract that met an
   unlucky worker is not poison).
2. **hang** (`--inject-fault worker_hang:1`, 3 s heartbeat): the first
   job's worker goes silent; the supervisor's heartbeat timeout must
   kill it, classify WORKER_HANG, and the retry must answer the
   request.
3. **quarantine** (`--inject-fault worker_segv:1,worker_segv:2`): both
   the first dispatch and its retry die, so the request fails with the
   typed worker error, the contract's bytecode hash lands in the
   quarantine sidecar, and a repeat request is refused with the typed
   ``quarantined`` error before any worker is risked.

Prints ``CHAOS_SMOKE=ok`` on success; any failure exits non-zero with a
diagnostic. The caller bounds the wall clock (check.sh wraps this in
`timeout`)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _mini_contract() -> str:
    from mythril_tpu_torch.frontends.asm import (assemble, creation_wrapper,
                                                 dispatcher)

    runtime = assemble(dispatcher({
        "activatekillability()": "PUSH1 0x01\nPUSH1 0x00\nSSTORE\nSTOP",
        "commencekilling()": ("PUSH1 0x00\nSLOAD\nPUSH1 0x01\nEQ\n"
                              "PUSH @do_kill\nJUMPI\nSTOP\n"
                              "do_kill:\nJUMPDEST\nCALLER\nSELFDESTRUCT"),
    }))
    return creation_wrapper(runtime).hex()


class _Phase:
    """One daemon lifecycle: spawn with an injection spec, run the
    request script, collect problems, always reap the daemon."""

    def __init__(self, name: str, inject: str, extra_args=()):
        self.name = name
        self.workdir = tempfile.mkdtemp(prefix=f"chaos_smoke_{name}_")
        self.socket_path = os.path.join(self.workdir, "serve.sock")
        self.manifest_path = os.path.join(self.workdir, "warmset.json")
        self.slog_path = os.path.join(self.workdir, "serve.slog")
        self.sidecar_path = os.path.join(self.workdir,
                                         "warmset.quarantine.json")
        # chaos phases repeat the same bytecode on purpose (to hit the
        # injected fault on redispatch); the result store would answer
        # the repeats from cache and the fault would never fire
        self.daemon = subprocess.Popen(
            [sys.executable, "-m", "tools.torch_loadgen", "daemon",
             "--socket", self.socket_path, "--manifest", self.manifest_path,
             "--solver", "cdcl", "--engine", "host",
             "--workers", "1", "--inject-fault", inject,
             "--slog", self.slog_path, "--no-result-store", *extra_args],
            cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        self.problems = []

    def complain(self, message: str) -> None:
        self.problems.append(f"[{self.name}] {message}")

    def wait_for_socket(self, timeout_s: float = 180.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while not os.path.exists(self.socket_path):
            if self.daemon.poll() is not None:
                self.complain(
                    "daemon died before binding:\n"
                    + self.daemon.stderr.read().decode(errors="replace"))
                return False
            if time.monotonic() > deadline:
                self.complain("socket never appeared")
                return False
            time.sleep(0.2)
        return True

    def slog_text(self) -> str:
        try:
            with open(self.slog_path, encoding="utf-8") as handle:
                return handle.read()
        except OSError:
            return ""

    def sidecar(self) -> dict:
        try:
            with open(self.sidecar_path, encoding="utf-8") as handle:
                return json.load(handle)
        except (OSError, ValueError):
            return {}

    def finish(self) -> None:
        try:
            self.daemon.wait(timeout=60)
            if self.daemon.returncode != 0:
                self.complain(
                    f"daemon exited {self.daemon.returncode}:\n"
                    + self.daemon.stderr.read().decode(errors="replace"))
        except subprocess.TimeoutExpired:
            self.complain("daemon did not drain after shutdown")
        finally:
            if self.daemon.poll() is None:
                self.daemon.kill()
                self.daemon.wait(timeout=10)


def _analyze(code: str, rid: str) -> dict:
    return {"op": "analyze", "id": rid, "code": code,
            "transaction_count": 2, "deadline_ms": 120_000}


def _phase_segv(code: str) -> list:
    from mythril_tpu_torch.serve import client

    phase = _Phase("segv", "worker_segv:2")
    try:
        if not phase.wait_for_socket():
            return phase.problems
        replies = client.roundtrip(
            [{"op": "ping", "id": "c-ping"},
             _analyze(code, "c-r1"), _analyze(code, "c-r2"),
             _analyze(code, "c-r3"),
             {"op": "healthz", "id": "c-healthz"},
             {"op": "metrics", "id": "c-metrics"},
             {"op": "shutdown", "id": "c-shutdown"}],
            socket_path=phase.socket_path, timeout=600)
        if not all(reply.get("ok") for reply in replies):
            phase.complain(f"non-ok reply among {replies}")
            return phase.problems
        r1, r2, r3 = replies[1], replies[2], replies[3]
        reports = [json.dumps(r.get("report"), sort_keys=True)
                   for r in (r1, r2, r3)]
        if len(set(reports)) != 1:
            phase.complain("injured request's report is not byte-identical "
                           "to its uninjured peers'")
        if r2.get("issue_count", 0) < 1:
            phase.complain(f"expected >=1 issue from the retried request, "
                           f"got {r2.get('issue_count')}")
        pool = replies[4].get("workers") or {}
        if pool.get("restarts", 0) < 1:
            phase.complain(f"/healthz shows no worker restart: {pool}")
        if pool.get("deaths", 0) < 1:
            phase.complain(f"/healthz shows no worker death: {pool}")
        if pool.get("live", 0) < 1:
            phase.complain(f"/healthz shows no live worker: {pool}")
        if (pool.get("quarantine") or {}).get("quarantined", -1) != 0:
            phase.complain(f"healthy contract was quarantined: {pool}")
        exposition = replies[5].get("exposition", "")
        if "serve_worker_restarts" not in exposition:
            phase.complain("metrics exposition lacks the worker restart "
                           f"counter: {exposition[:400]!r}")
        slog_text = phase.slog_text()
        for marker in ("serve.worker.death", "serve.worker.retry",
                       "worker_segv"):
            if marker not in slog_text:
                phase.complain(f"slog lacks {marker!r}")
        cid = r2.get("correlation_id", "")
        if cid and cid not in slog_text:
            phase.complain(f"injured request's cid {cid!r} absent from slog")
        doc = phase.sidecar()
        quarantined = [key for key, entry in
                       (doc.get("contracts") or {}).items()
                       if entry.get("quarantined")]
        if quarantined:
            phase.complain(f"sidecar quarantined healthy contract(s): "
                           f"{quarantined}")
        phase.finish()
        return phase.problems
    finally:
        if phase.daemon.poll() is None:
            phase.daemon.kill()
            phase.daemon.wait(timeout=10)


def _phase_hang(code: str) -> list:
    from mythril_tpu_torch.serve import client

    phase = _Phase("hang", "worker_hang:1",
                   extra_args=("--heartbeat-ms", "3000"))
    try:
        if not phase.wait_for_socket():
            return phase.problems
        replies = client.roundtrip(
            [_analyze(code, "h-r1"),
             {"op": "healthz", "id": "h-healthz"},
             {"op": "shutdown", "id": "h-shutdown"}],
            socket_path=phase.socket_path, timeout=600)
        if not all(reply.get("ok") for reply in replies):
            phase.complain(f"non-ok reply among {replies}")
            return phase.problems
        if replies[0].get("issue_count", 0) < 1:
            phase.complain("retried request after the hang found no issue")
        pool = replies[1].get("workers") or {}
        if pool.get("deaths", 0) < 1:
            phase.complain(f"/healthz shows no death after the hang: {pool}")
        if "worker_hang" not in phase.slog_text():
            phase.complain("slog lacks the worker_hang classification")
        phase.finish()
        return phase.problems
    finally:
        if phase.daemon.poll() is None:
            phase.daemon.kill()
            phase.daemon.wait(timeout=10)


def _phase_quarantine(code: str) -> list:
    from mythril_tpu_torch.serve import client

    phase = _Phase("quarantine", "worker_segv:1,worker_segv:2")
    try:
        if not phase.wait_for_socket():
            return phase.problems
        replies = client.roundtrip(
            [_analyze(code, "q-r1"), _analyze(code, "q-r2"),
             {"op": "healthz", "id": "q-healthz"},
             {"op": "shutdown", "id": "q-shutdown"}],
            socket_path=phase.socket_path, timeout=600)
        first, second, healthz = replies[0], replies[1], replies[2]
        if first.get("ok"):
            phase.complain(f"double-killed request should fail: {first}")
        elif first.get("error", {}).get("code") != "analysis_failed":
            phase.complain(f"double death reported as "
                           f"{first.get('error')}, want analysis_failed")
        if second.get("ok"):
            phase.complain(f"quarantined contract was served: {second}")
        elif second.get("error", {}).get("code") != "quarantined":
            phase.complain(f"repeat request error is {second.get('error')},"
                           f" want the typed 'quarantined' refusal")
        pool = healthz.get("workers") or {}
        if (pool.get("quarantine") or {}).get("quarantined") != 1:
            phase.complain(f"/healthz quarantine census is not 1: {pool}")
        doc = phase.sidecar()
        entries = doc.get("contracts") or {}
        if not any(entry.get("quarantined") and entry.get("crashes", 0) >= 2
                   for entry in entries.values()):
            phase.complain(f"sidecar lacks the quarantined record: {doc}")
        phase.finish()
        return phase.problems
    finally:
        if phase.daemon.poll() is None:
            phase.daemon.kill()
            phase.daemon.wait(timeout=10)


def main() -> int:
    code = _mini_contract()
    problems = []
    started = time.monotonic()
    for runner in (_phase_segv, _phase_hang, _phase_quarantine):
        problems.extend(runner(code))
    if problems:
        print("torch_chaos_smoke: FAIL\n" + "\n".join(problems),
              file=sys.stderr)
        return 1
    print(f"CHAOS_SMOKE=ok phases=segv,hang,quarantine "
          f"elapsed_s={time.monotonic() - started:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
