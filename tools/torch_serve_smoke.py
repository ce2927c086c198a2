"""Serve-daemon smoke of the PyTorch/CUDA port for its pre-merge gate
(tools/check_torch.sh).

The port's copy of tools/serve_smoke.py, with the same checks, against the
port's daemon; it imports only the port and the standard library. The JAX
tool names the structured log in MYTHRIL_TPU_SLOG; the port reads no
environment, so the daemon is started by tools/torch_loadgen.py's launcher
(``python -m tools.torch_loadgen daemon``), which builds it as
``python -m mythril_tpu_torch serve`` does and takes the log as ``--slog``.

Full process-level lifecycle, host engine and CDCL only so it stays cheap:

1. start the port's daemon (unix-socket mode, warmup on over an empty
   manifest) as a subprocess;
2. wait for the socket, then send ping + one analyze request for the
   mini killable contract + a metrics scrape + shutdown over one client
   connection;
3. require the analyze reply to find the SELFDESTRUCT issue (carrying a
   correlation id that also shows up in the structured log), the metrics
   reply to carry a Prometheus exposition that mentions the request
   counter, and the daemon to exit 0 after the drain.

Prints ``SERVE_SMOKE=ok`` on success; any failure exits non-zero with a
diagnostic. The caller bounds the wall clock (check.sh wraps this in
`timeout`)."""

from __future__ import annotations

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


def main() -> int:
    from mythril_tpu_torch.serve import client

    workdir = tempfile.mkdtemp(prefix="serve_smoke_")
    socket_path = os.path.join(workdir, "serve.sock")
    manifest_path = os.path.join(workdir, "warmset.json")
    slog_path = os.path.join(workdir, "serve.slog")
    daemon = subprocess.Popen(
        [sys.executable, "-m", "tools.torch_loadgen", "daemon",
         "--socket", socket_path, "--manifest", manifest_path,
         "--slog", slog_path],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 90
        while not os.path.exists(socket_path):
            if daemon.poll() is not None:
                print("torch_serve_smoke: daemon died before binding:\n"
                      + daemon.stderr.read().decode(errors="replace"),
                      file=sys.stderr)
                return 1
            if time.monotonic() > deadline:
                print("torch_serve_smoke: socket never appeared",
                      file=sys.stderr)
                return 1
            time.sleep(0.2)

        replies = client.roundtrip(
            [{"op": "ping", "id": "smoke-ping"},
             {"op": "analyze", "id": "smoke-analyze",
              "code": _mini_contract(), "transaction_count": 2,
              "deadline_ms": 120_000},
             {"op": "metrics", "id": "smoke-metrics"},
             {"op": "shutdown", "id": "smoke-shutdown"}],
            socket_path=socket_path, timeout=120)

        problems = []
        if not all(reply.get("ok") for reply in replies):
            problems.append(f"non-ok reply: {replies}")
        analyze = replies[1]
        if analyze.get("issue_count", 0) < 1:
            problems.append(f"expected >=1 issue, got {analyze}")
        if "warm" not in analyze:
            problems.append(f"no warm/cold accounting in {analyze}")
        cid = analyze.get("correlation_id", "")
        if not cid:
            problems.append(f"analyze reply carries no correlation_id: "
                            f"{analyze}")
        scrape = replies[2]
        exposition = scrape.get("exposition", "")
        if "mythril_tpu_serve_requests_total" not in exposition:
            problems.append("metrics exposition lacks the request counter:"
                            f" {exposition[:400]!r}")
        if not str(scrape.get("content_type", "")).startswith("text/plain"):
            problems.append(f"bad metrics content_type in {scrape}")
        try:
            with open(slog_path, encoding="utf-8") as handle:
                slog_text = handle.read()
        except OSError:
            slog_text = ""
        if cid and cid not in slog_text:
            problems.append(f"correlation id {cid!r} absent from slog "
                            f"{slog_path}")
        daemon.wait(timeout=30)
        if daemon.returncode != 0:
            problems.append(f"daemon exited {daemon.returncode}:\n"
                            + daemon.stderr.read().decode(errors="replace"))
        if not os.path.exists(manifest_path) and analyze.get("warm", {}) \
                .get("cold_buckets"):
            problems.append("compiled buckets but wrote no manifest")
        if problems:
            print("torch_serve_smoke: FAIL\n" + "\n".join(problems),
                  file=sys.stderr)
            return 1
        print(f"SERVE_SMOKE=ok issues={analyze['issue_count']} "
              f"elapsed_ms={analyze.get('elapsed_ms')} cid={cid}")
        return 0
    finally:
        if daemon.poll() is None:
            daemon.kill()
            daemon.wait(timeout=10)


if __name__ == "__main__":
    sys.exit(main())
