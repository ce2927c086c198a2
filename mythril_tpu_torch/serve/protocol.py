"""JSON-lines request protocol for the `myth-tpu-torch serve` daemon.

One request per line, one reply per line, UTF-8, newline-terminated —
the same framing over stdin/stdout, a unix socket, or (body-per-request)
the HTTP shim. Kept dependency-free (stdlib only, no torch) so clients and
the protocol unit tests never pay an accelerator import.

Request shape::

    {"id": "r1", "op": "analyze", "code": "6080...", "bin_runtime": false,
     "modules": ["AccidentallyKillable"], "transaction_count": 2,
     "deadline_ms": 60000, "solver": "cdcl", "engine": "host",
     "strategy": "bfs"}

Ops: ``analyze`` (the workload), ``optimize`` (gas superoptimization —
shares analyze's code/solver/deadline/priority validation; replies carry
the OptimizationReport), ``ping`` (liveness), ``status`` (warm-set
and metrics introspection), ``healthz`` (liveness + counters rollup),
``metrics`` (Prometheus exposition + the snapshot-ring tail; never
touches the engine lock), ``shutdown`` (drain and exit). Replies echo
the request ``id`` (auto-assigned ``req-N`` when absent) and carry either
``"ok": true`` plus the payload, or ``"ok": false`` plus a typed error::

    {"id": "r1", "ok": false,
     "error": {"code": "bad_request", "message": "..."}}

Error codes: ``line_too_long``, ``bad_json``, ``bad_request``,
``unknown_op``, ``busy`` (in-flight bound reached — retry later),
``overloaded`` (shed by admission control — the queue is past its
high-water mark or the deadline cannot be met at current depth; the
error object carries ``retry_after_ms``, a backoff hint scaled by
observed p95 service time — see serve/admission.py), ``shutting_down``,
``analysis_failed``, ``quarantined`` (this bytecode has repeatedly
killed worker processes and is refused at admission — see
serve/quarantine.py). Validation failures never kill the connection:
the daemon replies with the error and keeps reading.

``priority`` classes every analyze request for admission and fleet
batch composition: ``interactive`` (the default — latency-sensitive,
dequeues first, never shed while bulk work is queued) or ``bulk``
(throughput traffic that absorbs shedding under overload).

``deadline_ms`` rides the engine's existing deadline-drain substrate: it
becomes the analysis execution timeout, so an over-deadline request
returns a valid-but-partial report (``incomplete: true``) instead of
hanging the queue.

The port's copy of mythril_tpu/serve/protocol.py: the same ops, fields,
error codes and framing, so either package's client talks to either
daemon.
"""

from __future__ import annotations

import itertools
import json
from typing import Dict, Iterator, Optional

#: hard per-line bound: a runtime bytecode tops out around 24 KiB (48 KiB
#: of hex); 8 MiB leaves room for huge inits while bounding a hostile peer
MAX_LINE_BYTES = 8 << 20

OPS = ("analyze", "optimize", "ping", "status", "shutdown", "healthz",
       "metrics")

STRATEGIES = ("dfs", "bfs", "naive-random", "weighted-random",
              "beam-search", "pending")

#: admission classes, best-first (see serve/admission.py)
PRIORITIES = ("interactive", "bulk")

#: one day, matching the CLI's --execution-timeout default ceiling
MAX_DEADLINE_MS = 86_400_000

_AUTO_ID = itertools.count(1)


class ProtocolError(Exception):
    """A request the daemon must answer with a typed error reply."""

    def __init__(self, code: str, message: str,
                 request_id: Optional[object] = None):
        super().__init__(message)
        self.code = code
        self.message = message
        self.request_id = request_id


class Request:
    """One validated request: ``op``, ``id``, and the analyze params
    (normalized, defaults applied) under ``params``."""

    __slots__ = ("op", "id", "params")

    def __init__(self, op: str, request_id: object, params: Dict):
        self.op = op
        self.id = request_id
        self.params = params


def _require(condition: bool, message: str, request_id: object) -> None:
    if not condition:
        raise ProtocolError("bad_request", message, request_id)


def _hex_body(code: str) -> str:
    body = code[2:] if code.lower().startswith("0x") else code
    return body


def parse_request(line) -> Request:
    """Validate one request line (str or bytes). Raises ProtocolError
    (never anything else) on any malformed input."""
    if isinstance(line, bytes):
        if len(line) > MAX_LINE_BYTES:
            raise ProtocolError("line_too_long",
                                f"request exceeds {MAX_LINE_BYTES} bytes")
        try:
            line = line.decode("utf-8")
        except UnicodeDecodeError as error:
            raise ProtocolError("bad_json", f"not valid UTF-8: {error}")
    elif len(line) > MAX_LINE_BYTES:
        raise ProtocolError("line_too_long",
                            f"request exceeds {MAX_LINE_BYTES} bytes")
    try:
        doc = json.loads(line)
    except (json.JSONDecodeError, ValueError) as error:
        raise ProtocolError("bad_json", f"not valid JSON: {error}")
    if not isinstance(doc, dict):
        raise ProtocolError("bad_request", "request must be a JSON object")

    request_id = doc.get("id")
    if request_id is None:
        request_id = f"req-{next(_AUTO_ID)}"
    _require(isinstance(request_id, (str, int)),
             "id must be a string or integer", None)

    op = doc.get("op")
    _require(isinstance(op, str), "op is required", request_id)
    if op not in OPS:
        raise ProtocolError("unknown_op",
                            f"unknown op {op!r}; expected one of {OPS}",
                            request_id)
    if op not in ("analyze", "optimize"):
        return Request(op, request_id, {})

    code = doc.get("code")
    _require(isinstance(code, str) and code.strip() != "",
             "analyze requires a non-empty hex 'code' field", request_id)
    body = _hex_body(code.strip())
    _require(len(body) % 2 == 0, "code has an odd hex digit count",
             request_id)
    try:
        bytes.fromhex(body)
    except ValueError:
        raise ProtocolError("bad_request", "code is not valid hex",
                            request_id)

    params: Dict = {"code": code.strip()}
    params["bin_runtime"] = bool(doc.get("bin_runtime", False))

    modules = doc.get("modules")
    if modules is not None:
        _require(isinstance(modules, list)
                 and all(isinstance(m, str) for m in modules),
                 "modules must be a list of module names", request_id)
    params["modules"] = modules

    tx_count = doc.get("transaction_count", 2)
    _require(isinstance(tx_count, int) and not isinstance(tx_count, bool)
             and 1 <= tx_count <= 16,
             "transaction_count must be an integer in [1, 16]", request_id)
    params["transaction_count"] = tx_count

    strategy = doc.get("strategy", "bfs")
    _require(strategy in STRATEGIES,
             f"strategy must be one of {STRATEGIES}", request_id)
    params["strategy"] = strategy

    solver = doc.get("solver")
    _require(solver in (None, "cdcl", "jax"),
             "solver must be 'cdcl' or 'jax'", request_id)
    params["solver"] = solver

    engine = doc.get("engine")
    _require(engine in (None, "host", "tpu"),
             "engine must be 'host' or 'tpu'", request_id)
    params["engine"] = engine

    deadline_ms = doc.get("deadline_ms")
    if deadline_ms is not None:
        _require(isinstance(deadline_ms, (int, float))
                 and not isinstance(deadline_ms, bool)
                 and 0 < deadline_ms <= MAX_DEADLINE_MS,
                 f"deadline_ms must be in (0, {MAX_DEADLINE_MS}]",
                 request_id)
    params["deadline_ms"] = deadline_ms

    max_depth = doc.get("max_depth", 128)
    _require(isinstance(max_depth, int) and not isinstance(max_depth, bool)
             and 1 <= max_depth <= 4096,
             "max_depth must be an integer in [1, 4096]", request_id)
    params["max_depth"] = max_depth

    priority = doc.get("priority", "interactive")
    _require(priority in PRIORITIES,
             f"priority must be one of {PRIORITIES}", request_id)
    params["priority"] = priority

    return Request(op, request_id, params)


def encode(reply: Dict) -> str:
    """One newline-terminated reply line (newline-free by construction:
    json.dumps never emits raw newlines)."""
    return json.dumps(reply, sort_keys=True) + "\n"


def ok_reply(request_id: object, **payload) -> Dict:
    reply = {"id": request_id, "ok": True}
    reply.update(payload)
    return reply


def error_reply(request_id: object, code: str, message: str) -> Dict:
    return {"id": request_id, "ok": False,
            "error": {"code": code, "message": message}}


def read_lines(stream) -> Iterator[bytes]:
    """Yield newline-delimited frames from a binary stream, enforcing
    MAX_LINE_BYTES mid-read (an unbounded line is truncated — its parse
    then fails loudly as line_too_long — instead of buffering forever)."""
    # read1 (BufferedReader, socket makefiles) returns as soon as ANY
    # bytes arrive; plain .read(n) would block until n bytes or EOF and
    # deadlock an interactive client that awaits each reply before
    # sending its next request
    read = getattr(stream, "read1", stream.read)
    buffer = bytearray()
    overflow = False
    while True:
        chunk = read(65536)
        if not chunk:
            break
        start = 0
        while True:
            newline = chunk.find(b"\n", start)
            if newline < 0:
                if not overflow:
                    buffer.extend(chunk[start:])
                    if len(buffer) > MAX_LINE_BYTES:
                        overflow = True
                break
            if overflow:
                yield bytes(buffer[:MAX_LINE_BYTES + 1])
                overflow = False
            else:
                buffer.extend(chunk[start:newline])
                yield bytes(buffer)
            buffer.clear()
            start = newline + 1
    if buffer and not overflow:
        yield bytes(buffer)
    elif overflow:
        yield bytes(buffer[:MAX_LINE_BYTES + 1])


def iter_requests(stream) -> Iterator[object]:
    """Parse frames from a binary stream: yields Request objects and, for
    malformed frames, the ProtocolError to reply with (the stream stays
    usable — one bad line is one error reply, not a dropped connection)."""
    for frame in read_lines(stream):
        if not frame.strip():
            continue
        try:
            yield parse_request(frame)
        except ProtocolError as error:
            yield error
