"""Client side of the serve protocol: connect, send, read replies.

Stdlib-only and torch-free — importing this never touches the engine, so
`myth-tpu-torch client` stays instant even when the daemon is mid-warmup.

Resilience (:func:`request_with_retry`): transport-level failures a
restarting daemon legitimately produces — connection refused, broken
pipe, connection reset, a connection closed before the reply — are
*retryable*; an ``overloaded`` reply is retryable *after honoring its
``retry_after_ms``* hint. Retries use jittered exponential backoff with
a bounded attempt count, so a client neither hammers an overloaded
daemon nor spins forever against a dead one. Protocol-level errors
(``bad_request``, ``quarantined``, ``analysis_failed``…) are never
retried — resending a request the daemon *answered* cannot change the
answer.

The port's copy of mythril_tpu/serve/client.py; it speaks the same
protocol, to the port's default socket unless given another.
"""

from __future__ import annotations

import json
import random
import socket
import time
from typing import Dict, List, Optional

from . import protocol
from .daemon import default_socket_path

#: error codes worth a retry after backoff (the daemon said "later",
#: not "no")
RETRYABLE_CODES = ("busy", "overloaded")


class ServeClientError(RuntimeError):
    """Connection-level failure talking to the daemon (the daemon's own
    typed errors come back as normal replies, not exceptions)."""

    #: True for failure shapes a daemon restart/overload produces —
    #: refused, reset, broken pipe, early close — where a retry against
    #: the (re)started daemon can succeed
    retryable = False


def roundtrip(requests: List[Dict], socket_path: Optional[str] = None,
              timeout: float = 600.0) -> List[Dict]:
    """Send request dicts over one connection; return one reply dict per
    request, in order."""
    path = socket_path or default_socket_path()
    connection = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    connection.settimeout(timeout)
    try:
        connection.connect(path)
    except OSError as error:
        connection.close()
        raise _transport_error(
            f"no daemon at {path} ({error}); start one with "
            f"`myth-tpu-torch serve`", error) from error
    replies: List[Dict] = []
    try:
        with connection:
            wfile = connection.makefile("wb")
            rfile = connection.makefile("rb")
            for request in requests:
                wfile.write(protocol.encode(request).encode("utf-8"))
            wfile.flush()
            connection.shutdown(socket.SHUT_WR)
            for line in rfile:
                line = line.strip()
                if not line:
                    continue
                try:
                    replies.append(json.loads(line))
                except ValueError as error:
                    raise ServeClientError(
                        f"malformed reply from daemon: {error}")
    except socket.timeout as error:
        raise ServeClientError(
            f"daemon did not reply within {timeout:.0f}s") from error
    except OSError as error:
        raise _transport_error(
            f"connection to daemon failed mid-exchange ({error})",
            error) from error
    if len(replies) < len(requests):
        # a daemon dying (or restarting) mid-exchange closes early; the
        # surviving daemon can serve the retry
        error = ServeClientError(
            f"daemon closed the connection after {len(replies)} of "
            f"{len(requests)} replies")
        error.retryable = True
        raise error
    return replies


def _transport_error(message: str, cause: OSError) -> ServeClientError:
    """Wrap an OSError, classifying restart/overload shapes (broken
    pipe, connection reset, connection refused, missing socket) as
    retryable."""
    error = ServeClientError(message)
    error.retryable = isinstance(
        cause, (BrokenPipeError, ConnectionResetError,
                ConnectionRefusedError, ConnectionAbortedError,
                FileNotFoundError))
    return error


def request(payload: Dict, socket_path: Optional[str] = None,
            timeout: float = 600.0) -> Dict:
    """One request, one reply."""
    return roundtrip([payload], socket_path=socket_path,
                     timeout=timeout)[0]


def backoff_ms(attempt: int, retry_after_ms: Optional[float] = None,
               base_ms: float = 100.0, cap_ms: float = 30_000.0,
               rng=random) -> float:
    """Jittered exponential backoff before retry `attempt` (0-based).
    A daemon-supplied ``retry_after_ms`` floors the delay — the hint is
    the daemon's own p95-scaled estimate, so sleeping less just earns
    another shed. Full jitter on the exponential part keeps a burst of
    bounced clients from re-synchronizing into the next burst."""
    exp = min(base_ms * (2 ** attempt), cap_ms)
    delay = rng.uniform(0, exp)
    if retry_after_ms and retry_after_ms > 0:
        delay = max(delay, float(retry_after_ms))
    return min(delay, cap_ms)


def request_with_retry(payload: Dict, socket_path: Optional[str] = None,
                       timeout: float = 600.0, attempts: int = 4,
                       sleep=time.sleep) -> Dict:
    """One request with bounded retries: retryable transport failures
    and ``busy``/``overloaded`` replies back off (honoring the reply's
    ``retry_after_ms``) and try again, up to `attempts` total tries.
    Any other reply — success or typed error — returns as-is."""
    attempts = max(1, int(attempts))
    last_error: Optional[ServeClientError] = None
    for attempt in range(attempts):
        try:
            reply = request(payload, socket_path=socket_path,
                            timeout=timeout)
        except ServeClientError as error:
            if not error.retryable or attempt == attempts - 1:
                raise
            last_error = error
            sleep(backoff_ms(attempt) / 1000.0)
            continue
        error_doc = reply.get("error") or {}
        if reply.get("ok") or error_doc.get("code") not in RETRYABLE_CODES:
            return reply
        if attempt == attempts - 1:
            return reply  # out of attempts: surface the shed reply
        sleep(backoff_ms(attempt,
                         error_doc.get("retry_after_ms")) / 1000.0)
    raise last_error  # unreachable unless attempts exhausted on errors
