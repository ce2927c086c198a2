"""Transport loops for the serve daemon: stdio and unix socket.

Both speak the JSON-lines protocol (serve/protocol.py) and funnel every
frame through one shared :class:`~.service.AnalysisService` — transports
own bytes and connection lifecycle, the service owns admission,
isolation, and the engine. The socket server takes one reader thread per
connection (the service's in-flight gate bounds concurrent work), stdio
is a single foreground loop. Either exits cleanly when a ``shutdown``
request drains the service.

The port's copy of mythril_tpu/serve/daemon.py. Its default socket is
``~/.mythril_tpu_torch/serve.sock`` (the JAX daemon's is under
``~/.mythril_tpu/``, or MYTHRIL_TPU_SERVE_SOCKET / MYTHRIL_TPU_DIR), so the
two daemons never share a socket.
"""

from __future__ import annotations

import logging
import os
import socket
import sys
import threading
from typing import Optional

from . import protocol, state_dir
from ..observe import slog

log = logging.getLogger(__name__)


def install_sigterm_drain(service) -> None:
    """SIGTERM → graceful drain instead of a hard kill: admission stops
    (new analyzes get a typed ``shutting_down``), the transport loop
    exits, and ``service.shutdown()`` runs the
    service's ``drain_ms`` drain — in-flight and queued
    interactive work finishes, queued bulk is shed, stragglers are
    preempted into checkpoints. No-op off the main thread or on
    platforms without signals."""
    import signal

    def _drain(signum, frame):
        log.info("SIGTERM — draining")
        slog.event("serve.sigterm")
        service.shutting_down.set()

    try:
        signal.signal(signal.SIGTERM, _drain)
    except (ValueError, OSError, AttributeError, RuntimeError):
        pass


def default_socket_path() -> str:
    """~/.mythril_tpu_torch/serve.sock."""
    return os.path.join(state_dir(), "serve.sock")


def serve_stream(service, rfile, wfile) -> int:
    """Serve one bidirectional byte stream until EOF or shutdown.
    Returns the number of frames answered. This is the whole protocol
    loop for stdio mode and for each socket connection."""
    answered = 0
    for item in protocol.iter_requests(rfile):
        reply = service.handle(item)
        wfile.write(protocol.encode(reply).encode("utf-8"))
        wfile.flush()
        answered += 1
        if service.shutting_down.is_set():
            break
    return answered


def serve_stdio(service, stdin=None, stdout=None) -> int:
    """Foreground stdio mode: requests on stdin, replies on stdout
    (logs must go to stderr — the CLI wires that up)."""
    rfile = stdin if stdin is not None else sys.stdin.buffer
    wfile = stdout if stdout is not None else sys.stdout.buffer
    service.startup()
    slog.event("serve.listening", transport="stdio")
    try:
        return serve_stream(service, rfile, wfile)
    finally:
        service.shutdown()
        slog.event("serve.stopped", transport="stdio")


def _connection_worker(service, connection) -> None:
    try:
        with connection:
            rfile = connection.makefile("rb")
            wfile = connection.makefile("wb")
            serve_stream(service, rfile, wfile)
    except (BrokenPipeError, ConnectionResetError):
        pass  # client went away mid-reply; nothing to clean up
    except Exception:
        log.exception("serve connection failed")


def serve_socket(service, socket_path: Optional[str] = None,
                 ready_event: Optional[threading.Event] = None) -> int:
    """Unix-socket mode: accept loop in this thread, one reader thread
    per connection. Blocks until a ``shutdown`` request (or
    KeyboardInterrupt) drains the service; returns the number of
    connections accepted. ``ready_event`` fires once the socket is bound
    and warmup has finished — tests and supervisors wait on it."""
    path = socket_path or default_socket_path()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # the probe/unlink/bind sequence below must be atomic across daemons:
    # two starting at once against the same stale socket could both probe
    # (dead), both unlink, and the second would silently unlink the
    # *first's* freshly bound socket. A held flock on a sidecar lockfile
    # serializes the whole reclaim-and-bind; the lock fd stays open for
    # the daemon's lifetime so a loser fails fast instead of stealing.
    lock_fd = os.open(path + ".lock", os.O_RDWR | os.O_CREAT, 0o600)
    try:
        try:
            import fcntl
            fcntl.flock(lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except ImportError:
            pass  # non-POSIX: fall back to the probe alone
        except OSError:
            raise RuntimeError(
                f"daemon already starting or listening on {path} "
                f"(lock {path}.lock is held)")
        if os.path.exists(path):
            # a live daemon would be reachable; a stale socket file from
            # a crashed one just blocks bind() — probe before unlinking
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                probe.connect(path)
            except OSError:
                log.warning("reclaiming stale socket %s", path)
                os.unlink(path)
            else:
                probe.close()
                raise RuntimeError(f"daemon already listening on {path}")
        server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        server.bind(path)
    except BaseException:
        os.close(lock_fd)
        raise
    accepted = 0
    try:
        os.chmod(path, 0o600)
        server.listen(8)
        server.settimeout(0.25)
        service.startup()
        if ready_event is not None:
            ready_event.set()
        log.info("serving on %s (max_inflight=%d)", path,
                 service.max_inflight)
        slog.event("serve.listening", transport="socket", path=path,
                   max_inflight=service.max_inflight)
        workers = []
        while not service.shutting_down.is_set():
            try:
                connection, _ = server.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            accepted += 1
            worker = threading.Thread(
                target=_connection_worker, args=(service, connection),
                name=f"serve-conn-{accepted}", daemon=True)
            worker.start()
            workers.append(worker)
        for worker in workers:
            worker.join(timeout=5.0)
    except KeyboardInterrupt:
        log.info("interrupted — draining")
    finally:
        service.shutdown()
        server.close()
        slog.event("serve.stopped", transport="socket",
                   connections=accepted)
        try:
            os.unlink(path)
        except OSError:
            pass
        os.close(lock_fd)  # releases the flock
        try:
            os.unlink(path + ".lock")
        except OSError:
            pass
    return accepted
