"""Fork server for the serve worker pool.

A worker is a fresh interpreter in the JAX package. Here most of a fresh
worker's start is torch's import (seconds on a card's host: PERF.md §5),
and the daemon pays it once for itself before it binds its socket; a
pool that spawned fresh interpreters paid it again for every worker,
scale-up and respawn while requests queued.

So the supervisor starts one fork server as soon as it is built
(``python -m mythril_tpu_torch.serve.forkserver FD``): it imports torch
and the worker's modules, touches no card, and forks one child per
worker. A child runs ``worker.main`` with its own stdin and stdout pipes,
so it is a worker as ``python -m mythril_tpu_torch.serve.worker`` makes
one, and it creates its own CUDA context, as a fresh worker does. The
server is single-threaded and runs no torch operation, so a fork inherits
no lock or thread pool in use.

The server speaks over one ``SOCK_SEQPACKET`` socket pair: a fork request
is the worker's argv as JSON with the child's stdin and stdout pipe ends
attached (SCM_RIGHTS); the server answers ``{"pid": P}`` and, when it
reaps a child, ``{"exited": P, "code": C}`` with the exit status as
``subprocess`` reports it (``-N`` for a signal), so the supervisor
classifies a worker's death as it does a ``Popen``'s. The server exits
when the supervisor closes its end. A worker whose server is gone is
still watched through its pipes; its exit status is then unknown and
reported as 1.

A port-side design: the JAX package's supervisor has no fork server.
"""

from __future__ import annotations

import importlib
import json
import os
import select
import socket
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

#: what the server imports before its first fork: torch and the modules
#: a worker imports up to its first analysis
PRELOAD = ("torch", "mythril_tpu_torch.serve.worker",
           "mythril_tpu_torch.serve.service",
           "mythril_tpu_torch.mythril", "mythril_tpu_torch.analysis.security",
           "mythril_tpu_torch.parallel.frontier")

#: how often the server reaps its children while no request comes, s
REAP_INTERVAL_S = 0.05

#: the exit code of a worker whose server died before reaping it
LOST_EXIT_CODE = 1

_MESSAGE_MAX = 1 << 16


class ForkedProcess:
    """A worker forked by a :class:`ForkServer`, with the part of
    ``subprocess.Popen``'s interface the supervisor uses: ``pid``,
    ``stdin``, ``stdout``, ``returncode``, ``poll``, ``wait``, ``kill``."""

    def __init__(self, server: "ForkServer", pid: int, stdin, stdout):
        self._server = server
        self.pid = pid
        self.stdin = stdin
        self.stdout = stdout
        self.returncode: Optional[int] = None

    def poll(self) -> Optional[int]:
        if self.returncode is None:
            self.returncode = self._server.exit_code(self.pid)
        return self.returncode

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                raise subprocess.TimeoutExpired(f"worker {self.pid}",
                                                timeout)
            self._server.wait_exit(self.pid, left)
        return self.returncode

    def kill(self) -> None:
        if self.poll() is None:
            try:
                os.kill(self.pid, 9)
            except ProcessLookupError:
                pass


class ForkServer:
    """The supervisor's side: starts the server process and asks it for
    workers. One fork request at a time; a reader thread files the
    server's answers and exit reports."""

    def __init__(self, command: Optional[List[str]] = None):
        ours, theirs = socket.socketpair(socket.AF_UNIX,
                                         socket.SOCK_SEQPACKET)
        argv = list(command or [sys.executable, "-m", __name__])
        self.process = subprocess.Popen(
            argv + [str(theirs.fileno())], pass_fds=(theirs.fileno(),),
            stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL)
        theirs.close()
        self._socket = ours
        self._request_lock = threading.Lock()
        self._cond = threading.Condition()
        self._pids: deque = deque()
        self._exits: Dict[int, int] = {}
        self.closed = False
        threading.Thread(target=self._read, name="serve-forkserver",
                         daemon=True).start()

    def _read(self) -> None:
        while True:
            try:
                data = self._socket.recv(_MESSAGE_MAX)
            except OSError:
                data = b""
            with self._cond:
                if not data:
                    self.closed = True
                    self._cond.notify_all()
                    return
                message = json.loads(data)
                if "pid" in message:
                    self._pids.append(message["pid"])
                else:
                    self._exits[message["exited"]] = message["code"]
                self._cond.notify_all()

    def spawn(self, argv: List[str]) -> ForkedProcess:
        """Fork a worker running ``worker.main(argv)``; raises OSError when
        the server is gone."""
        stdin_r, stdin_w = os.pipe()
        stdout_r, stdout_w = os.pipe()
        try:
            with self._request_lock:
                socket.send_fds(self._socket, [json.dumps(argv).encode()],
                                [stdin_r, stdout_w])
                with self._cond:
                    while not self._pids and not self.closed:
                        self._cond.wait()
                    if not self._pids:
                        raise OSError("the worker fork server exited")
                    pid = self._pids.popleft()
        except BaseException:
            os.close(stdin_w)
            os.close(stdout_r)
            raise
        finally:
            os.close(stdin_r)
            os.close(stdout_w)
        return ForkedProcess(self, pid, os.fdopen(stdin_w, "wb", 0),
                             os.fdopen(stdout_r, "rb", 0))

    def exit_code(self, pid: int) -> Optional[int]:
        """A forked worker's exit status; None while it runs."""
        with self._cond:
            if pid in self._exits:
                return self._exits[pid]
            if not self.closed:
                return None
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return LOST_EXIT_CODE
        return None

    def wait_exit(self, pid: int, timeout: Optional[float]) -> None:
        """Block until `pid`'s exit is reported, the server closes, or
        `timeout` passes; a closed server is polled."""
        with self._cond:
            if self.closed:
                self._cond.wait(min(timeout, REAP_INTERVAL_S)
                                if timeout is not None else REAP_INTERVAL_S)
                return
            if pid not in self._exits:
                self._cond.wait(timeout)

    def close(self) -> None:
        """End the server: it exits on the closed socket. Workers it
        forked keep running until their own stdin closes."""
        try:
            self._socket.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._socket.close()
        try:
            self.process.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            self.process.kill()
            self.process.wait(timeout=5.0)


# -- the server process ----------------------------------------------------------------


def _reap(control: socket.socket) -> None:
    while True:
        try:
            pid, status = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return
        control.send(json.dumps({"exited": pid,
                                 "code": os.waitstatus_to_exitcode(status)})
                     .encode())


def _run_worker(argv: List[str], stdin_fd: int, stdout_fd: int) -> int:
    """In the forked child: take the pipes as fds 0 and 1 and run the
    worker as its own process would."""
    os.dup2(stdin_fd, 0)
    os.dup2(stdout_fd, 1)
    os.close(stdin_fd)
    os.close(stdout_fd)
    sys.stdin = open(0, "r", encoding="utf-8", closefd=False)
    sys.stdout = open(1, "w", encoding="utf-8", closefd=False)
    from . import worker

    return worker.main(argv)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    control = socket.socket(fileno=int(argv[0]))
    for name in PRELOAD:
        importlib.import_module(name)
    try:
        while True:
            _reap(control)
            ready, _, _ = select.select([control], [], [], REAP_INTERVAL_S)
            if not ready:
                continue
            data, fds, _, _ = socket.recv_fds(control, _MESSAGE_MAX, 2)
            if not data:
                return 0
            pid = os.fork()
            if pid == 0:
                control.close()
                return _run_worker(json.loads(data), *fds)
            for fd in fds:
                os.close(fd)
            control.send(json.dumps({"pid": pid}).encode())
    except (BrokenPipeError, ConnectionResetError):
        return 0  # the supervisor is gone


if __name__ == "__main__":
    sys.exit(main())
