"""Host-phase analysis checkpoints.

The device frontier has dense .npz snapshots (parallel/frontier.py
save_checkpoint); this module covers the phase where most analyses
actually live: the host worklist.

What a checkpoint holds: the open world states, the pending worklist (plus
the in-flight state at a mid-transaction save), the transaction index, and
the CALLBACK detectors' accumulated issues/caches — everything needed for a
killed `analyze` to resume and emit the identical final report. GlobalStates
are plain Python object graphs and the term DAG re-interns on unpickle
(smt/terms.py Term.__reduce__), so pickle is sufficient and exact.

Writes are crash-safe (tmp + fsync + os.replace, then a best-effort
directory fsync): preemption or power loss mid-write never corrupts the
only checkpoint — either the old file or the complete new one survives.

Known limit: laser-plugin INTERNAL state (e.g. the dependency pruner's
per-iteration counters) is not serialized — a mid-transaction resume
re-fires the tx lifecycle hooks but plugin counters restart, so pruning
heuristics may explore slightly differently than the uninterrupted run;
detector issues and tx-boundary resumes are exact.

The port's copy of mythril_tpu/support/checkpoint.py. The JAX package
reads MYTHRIL_TPU_CHECKPOINT_STATES; here the state cadence is the
`state_interval` argument of `checkpoint_state_interval` (default
SAVE_INTERVAL_STATES, 2000), which `configure` sets. A checkpoint loads
through `_PortUnpickler`, which resolves only the port's own classes,
safe builtins, `collections`, `copyreg` and numpy: a payload that names
anything else (the JAX package's classes, say) is refused like a truncated
one — a warning, then a fresh run — and never imports a module into the
process. Spans and metrics go to the port's tracer and registry
(observe/)."""

from __future__ import annotations

import io
import logging
import os
import pickle
import re
import sys
import time
from typing import Optional

from ..observe import metrics, trace

log = logging.getLogger(__name__)

FORMAT_VERSION = 2  # v2: payloads are namespaced by contract id
#: seconds between periodic mid-transaction saves
SAVE_INTERVAL_S = 15.0
#: states executed between periodic mid-transaction saves (the JAX
#: package's MYTHRIL_TPU_CHECKPOINT_STATES default; the time cadence still
#: applies)
SAVE_INTERVAL_STATES = 2000

#: every key restore_into_laser dereferences — validated at load so a
#: truncated or foreign payload degrades to a fresh run instead of raising
#: a KeyError deep inside resume
REQUIRED_KEYS = ("version", "tx_index", "open_states", "work_list",
                 "executed_nodes", "total_states", "detectors",
                 "contract_id")

#: the state cadence `checkpoint_state_interval` returns
_settings = {"state_interval": SAVE_INTERVAL_STATES}


def configure(state_interval: int = SAVE_INTERVAL_STATES) -> None:
    """Set the periodic save's state cadence (MYTHRIL_TPU_CHECKPOINT_STATES
    in the JAX package)."""
    _settings["state_interval"] = state_interval


def checkpoint_state_interval() -> int:
    return int(_settings["state_interval"])


#: the top-level packages a checkpoint's classes may come from
_ALLOWED_ROOTS = ("mythril_tpu_torch", "collections", "copyreg", "numpy")
#: builtins a payload may never name: they run code or reach the process
_DENIED_BUILTINS = frozenset((
    "eval", "exec", "compile", "open", "__import__", "getattr", "setattr",
    "delattr", "input", "breakpoint", "globals", "locals", "vars", "exit",
    "quit", "help", "memoryview"))


class ForeignPayload(pickle.UnpicklingError):
    """A checkpoint names a class outside the port (or a denied builtin)."""


class _PortUnpickler(pickle.Unpickler):
    """An Unpickler that resolves only what a port checkpoint holds. A
    module outside the allowed roots is refused before it is imported, so
    a checkpoint written by another package never brings that package
    into this process."""

    def find_class(self, module: str, name: str):
        root = module.split(".", 1)[0]
        if module == "builtins":
            if name in _DENIED_BUILTINS:
                raise ForeignPayload(f"builtins.{name} is not allowed")
        elif root not in _ALLOWED_ROOTS:
            raise ForeignPayload(
                f"{module}.{name}: not a class of mythril_tpu_torch")
        return super().find_class(module, name)


def port_loads(data: bytes):
    """`pickle.loads` through `_PortUnpickler`."""
    return _PortUnpickler(io.BytesIO(data)).load()


def fsync_replace(tmp: str, path: str) -> None:
    """Durably promote `tmp` to `path`: flush the file's bytes to disk
    before the rename, then best-effort fsync the directory so the rename
    itself survives power loss (not just process death)."""
    with open(tmp, "rb+") as handle:
        os.fsync(handle.fileno())
    os.replace(tmp, path)
    try:
        dir_fd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
    except OSError:
        pass  # non-POSIX/odd filesystems: rename atomicity still holds


def request_checkpoint_path(base_dir: str, request_key: str) -> str:
    """Request-scoped checkpoint path for a serve worker job: one file
    per in-flight request under the supervisor's scratch dir, so a
    worker cut down mid-analysis leaves a checkpoint its one retry can
    resume from — and two concurrent requests (even for the same
    contract) never share a file. The key is sanitized to a safe
    filename; the caller deletes the file after the request's final
    outcome."""
    safe = re.sub(r"[^A-Za-z0-9._-]", "_", request_key)[:80] or "req"
    return os.path.join(base_dir, f"req-{safe}.ckpt")


def _collect_detector_state():
    from ..analysis.module.loader import ModuleLoader

    state = {}
    for module in ModuleLoader().get_detection_modules():
        state[module.name] = {
            "issues": list(module.issues),
            "cache": set(getattr(module, "cache", ()) or ()),
        }
    return state


def _restore_detector_state(state) -> None:
    from ..analysis.module.loader import ModuleLoader

    for module in ModuleLoader().get_detection_modules():
        saved = state.get(module.name)
        if saved is None:
            continue
        module.issues = list(saved["issues"])
        if hasattr(module, "cache"):
            module.cache = set(saved["cache"])


def save_host_checkpoint(path: str, laser, tx_index: int,
                         in_flight=None) -> None:
    payload = {
        "version": FORMAT_VERSION,
        "contract_id": getattr(laser, "contract_id", ""),
        "tx_index": tx_index,
        "open_states": list(laser.open_states),
        "work_list": ([in_flight] if in_flight is not None else [])
        + list(laser.work_list),
        "executed_nodes": laser.executed_nodes,
        "total_states": laser.total_states,
        "detectors": _collect_detector_state(),
    }
    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 200_000))  # deep store/constraint chains
    started = time.perf_counter()
    try:
        with trace.span("checkpoint.save", kind="host", tx_index=tx_index,
                        open_states=len(payload["open_states"]),
                        work_list=len(payload["work_list"])):
            tmp = f"{path}.tmp"
            with open(tmp, "wb") as handle:
                pickle.dump(payload, handle, protocol=4)
            fsync_replace(tmp, path)
    finally:
        sys.setrecursionlimit(limit)
    metrics.inc("checkpoint.saves")
    metrics.observe("checkpoint.write_ms",
                    (time.perf_counter() - started) * 1000.0)


def load_host_checkpoint(path: str,
                         expected_contract_id: Optional[str] = None
                         ) -> Optional[dict]:
    """Returns the payload, or None when the file is absent/corrupt/foreign
    (a bad checkpoint must degrade to a fresh run, never crash the run).

    `expected_contract_id` guards fleet resumes: a checkpoint written for
    another contract in the corpus must not restore into this one's laser."""
    if not os.path.exists(path):
        return None
    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 200_000))
    try:
        with trace.span("checkpoint.load", kind="host"), \
                open(path, "rb") as handle:
            payload = _PortUnpickler(handle).load()
        if not isinstance(payload, dict):
            log.warning("checkpoint %s is not a payload dict (%s); ignoring",
                        path, type(payload).__name__)
            return None
        if payload.get("version") != FORMAT_VERSION:
            log.warning("checkpoint %s has format %s (want %s); ignoring",
                        path, payload.get("version"), FORMAT_VERSION)
            return None
        missing = [key for key in REQUIRED_KEYS if key not in payload]
        if missing:
            log.warning("checkpoint %s is missing required keys %s; ignoring",
                        path, missing)
            return None
        if expected_contract_id is not None and \
                payload["contract_id"] != expected_contract_id:
            log.warning(
                "checkpoint %s belongs to contract %r, not %r; ignoring",
                path, payload["contract_id"], expected_contract_id)
            return None
        return payload
    except Exception as error:
        log.warning("cannot load checkpoint %s (%s); starting fresh",
                    path, error)
        return None
    finally:
        sys.setrecursionlimit(limit)


def restore_into_laser(payload: dict, laser) -> tuple:
    """Apply a loaded payload onto a fresh LaserEVM. Returns
    (start_tx_index, pending_work_list)."""
    laser.open_states = payload["open_states"]
    laser.executed_nodes = payload["executed_nodes"]
    laser.total_states = payload["total_states"]
    _restore_detector_state(payload["detectors"])
    log.info("resumed host checkpoint: tx %d, %d open states, %d pending "
             "worklist states", payload["tx_index"],
             len(payload["open_states"]), len(payload["work_list"]))
    return payload["tx_index"], payload["work_list"]
