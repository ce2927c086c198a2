"""`myth-tpu-torch serve`: a persistent analysis service over the port.

A one-shot CLI run pays every start-up cost on each invocation (the
kernel libraries' load, the first run of each SAT bucket, the taint
fixpoint of a repeat contract); the daemon pays them once a process:

* ``protocol``  — JSON-lines request framing + validation (stdlib-only)
* ``service``   — AnalysisService: admission gate, engine lock,
  per-request isolation, warm/cold accounting
* ``warmset``   — persisted manifest of K11 shape buckets + startup
  warmup (``serve.warmup`` trace span)
* ``daemon``    — stdio and unix-socket transport loops
* ``http_shim`` — thin POST shim over the same service
* ``client``    — socket client used by `myth-tpu-torch client`
* ``supervisor``/``worker``/``autoscale`` — the supervised worker pool
* ``admission``/``result_store``/``quarantine`` — the priority queue,
  the content-addressed result store and the poison sidecar

Submodules are imported lazily by the CLI so that client-side commands
never pay the engine import.

The port's copy of mythril_tpu/serve/. Where the JAX package reads a
``MYTHRIL_TPU_*`` knob, the port takes a keyword argument whose default is
the knob's (the module constants below and in each submodule). The
socket, the manifest and the stores live under ``~/.mythril_tpu_torch/``
(:func:`state_dir`), never the JAX daemon's ``~/.mythril_tpu/``, so the
two daemons never share a socket; their file formats are the same, so
either package reads the other's files.
"""

import os

#: the port's state directory under the user's home (the JAX package's
#: is ``.mythril_tpu``, or MYTHRIL_TPU_DIR)
STATE_DIR_NAME = ".mythril_tpu_torch"


def state_dir() -> str:
    """``~/.mythril_tpu_torch``: the default home of the daemon's socket,
    warm-set manifest and sidecar stores."""
    return os.path.join(os.path.expanduser("~"), STATE_DIR_NAME)
