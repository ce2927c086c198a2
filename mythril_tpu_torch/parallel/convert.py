"""Carry state between the JAX package and the port, leaf for leaf.

`from_numpy(kind, tree)` takes one of the JAX package's pytrees with every
leaf already turned into a numpy array (`np.asarray` of each leaf) and
builds the port's StateBatch / SymPlanes / Arena / DeviceScheduler (with
its Telemetry, and a sharded one's vector tops and steal counters), or the SAT lane's SolverState / DeviceProblem (from JAX
`_SolverState` / `_Problem`, whose host-only fields are not carried), on
a device. `to_numpy(tree)` goes back. Every leaf keeps
the JAX dtype and shape byte for byte: uint32 limb leaves ride as int32
tensors with the same bytes and come back as uint32. The JAX package
itself is never imported; the tree is read by field name."""

from __future__ import annotations

import numpy as np
import torch

from .. import device as _device
from .arena import Arena
from .batch import U32_FIELDS, StateBatch, to_tensor
from .device_solver import DeviceProblem, SolverState
from .symstep import DeviceScheduler, SymPlanes, Telemetry

KINDS = {"state": StateBatch, "planes": SymPlanes, "arena": Arena,
         "sched": DeviceScheduler, "telemetry": Telemetry,
         "sat_state": SolverState, "sat_problem": DeviceProblem}

#: (kind, field) pairs whose JAX dtype is uint32
_U32 = {("state", f) for f in U32_FIELDS} | {("arena", "const_vals")}

_SCHED_TREES = {"stack_state": "state", "esc_state": "state",
                "stack_planes": "planes", "esc_planes": "planes",
                "telemetry": "telemetry"}


def _kind_of(tree) -> str:
    for kind, cls in KINDS.items():
        if isinstance(tree, cls):
            return kind
    raise TypeError(f"not a port pytree: {type(tree).__name__}")


def from_numpy(kind: str, tree, device=None):
    """JAX pytree of numpy leaves -> the port's pytree on `device`."""
    dev = _device.resolve(device)
    cls = KINDS[kind]
    out = {}
    for field in cls._fields:
        leaf = getattr(tree, field, None)
        if leaf is None:
            if field not in cls._field_defaults:
                raise ValueError(f"{kind}.{field} is missing")
            out[field] = None
        elif kind == "sched" and field in _SCHED_TREES:
            out[field] = from_numpy(_SCHED_TREES[field], leaf, dev)
        else:
            out[field] = to_tensor(np.asarray(leaf), dev)
    return cls(**out)


def to_numpy(tree):
    """Port pytree -> the same NamedTuple of numpy leaves in JAX dtypes."""
    kind = _kind_of(tree)
    out = {}
    for field in type(tree)._fields:
        leaf = getattr(tree, field)
        if leaf is None:
            out[field] = None
        elif isinstance(leaf, tuple):
            out[field] = to_numpy(leaf)
        else:
            array = leaf.detach().cpu().numpy()
            if (kind, field) in _U32:
                array = array.view(np.uint32)
            out[field] = array
    return type(tree)(**out)


def leaves(tree):
    """(path, numpy leaf) pairs of a numpy pytree, nested trees flattened:
    the comparison order for parity checks."""
    for field in tree._fields:
        leaf = getattr(tree, field)
        if leaf is None:
            continue
        if isinstance(leaf, tuple) and hasattr(leaf, "_fields"):
            for path, sub in leaves(leaf):
                yield f"{field}.{path}", sub
        else:
            yield field, leaf


def clone(tree):
    """Deep copy of a port pytree (every tensor cloned)."""
    values = []
    for leaf in tree:
        if leaf is None:
            values.append(None)
        elif isinstance(leaf, torch.Tensor):
            values.append(leaf.clone())
        else:
            values.append(clone(leaf))
    return type(tree)(*values)
