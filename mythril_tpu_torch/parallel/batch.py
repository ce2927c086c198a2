"""StateBatch: the frontier as a structure of tensors (port of
mythril_tpu/parallel/batch.py).

The leading axis of every field is the lane axis. Field order, shapes and
bytes are the JAX package's; the uint32 limb fields (stack, storage and
tstore tables, env words) are held as int32 tensors with the same bytes,
since torch's uint32 arithmetic coverage is thin. `convert.py` moves whole
pytrees between the two packages."""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import device as _device
from . import words

# lane status values
RUNNING, STOPPED, RETURNED, REVERTED, ERRORED, ESCAPED = 0, 1, 2, 3, 4, 5
# symbolic-frontier statuses: paused at a symbolic JUMPI (FORKING); free (DEAD)
FORKING, DEAD = 6, 7

STATUS_NAMES = {
    RUNNING: "running", STOPPED: "stop", RETURNED: "return",
    REVERTED: "revert", ERRORED: "error", ESCAPED: "escape",
    FORKING: "forking", DEAD: "dead",
}

ENV_FIELDS = ("address", "caller", "origin", "callvalue", "gasprice",
              "coinbase", "timestamp", "number", "prevrandao",
              "block_gaslimit", "chainid", "basefee", "selfbalance")


class StateBatch(NamedTuple):
    """All-lanes EVM machine state (batch.py:39-83 of the JAX package)."""

    stack: torch.Tensor        # int32[B, S, 16] (uint32 limb bytes)
    sp: torch.Tensor           # int32[B]
    pc: torch.Tensor           # int32[B]
    gas_used: torch.Tensor     # int64[B]
    gas_limit: torch.Tensor    # int64[B]
    status: torch.Tensor       # int32[B]
    memory: torch.Tensor       # uint8[B, M]
    msize: torch.Tensor        # int32[B]
    code: torch.Tensor         # uint8[B, C]
    code_len: torch.Tensor     # int32[B]
    jumpdest: torch.Tensor     # bool[B, C]
    calldata: torch.Tensor     # uint8[B, D]
    calldata_len: torch.Tensor  # int32[B]
    retdata: torch.Tensor      # uint8[B, R]
    retdata_len: torch.Tensor  # int32[B]
    storage_keys: torch.Tensor  # int32[B, K, 16]
    storage_vals: torch.Tensor  # int32[B, K, 16]
    storage_used: torch.Tensor  # bool[B, K]
    tstore_keys: torch.Tensor  # int32[B, T, 16]
    tstore_vals: torch.Tensor  # int32[B, T, 16]
    tstore_used: torch.Tensor  # bool[B, T]
    address: torch.Tensor      # env words, int32[B, 16] each
    caller: torch.Tensor
    origin: torch.Tensor
    callvalue: torch.Tensor
    gasprice: torch.Tensor
    coinbase: torch.Tensor
    timestamp: torch.Tensor
    number: torch.Tensor
    prevrandao: torch.Tensor
    block_gaslimit: torch.Tensor
    chainid: torch.Tensor
    basefee: torch.Tensor
    selfbalance: torch.Tensor

    @property
    def n_lanes(self) -> int:
        return self.stack.shape[0]


#: fields whose JAX dtype is uint32 (held here as int32 with the same bytes)
U32_FIELDS = frozenset(("stack", "storage_keys", "storage_vals",
                        "tstore_keys", "tstore_vals") + ENV_FIELDS)


class LaneSpec:
    """Host-side description of one execution."""

    def __init__(self, code: bytes, calldata: bytes = b"",
                 storage: Optional[Dict[int, int]] = None,
                 gas_limit: int = 10_000_000, address: int = 0,
                 caller: int = 0, origin: int = 0, callvalue: int = 0,
                 gasprice: int = 0, coinbase: int = 0, timestamp: int = 0,
                 number: int = 0, prevrandao: int = 0,
                 block_gaslimit: int = 0, chainid: int = 1, basefee: int = 0,
                 selfbalance: int = 0):
        self.code = code
        self.calldata = calldata
        self.storage = dict(storage or {})
        self.gas_limit = gas_limit
        self.address = address
        self.caller = caller
        self.origin = origin
        self.callvalue = callvalue
        self.gasprice = gasprice
        self.coinbase = coinbase
        self.timestamp = timestamp
        self.number = number
        self.prevrandao = prevrandao
        self.block_gaslimit = block_gaslimit
        self.chainid = chainid
        self.basefee = basefee
        self.selfbalance = selfbalance


def next_pow2(value: int, floor: int = 1) -> int:
    """Smallest power of two >= max(value, floor)."""
    capacity = floor
    while capacity < value:
        capacity *= 2
    return capacity


def shard_count(n_lanes: int, requested: int) -> int:
    """Validated logical-shard count for an `n_lanes`-wide frontier: the
    lane axis splits into `requested` equal blocks when that divides it,
    else 1 (single shard)."""
    if requested <= 1 or n_lanes % requested:
        return 1
    return int(requested)


def to_tensor(array: np.ndarray, device) -> torch.Tensor:
    """numpy leaf -> torch tensor with the same bytes (uint32 -> int32)."""
    array = np.array(array, order="C")  # a copy; keeps 0-d leaves 0-d
    if array.dtype == np.uint32:
        array = array.view(np.int32)
    return torch.from_numpy(array).to(device)


#: alignment of each leaf's slab in a flat row block
ROW_SLAB_ALIGN = 16


def row_layout(leaves, n: int):
    """The flat block of `n` full rows of `leaves` (tensors with the lane
    axis first), leaf-major, each leaf's slab 16-byte aligned: ([(dtype,
    shape, strides, element offset)] per leaf, total bytes)."""
    slabs, offset = [], 0
    for leaf in leaves:
        shape = (n,) + tuple(leaf.shape[1:])
        strides = [1]
        for dim in reversed(shape[1:]):
            strides.insert(0, strides[0] * dim)
        size = leaf.element_size()
        slabs.append((leaf.dtype, shape, tuple(strides), offset // size))
        nbytes = math.prod(shape) * size
        offset += -(-nbytes // ROW_SLAB_ALIGN) * ROW_SLAB_ALIGN
    return slabs, offset


def row_views(flat: torch.Tensor, slabs) -> list:
    """The contiguous leaf views of a flat uint8 row block laid out by
    `row_layout`."""
    typed = {}
    views = []
    for dtype, shape, strides, offset in slabs:
        view = typed.get(dtype)
        if view is None:
            view = typed[dtype] = flat.view(dtype).as_strided
        views.append(view(shape, strides, offset))
    return views


def _jumpdest_bitmap(code: bytes, capacity: int) -> np.ndarray:
    """Valid jump-target byte offsets (0x5b outside PUSH immediates)."""
    bitmap = np.zeros(capacity, dtype=bool)
    i = 0
    while i < len(code):
        op = code[i]
        if op == 0x5B:
            bitmap[i] = True
        if 0x60 <= op <= 0x7F:
            i += op - 0x5F
        i += 1
    return bitmap


def build_batch(specs, stack_slots: int = 96, memory_bytes: int = 4096,
                calldata_bytes: int = 512, retdata_bytes: int = 512,
                storage_slots: int = 64, tstore_slots: int = 8,
                device=None) -> StateBatch:
    """Pack host LaneSpecs into one dense StateBatch on `device` (the card
    unless the caller passes "cpu"). Code and calldata capacities are
    bucketed to powers of two, at least 256, as in the JAX package."""
    dev = _device.resolve(device)
    n = len(specs)
    code_cap = next_pow2(max(1, max(len(s.code) for s in specs)), floor=256)
    calldata_cap = next_pow2(max(calldata_bytes,
                                 max(len(s.calldata) for s in specs)),
                             floor=256)

    code = np.zeros((n, code_cap), dtype=np.uint8)
    jumpdest = np.zeros((n, code_cap), dtype=bool)
    code_len = np.zeros(n, dtype=np.int32)
    calldata = np.zeros((n, calldata_cap), dtype=np.uint8)
    calldata_len = np.zeros(n, dtype=np.int32)
    storage_keys = np.zeros((n, storage_slots, words.NLIMBS), dtype=np.uint32)
    storage_vals = np.zeros((n, storage_slots, words.NLIMBS), dtype=np.uint32)
    storage_used = np.zeros((n, storage_slots), dtype=bool)
    gas_limit = np.zeros(n, dtype=np.int64)
    env = {f: np.zeros((n, words.NLIMBS), dtype=np.uint32) for f in ENV_FIELDS}

    for i, spec in enumerate(specs):
        code[i, :len(spec.code)] = np.frombuffer(spec.code, dtype=np.uint8)
        code_len[i] = len(spec.code)
        jumpdest[i] = _jumpdest_bitmap(spec.code, code_cap)
        calldata[i, :len(spec.calldata)] = np.frombuffer(spec.calldata,
                                                         dtype=np.uint8)
        calldata_len[i] = len(spec.calldata)
        if len(spec.storage) > storage_slots:
            raise ValueError("initial storage exceeds storage_slots")
        for slot_index, (key, value) in enumerate(sorted(spec.storage.items())):
            storage_keys[i, slot_index] = words.from_int(key)
            storage_vals[i, slot_index] = words.from_int(value)
            storage_used[i, slot_index] = True
        gas_limit[i] = min(spec.gas_limit, 2**62)
        for field in ENV_FIELDS:
            env[field][i] = words.from_int(getattr(spec, field))

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return StateBatch(
        stack=zeros((n, stack_slots, words.NLIMBS), torch.int32),
        sp=zeros(n, torch.int32),
        pc=zeros(n, torch.int32),
        gas_used=zeros(n, torch.int64),
        gas_limit=to_tensor(gas_limit, dev),
        status=zeros(n, torch.int32),
        memory=zeros((n, memory_bytes), torch.uint8),
        msize=zeros(n, torch.int32),
        code=to_tensor(code, dev),
        code_len=to_tensor(code_len, dev),
        jumpdest=to_tensor(jumpdest, dev),
        calldata=to_tensor(calldata, dev),
        calldata_len=to_tensor(calldata_len, dev),
        retdata=zeros((n, retdata_bytes), torch.uint8),
        retdata_len=zeros(n, torch.int32),
        storage_keys=to_tensor(storage_keys, dev),
        storage_vals=to_tensor(storage_vals, dev),
        storage_used=to_tensor(storage_used, dev),
        tstore_keys=zeros((n, tstore_slots, words.NLIMBS), torch.int32),
        tstore_vals=zeros((n, tstore_slots, words.NLIMBS), torch.int32),
        tstore_used=zeros((n, tstore_slots), torch.bool),
        **{f: to_tensor(env[f], dev) for f in ENV_FIELDS},
    )


def extract_storage(state: StateBatch, lane: int) -> Dict[int, int]:
    """Host-side: one lane's storage table as a dict."""
    used = state.storage_used[lane].cpu().numpy()
    keys = words.to_ints(state.storage_keys[lane])
    vals = words.to_ints(state.storage_vals[lane])
    return {int(keys[i]): int(vals[i]) for i in range(len(used)) if used[i]}


def extract_stack(state: StateBatch, lane: int):
    """Host-side: one lane's stack, bottom first."""
    depth = int(state.sp[lane])
    if not depth:
        return []
    return [int(v) for v in words.to_ints(state.stack[lane, :depth])]


def extract_retdata(state: StateBatch, lane: int) -> bytes:
    length = int(state.retdata_len[lane])
    return bytes(state.retdata[lane, :length].cpu().tolist())
