"""Expression arena, device half (port of mythril_tpu/parallel/arena.py:1-163).

A symbolic word on the device is one int32: an index into append-only arena
tables. Building an expression is a scatter write plus a bump of the
allocation pointer. Node ids come from a rank (exclusive prefix count) of the
lanes that want a node, never from atomics, so ids and lane order equal the
JAX package's.

On CUDA tensors `alloc_rows`/`alloc_consts` launch kernel K3
(`kernels/arena_alloc.cu`, one block-wide scan, updating the arena in place)
and `fetch_delta` launches kernel K8 (`kernels/arena_delta.cu`); on CPU
tensors they run the `*_reference` twins.

`HostArena` is the host mirror of the arena tables (arena.py:209-298): only
rows allocated since the last refresh cross to the host, in power-of-two
buckets, and the copy of a drain overlaps the next chunk (pinned buffers,
non-blocking copies, one CUDA event). Term conversion (`to_term`) needs the
SMT layer and is not ported yet."""

from __future__ import annotations

import itertools
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import device as _device
from . import words

I32 = torch.int32

# -- special node tags (beyond EVM opcode bytes) --------------------------------------
CONST = 0x100   # imm = const-pool index
VAR = 0x101     # imm = var class, imm2 = qualifier

# -- var classes ----------------------------------------------------------------------
V_CALLDATA_WORD = 1   # imm2 = byte offset; 32-byte word at offset
V_CALLDATASIZE = 2
V_CALLER = 3
V_ORIGIN = 4
V_CALLVALUE = 5
V_GASPRICE = 6
V_TIMESTAMP = 7
V_NUMBER = 8
V_COINBASE = 9
V_PREVRANDAO = 11
V_BASEFEE = 12
V_HOST_TERM = 15

#: var classes whose value a miner/attacker can steer
PREDICTABLE_CLASSES = frozenset({V_TIMESTAMP, V_NUMBER, V_COINBASE,
                                 V_PREVRANDAO})

#: class bitmask of conditions that must visit the host at a JUMPI
PREDICTABLE_MASK = 0
for _cls in PREDICTABLE_CLASSES | {V_ORIGIN}:
    PREDICTABLE_MASK |= 1 << _cls


class Arena(NamedTuple):
    op: torch.Tensor          # int32[CAP]
    a: torch.Tensor           # int32[CAP]
    b: torch.Tensor           # int32[CAP]
    c: torch.Tensor           # int32[CAP]
    imm: torch.Tensor         # int32[CAP]
    imm2: torch.Tensor        # int32[CAP]
    cls: torch.Tensor         # int32[CAP] var-class bitmask of the node's cone
    n: torch.Tensor           # int32[] next free node id
    const_vals: torch.Tensor  # int32[CCAP, 16] (uint32 limb bytes)
    n_const: torch.Tensor     # int32[]

    @property
    def capacity(self) -> int:
        return self.op.shape[0]


def new_arena(capacity: int = 1 << 22, const_capacity: int = 1 << 18,
              device=None) -> Arena:
    dev = _device.resolve(device)

    def col():
        return torch.zeros(capacity, dtype=I32, device=dev)

    return Arena(
        op=col(), a=col(), b=col(), c=col(), imm=col(), imm2=col(),
        cls=col(),
        n=torch.tensor(1, dtype=I32, device=dev),  # node 0 = "concrete"
        const_vals=torch.zeros((const_capacity, words.NLIMBS), dtype=I32,
                               device=dev),
        n_const=torch.tensor(0, dtype=I32, device=dev),
    )


def _rank(want: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(want.to(torch.int64), 0) - 1


def alloc_rows_reference(arena: Arena, want, op, a, b, c, imm, imm2):
    """Plain twin of kernel K3's node allocation: one node per lane where
    `want`, written into the arena in place; returns (arena, ids int32[B]
    (0 where not wanted or out of capacity), overflow bool[B])."""
    cap = arena.capacity
    ids = arena.n.to(torch.int64) + _rank(want)
    overflow = want & (ids >= cap)
    ok = want & ~overflow
    op, a, b, c, imm, imm2 = (torch.as_tensor(v, device=want.device)
                              .to(torch.int64).expand(want.shape)
                              for v in (op, a, b, c, imm, imm2))
    var_bit = torch.ones_like(imm) << imm.clamp(0, 30)

    def at(col, idx):  # JAX gathers clamp out-of-range indices
        return col[idx.clamp(0, cap - 1)].to(torch.int64)

    child_cls = at(arena.cls, a) | at(arena.cls, b) | at(arena.cls, c)
    cls = torch.where(op == VAR, var_bit,
                      torch.where(op == CONST, 0, child_cls))

    rows = torch.nonzero(ok).flatten()
    for col, values in ((arena.op, op), (arena.a, a), (arena.b, b),
                        (arena.c, c), (arena.imm, imm), (arena.imm2, imm2),
                        (arena.cls, cls)):
        col[ids[rows]] = values[rows].to(I32)
    arena.n.copy_(torch.clamp(arena.n.to(torch.int64) + want.sum(), max=cap))
    return arena, torch.where(ok, ids, 0).to(I32), overflow


def alloc_consts_reference(arena: Arena, want, value_words):
    """Plain twin of kernel K3's const allocation: CONST nodes wrapping
    per-lane 256-bit words, in place. Returns (arena, ids, overflow)."""
    ccap = arena.const_vals.shape[0]
    cids = arena.n_const.to(torch.int64) + _rank(want)
    coverflow = want & (cids >= ccap)
    cok = want & ~coverflow
    rows = torch.nonzero(cok).flatten()
    arena.const_vals[cids[rows]] = value_words[rows].to(I32)
    arena.n_const.copy_(torch.clamp(arena.n_const.to(torch.int64)
                                    + want.sum(), max=ccap))
    zeros = torch.zeros_like(cids)
    arena, ids, overflow = alloc_rows_reference(
        arena, cok, torch.full_like(cids, CONST), zeros, zeros, zeros, cids,
        zeros)
    return arena, ids, overflow | coverflow


def alloc_rows(arena: Arena, want, op, a, b, c, imm, imm2):
    """Node allocation: kernel K3 on CUDA tensors, the twin on the CPU."""
    if arena.op.is_cuda:
        from ..kernels import ops

        return ops.arena_alloc(arena, want, None, op, a, b, c, imm, imm2)
    return alloc_rows_reference(arena, want, op, a, b, c, imm, imm2)


def alloc_consts(arena: Arena, want, value_words):
    """Const allocation: kernel K3 on CUDA tensors, the twin on the CPU."""
    if arena.op.is_cuda:
        from ..kernels import ops

        return ops.arena_alloc(arena, want, value_words)
    return alloc_consts_reference(arena, want, value_words)


# -- host mirror ---------------------------------------------------------------------

#: node columns of a delta block, in row order (arena.py:180)
ROW_COLS = ("op", "a", "b", "c", "imm", "imm2")


def fetch_delta_reference(arena: Arena, start: int, cstart: int, bucket: int,
                          cbucket: int):
    """Plain twin of kernel K8 (`_fetch_delta`, arena.py:185): rows
    [start, start+bucket) of the six node columns as int32[6, bucket] and
    const rows [cstart, cstart+cbucket) as int32[cbucket, 16]. Starts clamp
    so the block fits, as `lax.dynamic_slice` does."""
    start = max(min(int(start), arena.capacity - bucket), 0)
    ccap = arena.const_vals.shape[0]
    cstart = max(min(int(cstart), ccap - cbucket), 0)
    rows = torch.stack([getattr(arena, col)[start:start + bucket]
                        for col in ROW_COLS])
    return rows, arena.const_vals[cstart:cstart + cbucket].clone()


def fetch_delta(arena: Arena, start: int, cstart: int, bucket: int,
                cbucket: int):
    """Delta fetch: kernel K8 on CUDA tensors (landed in host memory, the
    blocks returned as CPU tensors of their own), the twin on the CPU."""
    if arena.op.is_cuda:
        from ..kernels import ops

        rows, consts, event = ops.arena_delta(arena, None, 0, start, cstart,
                                              bucket, cbucket)
        _device.wait_host_copy(event)
        return rows.clone(), consts.clone()
    return fetch_delta_reference(arena, start, cstart, bucket, cbucket)


#: a key for each HostArena, naming its staging among K8's plans
_MIRROR_KEYS = itertools.count()


class HostArena:
    """Incrementally mirrored host copy of the arena tables (numpy, in the
    JAX package's dtypes). The arena is append-only, so a row never changes
    once mirrored: `refresh` moves only rows [self.n, used) and consts
    [self.n_const, used_const), fetched in power-of-two buckets.

    A refresh's delta lands in one of two staging slots (on the card, K8
    writes it into the mirror's pinned staging): at most two
    `refresh_async` handles are in flight, and a third refresh, blocking
    or not, raises until one of them is applied."""

    def __init__(self, arena: Arena, used: Optional[int] = None,
                 used_const: Optional[int] = None):
        capacity = arena.capacity
        for col in ROW_COLS:
            setattr(self, col, np.zeros(capacity, dtype=np.int32))
        self.const_vals = np.zeros(tuple(arena.const_vals.shape),
                                   dtype=np.uint32)
        self.n = 0
        self.n_const = 0
        self._var_memo: Dict[int, set] = {}
        self._key = next(_MIRROR_KEYS)
        self._in_flight = [None, None]  # the handle holding each slot
        self.refresh(arena, used, used_const)

    def refresh(self, arena: Arena, used: Optional[int] = None,
                used_const: Optional[int] = None) -> None:
        """Mirror up to `used` rows and `used_const` consts (each read from
        the arena, one blocking read, when not given)."""
        self.refresh_apply(self.refresh_async(arena, used, used_const))

    def refresh_async(self, arena: Arena, used: Optional[int] = None,
                      used_const: Optional[int] = None):
        """Launch the delta fetch into a free staging slot (on the card,
        after the work queued on the current stream, on the copy stream);
        the returned handle goes to `refresh_apply`. None when nothing is
        new. Raises if both slots hold handles in flight."""
        from .batch import next_pow2

        if used is None:
            used = int(arena.n)
        if used_const is None:
            used_const = int(arena.n_const)
        delta = used - self.n
        cdelta = used_const - self.n_const
        if delta <= 0 and cdelta <= 0:
            return None
        bucket = min(max(next_pow2(max(delta, 1)), 16), self.op.shape[0])
        cbucket = min(max(next_pow2(max(cdelta, 1)), 16),
                      self.const_vals.shape[0])
        # clamp so start+bucket fits; the host offset below compensates
        start = max(min(self.n, self.op.shape[0] - bucket), 0)
        cstart = max(min(self.n_const, self.const_vals.shape[0] - cbucket), 0)
        if None not in self._in_flight:
            raise RuntimeError("arena mirror: both staging slots hold "
                               "refreshes in flight; apply one first")
        slot = self._in_flight.index(None)
        if arena.op.is_cuda:
            from ..kernels import ops

            rows, consts, event = ops.arena_delta(arena, self._key, slot, start,
                                                  cstart, bucket, cbucket)
        else:
            rows, consts = fetch_delta_reference(arena, start, cstart, bucket,
                                                 cbucket)
            event = None
        handle = (slot, rows, consts, event, start, cstart, used, used_const)
        self._in_flight[slot] = handle
        return handle

    def refresh_apply(self, handle) -> None:
        """Fill the mirror from a `refresh_async` handle, waiting for its
        delta if it is still in flight, and free its slot."""
        if handle is None:
            return
        slot, rows, consts, event, start, cstart, used, used_const = handle
        if self._in_flight[slot] is not handle:
            raise ValueError("arena mirror handle not in flight here")
        _device.wait_host_copy(event)
        self._in_flight[slot] = None
        if used < self.n or used_const < self.n_const:
            raise ValueError("arena mirror handles applied out of order")
        rows = rows.numpy()
        consts = consts.numpy().view(np.uint32)
        delta = used - self.n
        cdelta = used_const - self.n_const
        if delta > 0:
            off = self.n - start
            for position, col in enumerate(ROW_COLS):
                getattr(self, col)[self.n:used] = \
                    rows[position, off:off + delta]
            self.n = used
        if cdelta > 0:
            coff = self.n_const - cstart
            self.const_vals[self.n_const:used_const] = \
                consts[coff:coff + cdelta]
            self.n_const = used_const

    def var_classes(self, node_id: int) -> set:
        """All VAR classes reachable from node_id (arena.py:437)."""
        hit = self._var_memo.get(node_id)
        if hit is not None:
            return hit
        stack, seen, classes = [int(node_id)], set(), set()
        while stack:
            node = stack.pop()
            if node in seen or node == 0:
                continue
            seen.add(node)
            if int(self.op[node]) == VAR:
                classes.add(int(self.imm[node]))
            else:
                stack.extend((int(self.a[node]), int(self.b[node]),
                              int(self.c[node])))
        self._var_memo[int(node_id)] = classes
        return classes
