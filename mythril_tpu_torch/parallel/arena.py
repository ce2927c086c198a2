"""Expression arena, device half (port of mythril_tpu/parallel/arena.py:1-163).

A symbolic word on the device is one int32: an index into append-only arena
tables. Building an expression is a scatter write plus a bump of the
allocation pointer. Node ids come from a rank (exclusive prefix count) of the
lanes that want a node, never from atomics, so ids and lane order equal the
JAX package's.

On CUDA tensors `alloc_rows`/`alloc_consts` launch kernel K3
(`kernels/arena_alloc.cu`, one block-wide scan, updating the arena in place);
on CPU tensors they run the `*_reference` twins. The host mirror
(`HostArena`) and the delta fetch belong to a later slice."""

from __future__ import annotations

from typing import NamedTuple

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
