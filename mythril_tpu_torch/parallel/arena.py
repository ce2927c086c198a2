"""Expression arena (port of mythril_tpu/parallel/arena.py).

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
non-blocking copies, one CUDA event). `HostArena.to_term` turns a mirrored
node into a term of the port's SMT layer (arena.py:300-435): variable leaves
come from a `TxContext` (arena.py:479-544), named as the host engine names
them, and device-executed ADD/SUB/MUL/EXP carry the integer detector's
`OverUnderflowAnnotation` at a `_DeviceArithSite` (458-476)."""

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

#: arena op byte -> terms constructor name for binary BV ops (arena.py:169)
_BINOP = {
    0x01: "bvadd", 0x02: "bvmul", 0x03: "bvsub", 0x04: "bvudiv",
    0x05: "bvsdiv", 0x06: "bvurem", 0x07: "bvsrem",
    0x16: "bvand", 0x17: "bvor", 0x18: "bvxor",
}
_SHIFTS = {0x1B: "bvshl", 0x1C: "bvlshr", 0x1D: "bvashr"}
_CMP = {0x10: ("bvult", False), 0x11: ("bvult", True),   # LT, GT(swap)
        0x12: ("bvslt", False), 0x13: ("bvslt", True),   # SLT, SGT(swap)
        0x14: ("eq", False)}                             # EQ


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
        #: (node, id(ctx)) -> term: a node converts once per seeding context
        self._memo: Dict[tuple, object] = {}
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

    def to_term(self, node_id: int, ctx: "TxContext"):
        """Arena node -> BitVec of the port's SMT layer, via ctx's variable
        leaves."""
        from ..smt import BitVec

        result = self._convert(int(node_id), ctx)
        assert isinstance(result, BitVec)
        return result

    def _convert(self, node_id: int, ctx: "TxContext"):
        from ..smt import BitVec, symbol_factory
        from ..smt import terms as T

        memo = self._memo
        key = (node_id, id(ctx))  # var leaves differ per seeding context
        hit = memo.get(key)
        if hit is not None:
            return hit
        op = int(self.op[node_id])
        if op == CONST:
            value = words.to_ints(self.const_vals[int(self.imm[node_id])])
            result = symbol_factory.BitVecVal(int(value), 256)
        elif op == VAR:
            result = ctx.var(int(self.imm[node_id]), int(self.imm2[node_id]))
        else:
            ca = self._convert(int(self.a[node_id]), ctx) \
                if self.a[node_id] else None
            cb = self._convert(int(self.b[node_id]), ctx) \
                if self.b[node_id] else None
            # detector taint (OriginAnnotation etc.) flows through wrapper
            # annotations as in host execution (smt/bitvec.py ops)
            annotations = set()
            for child in (ca, cb):
                if child is not None:
                    annotations |= child.annotations

            def bv(term):
                return BitVec(term, annotations)

            if op in _BINOP:
                raw = T.bv_binop(_BINOP[op], ca.raw, cb.raw)
                if op in (0x04, 0x05, 0x06, 0x07):
                    # EVM division semantics: x/0 = 0, x%0 = 0 (SMT-LIB
                    # gives all-ones / x; the host's guard: instructions.py
                    # div_)
                    raw = T.ite(T.bv_cmp("eq", cb.raw, T.bv_const(0, 256)),
                                T.bv_const(0, 256), raw)
                result = bv(raw)
                if op in (0x01, 0x02, 0x03):
                    # the integer detector's source hook fires at host
                    # ADD/SUB/MUL; device-executed arithmetic gets the same
                    # marker here (the site address rides in imm2)
                    self._attach_overflow_annotation(
                        op, result, ca, cb, int(self.imm2[node_id]), ctx)
            elif op in _SHIFTS:
                # EVM shift operand order: (shift, value)
                result = bv(T.bv_binop(_SHIFTS[op], cb.raw, ca.raw))
            elif op in _CMP:
                kind, swap = _CMP[op]
                left, right = (cb, ca) if swap else (ca, cb)
                cond = T.bv_cmp(kind, left.raw, right.raw)
                result = bv(T.ite(cond, T.bv_const(1, 256),
                                  T.bv_const(0, 256)))
            elif op == 0x15:  # ISZERO
                cond = T.bv_cmp("eq", ca.raw, T.bv_const(0, 256))
                result = bv(T.ite(cond, T.bv_const(1, 256),
                                  T.bv_const(0, 256)))
            elif op == 0x19:  # NOT
                result = bv(T.bv_not(ca.raw))
            elif op == 0x1A:  # BYTE(i, x): i = child a, x = child b
                shift = T.bv_binop(
                    "bvmul",
                    T.bv_binop("bvsub", T.bv_const(31, 256), ca.raw),
                    T.bv_const(8, 256))
                shifted = T.bv_binop("bvlshr", cb.raw, shift)
                result = bv(T.bv_binop("bvand", shifted,
                                       T.bv_const(0xFF, 256)))
            elif op == 0x0B:  # SIGNEXTEND(size=a, value=b)
                size = ca.raw
                if size.is_const and size.value < 32:
                    bits = 8 * (size.value + 1)
                    result = bv(T.sext(T.extract(bits - 1, 0, cb.raw),
                                       256 - bits))
                else:
                    result = cb
            elif op == 0x0A:  # EXP -> the host Power UF
                from ..core.function_managers import \
                    exponent_function_manager

                result, _ = exponent_function_manager.create_condition(ca, cb)
                self._attach_overflow_annotation(
                    op, result, ca, cb, int(self.imm2[node_id]), ctx)
            elif op == 0x0F:  # internal: ite(cond=a, then=b, else=c)
                cc = self._convert(int(self.c[node_id]), ctx)
                cond = T.bool_not(T.bv_cmp("eq", ca.raw, T.bv_const(0, 256)))
                result = bv(T.ite(cond, cb.raw, cc.raw))
            else:
                raise ValueError(f"arena node {node_id}: unknown op {op:#x}")
        memo[key] = result
        return result

    @staticmethod
    def _attach_overflow_annotation(op: int, result, ca, cb, address: int,
                                    ctx) -> None:
        """Device-executed ADD/SUB/MUL/EXP: attach the integer detector's
        OverUnderflowAnnotation as the host pre-hook would
        (analysis/modules/integer.py _handle_add/_handle_sub/_handle_mul),
        at a light site that carries the address and environment."""
        from ..analysis.modules.integer import OverUnderflowAnnotation
        from ..smt import (BVAddNoOverflow, BVMulNoOverflow,
                           BVSubNoUnderflow, Not, UGT, symbol_factory)

        if ca.raw.is_const and cb.raw.is_const:
            return
        if op == 0x01:
            operator = "addition"
            constraint = Not(BVAddNoOverflow(ca, cb, False))
        elif op == 0x03:
            operator = "subtraction"
            constraint = Not(BVSubNoUnderflow(ca, cb, False))
        elif op == 0x0A:
            if ca.raw.is_const and ca.raw.value < 2:
                return
            operator = "exponentiation"
            constraint = UGT(cb, symbol_factory.BitVecVal(255, 256))
        else:
            if (ca.raw.is_const and ca.raw.value < 2) or \
                    (cb.raw.is_const and cb.raw.value < 2):
                return
            operator = "multiplication"
            constraint = Not(BVMulNoOverflow(ca, cb, False))
        result.annotate(OverUnderflowAnnotation(
            _DeviceArithSite(ctx.environment, address), operator,
            constraint))

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


class _DeviceArithSite:
    """Light stand-in for the GlobalState at a device-executed arithmetic
    instruction: what the integer detector reads from
    annotation.overflowing_state (the environment, the site address, empty
    constraints for the pre-check)."""

    class _WorldView:
        def __init__(self):
            from ..core.state.constraints import Constraints

            self.constraints = Constraints()

    def __init__(self, environment, address: int):
        self.environment = environment
        self.world_state = self._WorldView()
        self._address = address

    def get_current_instruction(self):
        return {"address": self._address, "opcode": "ARITH"}


class TxContext:
    """Variable leaves for one (open state, transaction) seeding, named as
    the host engine names them so materialized states interoperate."""

    def __init__(self, tx_id: str, calldata, environment):
        self.tx_id = tx_id
        self.calldata = calldata          # SymbolicCalldata
        self.environment = environment    # host Environment
        self.host_terms: list = []        # V_HOST_TERM leaves (BitVec)
        #: (var_class, qualifier) -> BitVec: each lane allocates its own VAR
        #: node per occurrence, so the node memo misses across lanes, and
        #: calldata.get_word_at builds a 32-byte If-chain each call
        self._var_cache: dict = {}

    def var(self, var_class: int, qualifier: int):
        key = (var_class, qualifier)
        hit = self._var_cache.get(key)
        if hit is None:
            hit = self._var_cache[key] = self._var(var_class, qualifier)
        return hit

    def _var(self, var_class: int, qualifier: int):
        from ..smt import symbol_factory

        env = self.environment
        if var_class == V_CALLDATA_WORD:
            return self.calldata.get_word_at(qualifier)
        if var_class == V_CALLDATASIZE:
            return self.calldata.calldatasize
        if var_class == V_CALLER:
            return env.sender
        if var_class == V_ORIGIN:
            # the taint the host's origin_ handler attaches, so the TxOrigin
            # detector fires on materialized states too
            from ..analysis.modules.dependence_on_origin import \
                OriginAnnotation

            origin = env.origin
            if not list(origin.get_annotations(OriginAnnotation)):
                origin.annotate(OriginAnnotation())
            return origin
        if var_class == V_CALLVALUE:
            return env.callvalue
        if var_class == V_GASPRICE:
            return env.gasprice
        if var_class == V_BASEFEE:
            return env.basefee
        if var_class == V_HOST_TERM:
            return self.host_terms[qualifier]
        # block attributes: the host's naming (instructions.py,
        # GlobalState.new_bitvec prefixes the tx id)
        name = {V_TIMESTAMP: "timestamp", V_NUMBER: "block_number",
                V_COINBASE: "coinbase", V_PREVRANDAO: "prevrandao"}.get(
                    var_class)
        if name is not None:
            from ..analysis.modules.dependence_on_predictable_vars import \
                PredictableValueAnnotation

            operation = ("block.timestamp" if var_class == V_TIMESTAMP
                         else f"block.{name}".replace("block.block_", "block."))
            value = symbol_factory.BitVecSym(f"{self.tx_id}_{name}", 256)
            value.annotate(PredictableValueAnnotation(operation))
            return value
        raise ValueError(f"unknown var class {var_class}")
