"""Source->sink taint dataflow over the CFA CFG (the taint pass).

A forward may-taint analysis on top of :mod:`.cfa`'s ``CfaResult``: each
abstract value is a ``(const, taint)`` pair — the cfa constant lattice
joined with a set of source tags — propagated through the same
stack-machine simulation the cfa pass uses, plus three abstract cells
the cfa pass does not track:

* one **memory** summary cell (every MSTORE/*COPY unions in, every
  MLOAD/SHA3 reads it — symbolic offsets make per-offset tracking
  unsound, so one cell over-approximates all of memory);
* a bounded map of **concrete storage slots** (weak updates; reads of a
  tracked slot see its write taints), budgeted by
  ``slot_budget``;
* one **symbolic-storage** summary cell for writes through unknown slot
  keys (every SLOAD includes it).

Sources: calldata (CALLDATALOAD/CALLDATACOPY/CALLDATASIZE), CALLER,
ORIGIN, CALLVALUE, block/chain environment opcodes, external-call
returndata, and persistent storage itself (a prior transaction may have
written anything, so SLOAD always carries the STORAGE tag). Storage
write taints are additionally folded back into the entry state and the
fixpoint re-run (``max_iters`` rounds) so
cross-transaction flows — tx1 stores calldata, tx2 jumps on it — show
the original source tag, not just STORAGE.

Soundness invariant (what the module screen relies on):
**an empty taint set means the value is a deterministic function of the
bytecode alone** — every unmodeled opcode pushes the UNKNOWN tag,
untracked stack slots read as fully tainted, and unresolved jump edges
propagate an unknown stack, mirroring the cfa pass's conservative
fan-out. The analysis only ever over-approximates: a sink operand
reported untainted provably cannot depend on attacker input.

Stdlib-only, like the rest of ``staticanalysis/``: the port's own copy of
the JAX package's taint pass, whose knob reads (MYTHRIL_TPU_CFA_STACK_DEPTH,
_TAINT_MAX_ITERS, _TAINT_SLOTS) are keyword defaults here.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from ..ops.opcodes import OPCODES, STACK
from .cfa import (CfaResult, _BINARY_FOLDS, _UNARY_FOLDS, _Underflow,
                  _WORD_MASK, _fold_binary)

log = logging.getLogger(__name__)

# -- the taint lattice ---------------------------------------------------------------

#: source tags; a taint set is a frozenset of these
TAG_CALLDATA = "calldata"      #: CALLDATALOAD / CALLDATACOPY / CALLDATASIZE
TAG_CALLER = "caller"          #: msg.sender
TAG_ORIGIN = "origin"          #: tx.origin
TAG_CALLVALUE = "callvalue"    #: msg.value
TAG_ENV = "env"                #: block/chain environment (TIMESTAMP, NUMBER, ...)
TAG_RETURNDATA = "returndata"  #: external-call return data
TAG_STORAGE = "storage"        #: persistent storage (writable in prior txs)
TAG_UNKNOWN = "unknown"        #: unmodeled opcode / untracked slot

ALL_TAGS = (TAG_CALLDATA, TAG_CALLER, TAG_ORIGIN, TAG_CALLVALUE,
            TAG_ENV, TAG_RETURNDATA, TAG_STORAGE, TAG_UNKNOWN)

Taint = FrozenSet[str]
EMPTY: Taint = frozenset()
TOP: Taint = frozenset(ALL_TAGS)

#: (const, taint): the cfa constant lattice joined with a tag set.
#: Invariant: const is not None => taint == EMPTY (a proven constant is
#: deterministic no matter what its operands were).
Value = Tuple[Optional[int], Taint]

UNKNOWN_VALUE: Value = (None, TOP)


def _mk(const: Optional[int], taint: Taint) -> Value:
    return (const, EMPTY) if const is not None else (None, taint)


def _merge_value(a: Value, b: Value) -> Value:
    const = a[0] if a[0] == b[0] else None
    return _mk(const, a[1] | b[1])


# -- source / effect tables ----------------------------------------------------------

#: opcodes that push one fresh value carrying a fixed tag (popped
#: operands' taints union in on top)
_SOURCE_PUSH = {
    "CALLDATALOAD": TAG_CALLDATA, "CALLDATASIZE": TAG_CALLDATA,
    "CALLER": TAG_CALLER, "ORIGIN": TAG_ORIGIN,
    "CALLVALUE": TAG_CALLVALUE,
    "TIMESTAMP": TAG_ENV, "NUMBER": TAG_ENV, "DIFFICULTY": TAG_ENV,
    "PREVRANDAO": TAG_ENV, "COINBASE": TAG_ENV, "GASLIMIT": TAG_ENV,
    "CHAINID": TAG_ENV, "BASEFEE": TAG_ENV, "BLOCKHASH": TAG_ENV,
    "GAS": TAG_ENV, "GASPRICE": TAG_ENV, "ADDRESS": TAG_ENV,
    "BALANCE": TAG_ENV, "SELFBALANCE": TAG_ENV,
    "EXTCODESIZE": TAG_ENV, "EXTCODEHASH": TAG_ENV,
    "RETURNDATASIZE": TAG_RETURNDATA,
}

#: pure word functions beyond the cfa fold set: output taint is exactly
#: the union of input taints (deterministic in, deterministic out)
_PURE_EXTRA = {"MOD", "SMOD", "SDIV", "ADDMOD", "MULMOD", "EXP",
               "SIGNEXTEND", "SLT", "SGT", "BYTE", "SAR"}

#: external-call family: pushes a RETURNDATA-tagged status word and
#: writes returndata into memory
_CALL_OPS = {"CALL", "CALLCODE", "DELEGATECALL", "STATICCALL"}

#: sink opcodes and how many top-of-stack operands the summary records
#: for each site (operand 0 = top of stack at the site)
SINK_OPERANDS = {
    "JUMP": 1, "JUMPI": 2,            # dest; dest, cond
    "SSTORE": 2,                      # key, value
    "CALL": 3, "CALLCODE": 3,         # gas, to, value
    "DELEGATECALL": 2, "STATICCALL": 2,   # gas, to
    "SELFDESTRUCT": 1,                # beneficiary
    "CREATE": 3, "CREATE2": 4,        # value, offset, length[, salt]
}


@dataclass
class SinkSite:
    """Merged taint verdicts for one sink instruction (may-taint over
    every abstract path reaching it)."""

    pc: int
    op: str
    operand_taint: Tuple[Taint, ...]   #: operand 0 = top of stack

    def to_json(self) -> dict:
        return {"pc": self.pc, "op": self.op,
                "operands": [sorted(t) for t in self.operand_taint]}

    @classmethod
    def from_json(cls, data: dict) -> "SinkSite":
        return cls(pc=int(data["pc"]), op=str(data["op"]),
                   operand_taint=tuple(frozenset(t)
                                       for t in data["operands"]))


@dataclass
class TaintResult:
    """The taint fixpoint for one contract's reachable code."""

    sink_sites: Dict[int, SinkSite]    #: site pc -> merged operand taints
    reachable_ops: FrozenSet[str]      #: opcodes in reachable blocks
    rounds: int                        #: cross-transaction storage rounds run
    converged: bool                    #: False = saturated at the round cap


# -- abstract machine ----------------------------------------------------------------

#: stack half of a block-entry state, mirroring cfa._AbsState: total
#: height (None = unknown) plus the top tracked values, top LAST
_StackState = Tuple[Optional[int], Tuple[Value, ...]]

#: full block-entry state: stack, memory cell, storage slots, symbolic
#: storage cell
_State = Tuple[_StackState, Taint, Dict[int, Taint], Taint]

_UNKNOWN_STACK: _StackState = (None, ())


def _merge_stack(a: _StackState, b: _StackState) -> _StackState:
    height = a[0] if a[0] == b[0] else None
    vals_a, vals_b = a[1], b[1]
    keep = min(len(vals_a), len(vals_b))
    merged = tuple(
        _merge_value(x, y)
        for x, y in zip(vals_a[len(vals_a) - keep:],
                        vals_b[len(vals_b) - keep:]))
    return (height, merged)


def _merge_store(a: Dict[int, Taint], b: Dict[int, Taint]) -> Dict[int, Taint]:
    out = dict(a)
    for slot, taint in b.items():
        out[slot] = out.get(slot, EMPTY) | taint
    return out


def _merge_state(a: _State, b: _State) -> _State:
    return (_merge_stack(a[0], b[0]), a[1] | b[1],
            _merge_store(a[2], b[2]), a[3] | b[3])


class _TStack:
    """Mutable (const, taint) stack for simulating one block; slots below
    the tracked window read as fully tainted (UNKNOWN_VALUE)."""

    __slots__ = ("vals", "below", "tracked")

    def __init__(self, state: _StackState, tracked: int):
        height, vals = state
        self.vals: List[Value] = list(vals)
        self.below: Optional[int] = None if height is None \
            else height - len(vals)
        self.tracked = tracked

    def pop(self) -> Value:
        if self.vals:
            return self.vals.pop()
        if self.below is None:
            return UNKNOWN_VALUE
        if self.below <= 0:
            raise _Underflow
        self.below -= 1
        return UNKNOWN_VALUE

    def push(self, value: Value) -> None:
        self.vals.append(value)
        if len(self.vals) > self.tracked:
            del self.vals[0]
            if self.below is not None:
                self.below += 1

    def peek(self, depth: int) -> Value:
        if depth < len(self.vals):
            return self.vals[-1 - depth]
        if self.below is not None and self.below < depth - len(self.vals) + 1:
            raise _Underflow
        return UNKNOWN_VALUE

    def swap(self, depth: int) -> None:
        while len(self.vals) <= depth:
            if self.below is not None:
                if self.below <= 0:
                    raise _Underflow
                self.below -= 1
            self.vals.insert(0, UNKNOWN_VALUE)
        self.vals[-1], self.vals[-1 - depth] = \
            self.vals[-1 - depth], self.vals[-1]

    def state(self) -> _StackState:
        height = None if self.below is None else self.below + len(self.vals)
        return (height, tuple(self.vals))


def _simulate(block, instructions, entry: _State, tracked: int,
              slot_budget: int, sink_cb=None) -> _State:
    """Abstractly execute one block under `entry`, returning the exit
    state (terminator stack effects included, control effects not).
    `sink_cb(pc, op, operands)` observes each sink site's operand values
    before the op consumes them. Raises _Underflow on a provable
    underflow of a known-height stack (the block throws)."""
    stack = _TStack(entry[0], tracked)
    mem: Taint = entry[1]
    store: Dict[int, Taint] = dict(entry[2])
    sym: Taint = entry[3]

    for index in range(block.first_index, block.last_index + 1):
        ins = instructions[index]
        op = ins.op_code
        if sink_cb is not None and op in SINK_OPERANDS:
            try:
                operands = tuple(stack.peek(i)
                                 for i in range(SINK_OPERANDS[op]))
            except _Underflow:
                pass  # the site throws before executing; pops raise below
            else:
                sink_cb(ins.address, op, operands)
        if op.startswith("PUSH"):
            if op == "PUSH0":
                stack.push((0, EMPTY))
            else:
                try:
                    stack.push((int(ins.argument, 16) if ins.argument
                                else 0, EMPTY))
                except ValueError:
                    stack.push((None, EMPTY))  # truncated push: still fixed
        elif op.startswith("DUP"):
            stack.push(stack.peek(int(op[3:]) - 1))
        elif op.startswith("SWAP"):
            stack.swap(int(op[4:]))
        elif op == "POP":
            stack.pop()
        elif op == "PC":
            stack.push((ins.address, EMPTY))
        elif op == "JUMPDEST":
            pass
        elif op == "JUMP":
            stack.pop()
        elif op == "JUMPI":
            stack.pop()
            stack.pop()
        elif op in _UNARY_FOLDS:
            const, taint = stack.pop()
            if const is None:
                stack.push((None, taint))
            elif op == "ISZERO":
                stack.push((int(const == 0), EMPTY))
            else:  # NOT
                stack.push((~const & _WORD_MASK, EMPTY))
        elif op in _BINARY_FOLDS:
            a, b = stack.pop(), stack.pop()
            stack.push(_mk(_fold_binary(op, a[0], b[0]), a[1] | b[1]))
        elif op in _PURE_EXTRA:
            pops, _ = OPCODES[op][STACK]
            taint = EMPTY
            for _ in range(pops):
                taint |= stack.pop()[1]
            stack.push((None, taint))
        elif op in _SOURCE_PUSH:
            pops, _ = OPCODES[op][STACK]
            taint = frozenset((_SOURCE_PUSH[op],))
            for _ in range(pops):
                taint |= stack.pop()[1]
            stack.push((None, taint))
        elif op == "SHA3":
            a, b = stack.pop(), stack.pop()
            stack.push((None, mem | a[1] | b[1]))
        elif op == "MLOAD":
            off = stack.pop()
            stack.push((None, mem | off[1]))
        elif op in ("MSTORE", "MSTORE8"):
            off, val = stack.pop(), stack.pop()
            mem |= off[1] | val[1]
        elif op in ("CALLDATACOPY", "RETURNDATACOPY", "CODECOPY",
                    "EXTCODECOPY", "MCOPY"):
            pops, _ = OPCODES[op][STACK]
            taint = EMPTY
            for _ in range(pops):
                taint |= stack.pop()[1]
            if op == "CALLDATACOPY":
                taint |= frozenset((TAG_CALLDATA,))
            elif op == "RETURNDATACOPY":
                taint |= frozenset((TAG_RETURNDATA,))
            elif op == "EXTCODECOPY":
                taint |= frozenset((TAG_ENV,))
            # CODECOPY copies deterministic bytes; MCOPY shuffles what
            # memory already holds — offsets still union in
            mem |= taint
        elif op == "SLOAD":
            key = stack.pop()
            base = sym | frozenset((TAG_STORAGE,)) | key[1]
            if key[0] is not None:
                stack.push((None, base | store.get(key[0], EMPTY)))
            else:
                everything = EMPTY
                for taint in store.values():
                    everything |= taint
                stack.push((None, base | everything))
        elif op == "SSTORE":
            key, val = stack.pop(), stack.pop()
            written = val[1] | key[1]
            if key[0] is not None and (key[0] in store
                                       or len(store) < slot_budget):
                store[key[0]] = store.get(key[0], EMPTY) | written
            else:
                sym |= written
        elif op in _CALL_OPS:
            pops, _ = OPCODES[op][STACK]
            for _ in range(pops):
                stack.pop()
            mem |= frozenset((TAG_RETURNDATA,))
            stack.push((None, frozenset((TAG_RETURNDATA,))))
        elif op in ("CREATE", "CREATE2"):
            pops, _ = OPCODES[op][STACK]
            for _ in range(pops):
                stack.pop()
            stack.push((None, frozenset((TAG_RETURNDATA,))))
        elif op in OPCODES:
            pops, pushes = OPCODES[op][STACK]
            for _ in range(pops):
                stack.pop()
            for _ in range(pushes):
                stack.push((None, frozenset((TAG_UNKNOWN,))))
        else:
            # unassigned opcode: throws; block construction already made
            # it a terminator
            break
    return (stack.state(), mem, store, sym)


# -- the fixpoint --------------------------------------------------------------------

def _run_fixpoint(cfa: CfaResult, instructions, tracked: int,
                  slot_budget: int, entry_store: Dict[int, Taint],
                  entry_sym: Taint) -> Optional[Dict[int, _State]]:
    """One intra-transaction fixpoint over the CFA CFG, starting from an
    empty stack/memory and the given cross-round storage state. Returns
    block id -> entry state, or None if the (defensively capped)
    iteration budget blows."""
    blocks = cfa.blocks
    unresolved = set(cfa.unresolved_jumps)
    entry_states: Dict[int, _State] = {
        0: ((0, ()), EMPTY, dict(entry_store), entry_sym)}
    worklist = [0]

    def propagate(target: int, state: _State) -> None:
        old = entry_states.get(target)
        new = state if old is None else _merge_state(old, state)
        if new != old:
            entry_states[target] = new
            if target not in worklist:
                worklist.append(target)

    iterations = 0
    iteration_cap = max(64, 8 * len(blocks) * (tracked + 2))
    while worklist:
        iterations += 1
        if iterations > iteration_cap:
            log.warning("taint: dataflow did not converge in %d iterations "
                        "— skipping taint analysis", iteration_cap)
            return None
        block = blocks[worklist.pop()]
        entry = entry_states[block.block_id]
        try:
            exit_state = _simulate(block, instructions, entry, tracked,
                                   slot_budget)
        except _Underflow:
            continue  # provable throw; cfa routed the edge to exit
        term = block.terminator
        next_id = block.block_id + 1 if block.block_id + 1 < len(blocks) \
            else cfa.exit_id
        if term in ("JUMP", "JUMPI") \
                and instructions[block.last_index].address in unresolved:
            # mirror the cfa fan-out: jump successors get an unknown
            # stack (the dynamic dest could arrive at any height), but
            # memory/storage flow through untouched
            fanned = (_UNKNOWN_STACK,) + exit_state[1:]
            for succ in block.successors:
                if succ == cfa.exit_id:
                    continue
                if term == "JUMPI" and succ == next_id:
                    propagate(succ, exit_state)
                else:
                    propagate(succ, fanned)
        else:
            for succ in block.successors:
                if succ != cfa.exit_id:
                    propagate(succ, exit_state)
    return entry_states


def build_taint(cfa: CfaResult, instructions,
                tracked_depth: int = 32,
                max_iters: int = 4,
                slot_budget: int = 64) -> Optional[TaintResult]:
    """Run the taint pass over an existing ``CfaResult``.

    Returns None when the dataflow blows its defensive iteration cap
    (consumers treat None as "no verdict")."""
    max_iters = max(1, max_iters)

    # cross-transaction rounds: fold every round's storage writes back
    # into the entry storage until stable (or saturate at the cap)
    entry_store: Dict[int, Taint] = {}
    entry_sym: Taint = EMPTY
    entry_states: Optional[Dict[int, _State]] = None
    converged = False
    rounds = 0
    while rounds < max_iters:
        rounds += 1
        entry_states = _run_fixpoint(cfa, instructions, tracked_depth,
                                     slot_budget, entry_store, entry_sym)
        if entry_states is None:
            return None
        next_store, next_sym = dict(entry_store), entry_sym
        for block in cfa.blocks:
            if block.block_id not in entry_states:
                continue
            try:
                _, _, store, sym = _simulate(
                    block, instructions, entry_states[block.block_id],
                    tracked_depth, slot_budget)
            except _Underflow:
                continue
            next_store = _merge_store(next_store, store)
            next_sym |= sym
        if next_store == entry_store and next_sym == entry_sym:
            converged = True
            break
        entry_store, entry_sym = next_store, next_sym
    if not converged:
        # round cap hit: saturate storage so the final pass stays sound
        entry_sym = TOP
        entry_states = _run_fixpoint(cfa, instructions, tracked_depth,
                                     slot_budget, entry_store, entry_sym)
        if entry_states is None:
            return None

    # final pass: record per-sink-site operand taints under the fixpoint
    sink_sites: Dict[int, SinkSite] = {}

    def record(pc: int, op: str, operands: Tuple[Value, ...]) -> None:
        taints = tuple(_mk(*v)[1] for v in operands)
        known = sink_sites.get(pc)
        if known is None:
            sink_sites[pc] = SinkSite(pc=pc, op=op, operand_taint=taints)
        else:
            sink_sites[pc] = SinkSite(
                pc=pc, op=op, operand_taint=tuple(
                    a | b for a, b in zip(known.operand_taint, taints)))

    reachable_ops: Set[str] = set()
    for block in cfa.blocks:
        if block.block_id not in entry_states:
            continue
        for index in range(block.first_index, block.last_index + 1):
            reachable_ops.add(instructions[index].op_code)
        try:
            _simulate(block, instructions, entry_states[block.block_id],
                      tracked_depth, slot_budget, sink_cb=record)
        except _Underflow:
            pass

    return TaintResult(sink_sites=sink_sites,
                       reachable_ops=frozenset(reachable_ops),
                       rounds=rounds, converged=converged)
