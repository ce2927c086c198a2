"""Value-range + memory write-region abstract interpretation (absint).

The third stdlib-only static pass beside the CFA (cfa.py) and the taint
summary (taint.py): a memoized fixpoint interpreter over the CFA's CFG
with two abstract domains —

* a **stride-interval value domain** for abstract stack cells: every
  cell is ``(lo, hi, stride)`` meaning ``{lo + k*stride} ∩ [lo, hi]``
  (``stride == 0`` is the singleton constant). Entry states join at
  CFG merges and **widen at natural-loop headers** (summary.py's
  LoopInfo) so the fixpoint terminates on counting loops;
* a **memory write-region domain**: per basic block (and, derived, per
  post-dominator join point) the ``[offset, offset + len)`` byte ranges
  the block may write — ⊤ as soon as a write offset is unbounded or
  past ``OFFSET_CAP``.

Three consumer surfaces ride on the fixpoint tables:

* ``join_regions`` / ``word_windows`` — per join pc, the statically
  proven byte regions either diamond arm may have written. The device
  merge kernel (parallel/symstep.py merge_pass) ships these as a
  32-byte-window mask so lane pairs whose memory planes diverge ONLY
  inside the mask can still ITE-blend and merge (frontier item 4a);
* ``loop_bounds`` — proven per-loop header-arrival counts from
  abstractly executing constant-entry loops to their exit, consumed by
  core/strategy/bounded_loops.py in place of the flat default;
* ``const_jumpis`` — JUMPI sites whose condition interval is provably
  always-zero / always-nonzero (out-of-range CALLDATALOAD selectors
  fold here through ``SHR``/``EQ``), consumed by the cfa screen to
  skip the infeasible side before any constraint or solver work.

Soundness direction mirrors the CFA: states propagate along every CFG
edge including the conservative fan-out edges, so every interval and
region **over-approximates** the concrete values/writes — the
randomized concrete-differential harness in tests/test_absint.py holds
the pass to exactly that contract. Consumers reach the tables through
``smt/solver/cfa_screen.py`` (the adapter); ``args.absint`` and the
``ENABLED["absint"]`` switch gate the whole surface for A/B runs.

The port's own copy of the JAX package's absint pass, whose knob reads
(MYTHRIL_TPU_CFA_STACK_DEPTH, _ABSINT_MAX_ITERS, _ABSINT_MEM_REGIONS) are
keyword defaults here.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..ops.opcodes import OPCODES, STACK
from .cfa import CfaResult, TERMINATORS, BasicBlock

log = logging.getLogger(__name__)

#: bump when the JSON layout changes; from_json rejects other versions
ABSINT_VERSION = 1

_WORD_MASK = (1 << 256) - 1

#: an interval is (lo, hi, stride); stride 0 <=> singleton constant
Interval = Tuple[int, int, int]

TOP: Interval = (0, _WORD_MASK, 1)
#: 160-bit address-class ops (CALLER/ADDRESS/...) push at most this
_ADDR_TOP: Interval = (0, (1 << 160) - 1, 1)

#: write offsets at/above this are treated as ⊤ (the device memory
#: plane is far smaller; a frontier-side filter re-checks its own cap)
OFFSET_CAP = 1 << 24
#: one write spanning more than this many bytes is ⊤
SPAN_CAP = 4096
#: per-block write-region list cap before collapsing to ⊤
_BLOCK_REGION_CAP = 16
#: joins switch from join() to widen() after this many block visits,
#: loop headers widen from the first revisit (termination guard for
#: slowly-ascending chains through conservative fan-out edges)
_WIDEN_AFTER = 8

#: ops that write memory with (dest, ..., length) operand layouts;
#: value = (dest operand index from top, length operand index, fixed
#: size when length is implicit)
_COPY_WRITERS = {
    "CALLDATACOPY": (0, 2),
    "CODECOPY": (0, 2),
    "RETURNDATACOPY": (0, 2),
    "MCOPY": (0, 2),
    "EXTCODECOPY": (1, 3),
}
#: ops whose memory effect is unbounded for this pass (return-data
#: writes at dynamic offsets; conservatively ⊤)
_TOP_WRITERS = frozenset(
    {"CALL", "CALLCODE", "DELEGATECALL", "STATICCALL"})

_ADDR_OPS = frozenset({"ADDRESS", "ORIGIN", "CALLER", "COINBASE"})

_BINARY_OPS = frozenset({
    "ADD", "SUB", "MUL", "DIV", "MOD", "AND", "OR", "XOR",
    "SHL", "SHR", "EQ", "LT", "GT", "EXP"})


# -- the stride-interval domain ------------------------------------------------------

def make_interval(lo: int, hi: int, stride: int) -> Interval:
    """Canonicalize: clamp to the word range, singletons get stride 0,
    hi is pulled down onto the stride lattice so it is attainable."""
    lo = max(0, lo)
    hi = min(_WORD_MASK, hi)
    if hi < lo:
        return TOP  # defensive: an empty interval is a bug upstream
    if lo == hi:
        return (lo, lo, 0)
    stride = max(1, stride)
    hi = lo + ((hi - lo) // stride) * stride
    if lo == hi:
        return (lo, lo, 0)
    return (lo, hi, stride)


def const(value: int) -> Interval:
    value &= _WORD_MASK
    return (value, value, 0)


def is_const(iv: Interval) -> bool:
    return iv[0] == iv[1]


def contains(iv: Interval, value: int) -> bool:
    lo, hi, stride = iv
    if not lo <= value <= hi:
        return False
    return stride == 0 or (value - lo) % stride == 0


def join_iv(a: Interval, b: Interval) -> Interval:
    if a == b:
        return a
    stride = math.gcd(math.gcd(a[2], b[2]), abs(a[0] - b[0]))
    return make_interval(min(a[0], b[0]), max(a[1], b[1]), stride)


def widen_iv(old: Interval, new: Interval) -> Interval:
    """Jump unstable bounds to the lattice extremes (strides still
    descend by gcd, a finite divisor chain, so widening terminates)."""
    joined = join_iv(old, new)
    if joined == old:
        return old
    lo = old[0] if joined[0] >= old[0] else 0
    hi = old[1] if joined[1] <= old[1] else _WORD_MASK
    return make_interval(lo, hi, joined[2])


def _definitely_nonzero(iv: Interval) -> bool:
    return not contains(iv, 0)


def _definitely_zero(iv: Interval) -> bool:
    return iv == (0, 0, 0)


def interval_binary(op: str, a: Interval, b: Interval) -> Interval:
    """Abstract transfer for op(µ0=a, µ1=b) — same operand convention as
    cfa._fold_binary (a is the top-of-stack pop)."""
    la, ha, sa = a
    lb, hb, sb = b
    if op == "ADD":
        if ha + hb <= _WORD_MASK:
            return make_interval(la + lb, ha + hb, math.gcd(sa, sb))
        return TOP  # may wrap
    if op == "SUB":
        if la >= hb:
            return make_interval(la - hb, ha - lb, math.gcd(sa, sb))
        return TOP  # may underflow-wrap
    if op == "MUL":
        if ha * hb > _WORD_MASK:
            return TOP
        # (la+i·sa)(lb+j·sb) − la·lb is a multiple of this gcd
        stride = math.gcd(math.gcd(sa * lb, sb * la), sa * sb)
        return make_interval(la * lb, ha * hb, stride)
    if op == "DIV":
        if lb == 0:  # divisor may be 0: EVM yields 0, which min covers
            return make_interval(0, ha // max(lb, 1), 1)
        stride = sa // lb if is_const(b) and lb and sa % lb == 0 else 1
        return make_interval(la // hb, ha // lb, stride)
    if op == "MOD":
        if is_const(b) and lb > 0 and ha < lb:
            return a  # in-range: identity
        if hb == 0:
            return const(0)  # x mod 0 == 0 on the EVM
        return make_interval(0, hb - 1, 1)
    if op == "AND":
        if is_const(b) and (lb + 1) & lb == 0 and ha <= lb:
            return a  # power-of-two mask that doesn't clip
        if is_const(a) and (la + 1) & la == 0 and hb <= la:
            return b
        return make_interval(0, min(ha, hb), 1)
    if op in ("OR", "XOR"):
        bits = max(ha.bit_length(), hb.bit_length())
        return make_interval(0, (1 << bits) - 1, 1)
    if op == "SHL":  # shift = µ0, value = µ1
        if is_const(a):
            if la >= 256:
                return const(0)
            if (hb << la) <= _WORD_MASK:
                return make_interval(lb << la, hb << la, sb << la)
        return TOP
    if op == "SHR":  # monotone decreasing in the shift amount
        lo = lb >> min(ha, 256)
        hi = hb >> min(la, 256)
        return make_interval(lo, hi, 0 if lo == hi else 1)
    if op == "EQ":
        if ha < lb or hb < la:
            return const(0)  # disjoint
        if is_const(a) and is_const(b):
            return const(int(la == lb))
        if is_const(a) and not contains(b, la):
            return const(0)  # off-stride constant (selector screening)
        if is_const(b) and not contains(a, lb):
            return const(0)
        return (0, 1, 1)
    if op == "LT":
        if ha < lb:
            return const(1)
        if la >= hb:
            return const(0)
        return (0, 1, 1)
    if op == "GT":
        if la > hb:
            return const(1)
        if ha <= lb:
            return const(0)
        return (0, 1, 1)
    if op == "EXP":  # base = µ0, exponent = µ1; fold small constants
        if is_const(a) and is_const(b) and lb <= 256 \
                and la.bit_length() * max(lb, 1) <= 257:
            return const(pow(la, lb) & _WORD_MASK)
        return TOP
    return TOP


# -- abstract machine state ----------------------------------------------------------
# Mirrors cfa._AbsState / cfa._Stack with intervals for values: a state
# is (height, vals) — total stack height (None = unknown) plus the top
# `tracked` cells, top of stack LAST; deeper slots are implicitly TOP.

AbsState = Tuple[Optional[int], Tuple[Interval, ...]]

_ENTRY_STATE: AbsState = (0, ())
_UNKNOWN_STATE: AbsState = (None, ())


class _Underflow(Exception):
    """Abstract execution popped below a known-height stack."""


def merge_states(a: AbsState, b: AbsState,
                 widen: bool = False) -> AbsState:
    height = a[0] if a[0] == b[0] else None
    vals_a, vals_b = a[1], b[1]
    keep = min(len(vals_a), len(vals_b))
    combine = widen_iv if widen else join_iv
    merged = tuple(
        combine(x, y)
        for x, y in zip(vals_a[len(vals_a) - keep:],
                        vals_b[len(vals_b) - keep:]))
    return (height, merged)


class _IStack:
    """Mutable interval stack for simulating one block."""

    __slots__ = ("vals", "below", "tracked")

    def __init__(self, state: AbsState, tracked: int):
        height, vals = state
        self.vals: List[Interval] = list(vals)
        self.below: Optional[int] = None if height is None \
            else height - len(vals)
        self.tracked = tracked

    def pop(self) -> Interval:
        if self.vals:
            return self.vals.pop()
        if self.below is None:
            return TOP
        if self.below <= 0:
            raise _Underflow
        self.below -= 1
        return TOP

    def push(self, value: Interval) -> None:
        self.vals.append(value)
        if len(self.vals) > self.tracked:
            del self.vals[0]
            if self.below is not None:
                self.below += 1

    def peek(self, depth: int) -> Interval:
        if depth < len(self.vals):
            return self.vals[-1 - depth]
        if self.below is not None \
                and self.below < depth - len(self.vals) + 1:
            raise _Underflow
        return TOP

    def swap(self, depth: int) -> None:
        while len(self.vals) <= depth:
            if self.below is not None:
                if self.below <= 0:
                    raise _Underflow
                self.below -= 1
            self.vals.insert(0, TOP)
        self.vals[-1], self.vals[-1 - depth] = \
            self.vals[-1 - depth], self.vals[-1]

    def state(self) -> AbsState:
        height = None if self.below is None \
            else self.below + len(self.vals)
        return (height, tuple(self.vals))


#: one abstract memory write: (start, end) byte region, or None = ⊤
_Write = Optional[Tuple[int, int]]


def _bounded_write(offset: Interval, size: int) -> _Write:
    """Region an [offset, offset+size) write may touch; None when the
    offset is unbounded or the span blows the caps."""
    lo, hi, _stride = offset
    if hi + size > OFFSET_CAP or (hi + size) - lo > SPAN_CAP:
        return None
    return (lo, hi + size)


def simulate_block(block: BasicBlock, instructions, entry: AbsState,
                   tracked: int,
                   writes: Optional[List[_Write]] = None
                   ) -> Tuple[AbsState, Optional[Interval],
                              Optional[Interval]]:
    """Abstractly execute one block body over the interval domain.

    Returns (exit_state, jump_dest, jumpi_cond) — the dest/cond
    intervals a JUMP/JUMPI terminator consumed (already popped), None
    otherwise. Appends every abstract memory write to `writes` when
    given. Raises _Underflow like cfa._simulate."""
    stack = _IStack(entry, tracked)
    jump_dest: Optional[Interval] = None
    jumpi_cond: Optional[Interval] = None

    def record(write: _Write) -> None:
        if writes is not None:
            writes.append(write)

    for index in range(block.first_index, block.last_index + 1):
        ins = instructions[index]
        op = ins.op_code
        if op.startswith("PUSH"):
            if op == "PUSH0":
                stack.push(const(0))
            else:
                try:
                    stack.push(const(int(ins.argument, 16)
                                     if ins.argument else 0))
                except ValueError:
                    stack.push(TOP)
        elif op.startswith("DUP"):
            stack.push(stack.peek(int(op[3:]) - 1))
        elif op.startswith("SWAP"):
            stack.swap(int(op[4:]))
        elif op == "POP":
            stack.pop()
        elif op == "PC":
            stack.push(const(ins.address))
        elif op == "JUMPDEST":
            pass
        elif op == "JUMP":
            jump_dest = stack.pop()
        elif op == "JUMPI":
            jump_dest = stack.pop()
            jumpi_cond = stack.pop()
        elif op == "ISZERO":
            value = stack.pop()
            if _definitely_zero(value):
                stack.push(const(1))
            elif _definitely_nonzero(value):
                stack.push(const(0))
            else:
                stack.push((0, 1, 1))
        elif op == "NOT":  # NOT x == MASK - x: bounds flip, stride kept
            lo, hi, stride = stack.pop()
            stack.push(make_interval(
                _WORD_MASK - hi, _WORD_MASK - lo, stride))
        elif op in _BINARY_OPS:
            a, b = stack.pop(), stack.pop()
            stack.push(interval_binary(op, a, b))
        elif op == "MSTORE":
            offset = stack.pop()
            stack.pop()
            record(_bounded_write(offset, 32))
        elif op == "MSTORE8":
            offset = stack.pop()
            stack.pop()
            record(_bounded_write(offset, 1))
        elif op in _COPY_WRITERS:
            dest_at, len_at = _COPY_WRITERS[op]
            pops, _pushes = OPCODES[op][STACK]
            operands = [stack.pop() for _ in range(pops)]
            dest, length = operands[dest_at], operands[len_at]
            if is_const(length) and length[0] == 0:
                pass  # zero-length copy writes nothing
            elif is_const(length) and length[0] <= SPAN_CAP:
                record(_bounded_write(dest, length[0]))
            else:
                record(None)
        elif op in _TOP_WRITERS:
            pops, pushes = OPCODES[op][STACK]
            for _ in range(pops):
                stack.pop()
            record(None)
            for _ in range(pushes):
                stack.push((0, 1, 1))  # call status word
        elif op in _ADDR_OPS:
            stack.push(_ADDR_TOP)
        elif op in OPCODES:
            pops, pushes = OPCODES[op][STACK]
            for _ in range(pops):
                stack.pop()
            for _ in range(pushes):
                stack.push(TOP)
        else:
            break  # unassigned opcode: the machine throws here
    return stack.state(), jump_dest, jumpi_cond


def _merge_regions(regions: List[Tuple[int, int]]
                   ) -> Tuple[Tuple[int, int], ...]:
    """Sort + coalesce overlapping/adjacent [start, end) regions."""
    merged: List[Tuple[int, int]] = []
    for start, end in sorted(regions):
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return tuple(merged)


# -- result --------------------------------------------------------------------------

@dataclass
class AbsintResult:
    """The absint verdict for one Disassembly (block ids refer to the
    contract's CfaResult)."""

    code_length: int
    #: reachable block id -> (entry height, entry cell intervals)
    entry_intervals: Dict[int, AbsState]
    #: reachable block id -> merged write regions; None = ⊤
    block_writes: Dict[int, Optional[Tuple[Tuple[int, int], ...]]]
    #: join pc -> proven byte regions either diamond arm may write
    #: (absent join pc = ⊤ / untracked)
    join_regions: Dict[int, Tuple[Tuple[int, int], ...]]
    #: loop header pc -> proven header-arrival bound
    loop_bounds: Dict[int, int]
    #: JUMPI site pc -> True (always taken) / False (never taken)
    const_jumpis: Dict[int, bool]
    widenings: int = 0
    iterations: int = 0
    mem_regions_cap: int = 8
    #: lazily-built word-window memo per (join pc)
    _windows: Dict[int, Optional[Tuple[int, ...]]] = \
        field(default_factory=dict, repr=False)

    # -- queries (the consumer surface) ------------------------------------------
    @property
    def regions_proven(self) -> int:
        return len(self.join_regions)

    def jumpi_verdict(self, site_pc: int) -> Optional[bool]:
        """True = always taken, False = never taken, None = no claim."""
        return self.const_jumpis.get(site_pc)

    def loop_bound(self, header_pc: int) -> Optional[int]:
        return self.loop_bounds.get(header_pc)

    def word_windows(self, join_pc: int) -> Optional[Tuple[int, ...]]:
        """Non-overlapping 32-byte window start offsets covering the
        join's proven regions, or None when the join is untracked or
        needs more than `mem_regions_cap` windows (⊤ for the kernel)."""
        if join_pc not in self._windows:
            self._windows[join_pc] = self._build_windows(join_pc)
        return self._windows[join_pc]

    def _build_windows(self, join_pc: int) -> Optional[Tuple[int, ...]]:
        regions = self.join_regions.get(join_pc)
        if regions is None:
            return None
        windows: List[int] = []
        cursor = 0
        for start, end in regions:
            offset = max(start, cursor)
            while offset < end:
                windows.append(offset)
                cursor = offset + 32
                offset = cursor
                if len(windows) > self.mem_regions_cap:
                    return None
        return tuple(windows)

    # -- persistence (serve warm path / cfaview --json) --------------------------
    def to_json(self) -> dict:
        return {
            "version": ABSINT_VERSION,
            "code_length": self.code_length,
            "blocks": {
                str(bid): {"height": state[0],
                           "vals": [list(iv) for iv in state[1]]}
                for bid, state in sorted(self.entry_intervals.items())},
            "writes": {
                str(bid): (None if regions is None
                           else [list(region) for region in regions])
                for bid, regions in sorted(self.block_writes.items())},
            "joins": {
                str(pc): [list(region) for region in regions]
                for pc, regions in sorted(self.join_regions.items())},
            "loop_bounds": {str(pc): bound for pc, bound
                            in sorted(self.loop_bounds.items())},
            "const_jumpis": {str(pc): verdict for pc, verdict
                             in sorted(self.const_jumpis.items())},
            "widenings": self.widenings,
            "iterations": self.iterations,
            "mem_regions_cap": self.mem_regions_cap,
        }

    @classmethod
    def from_json(cls, data: dict) -> Optional["AbsintResult"]:
        if not isinstance(data, dict) \
                or data.get("version") != ABSINT_VERSION:
            return None
        return cls(
            code_length=int(data["code_length"]),
            entry_intervals={
                int(bid): (entry["height"],
                           tuple(tuple(iv) for iv in entry["vals"]))
                for bid, entry in data["blocks"].items()},
            block_writes={
                int(bid): (None if regions is None
                           else tuple(tuple(r) for r in regions))
                for bid, regions in data["writes"].items()},
            join_regions={
                int(pc): tuple(tuple(r) for r in regions)
                for pc, regions in data["joins"].items()},
            loop_bounds={int(pc): int(bound) for pc, bound
                         in data["loop_bounds"].items()},
            const_jumpis={int(pc): bool(verdict) for pc, verdict
                          in data["const_jumpis"].items()},
            widenings=int(data.get("widenings", 0)),
            iterations=int(data.get("iterations", 0)),
            mem_regions_cap=int(data.get("mem_regions_cap", 8)),
        )


# -- fixpoint driver -----------------------------------------------------------------

def _successor_states(cfa: CfaResult, block: BasicBlock, instructions,
                      exit_state: AbsState, jump_dest: Optional[Interval]
                      ) -> List[Tuple[int, AbsState]]:
    """(target block, propagated state) pairs for one simulated block —
    the same edge classification build_cfa derived, driven from its
    tables (jump_targets / unresolved_jumps) instead of re-resolving."""
    out: List[Tuple[int, AbsState]] = []
    term = block.terminator
    next_id = block.block_id + 1 \
        if block.block_id + 1 < len(cfa.blocks) else cfa.exit_id
    if term == "" and next_id != cfa.exit_id:
        out.append((next_id, exit_state))
        return out
    if term not in ("JUMP", "JUMPI"):
        return out
    if term == "JUMPI" and next_id != cfa.exit_id:
        out.append((next_id, exit_state))
    site = instructions[block.last_index].address
    targets = cfa.jump_targets.get(site)
    if targets is not None:
        for target_pc in targets:
            target = cfa.block_at(target_pc)
            if target is not None:
                out.append((target, exit_state))
    else:
        # unresolved site: the cfa fanned out to every JUMPDEST block —
        # propagate the unknown state along those conservative edges
        for succ in block.successors:
            if succ != cfa.exit_id and succ != next_id:
                out.append((succ, _UNKNOWN_STATE))
    return out


def _prove_loop_bound(cfa: CfaResult, instructions, loop,
                      entry: AbsState, tracked: int,
                      max_iters: int) -> Optional[int]:
    """Abstractly execute the loop from its outside entry state; when
    every branch decision folds to a constant and the loop exits within
    `max_iters` header arrivals, the arrival count is a proven bound."""
    body = set(loop.blocks)
    current = loop.header_block
    state = entry
    visits = 0
    for _step in range(max_iters * 64):
        if current == loop.header_block:
            visits += 1
            if visits > max_iters:
                return None
        block = cfa.blocks[current]
        try:
            state, jump_dest, jumpi_cond = simulate_block(
                block, instructions, state, tracked)
        except _Underflow:
            return None
        term = block.terminator
        if term in TERMINATORS or (term not in ("", "JUMP", "JUMPI")):
            return visits  # execution ended inside the loop body
        next_id = current + 1 if current + 1 < len(cfa.blocks) \
            else cfa.exit_id
        if term == "":
            target = next_id
        else:
            if term == "JUMPI":
                if jumpi_cond is None:
                    return None
                if _definitely_zero(jumpi_cond):
                    target = next_id
                elif _definitely_nonzero(jumpi_cond):
                    target = _const_jump_block(cfa, jump_dest)
                else:
                    return None  # data-dependent branch: no proof
            else:  # JUMP
                target = _const_jump_block(cfa, jump_dest)
            if target is None:
                return None
        if target == cfa.exit_id:
            return visits
        if target not in body:
            return visits  # left the loop: bound proven
        current = target
    return None


def _const_jump_block(cfa: CfaResult,
                      dest: Optional[Interval]) -> Optional[int]:
    """Target block of a constant jump dest, None when not provable."""
    if dest is None or not is_const(dest):
        return None
    pc = dest[0]
    if pc not in cfa.valid_targets:
        return None
    block = cfa.block_at(pc)
    if block is None or cfa.blocks[block].start_pc != pc:
        return None
    return block


def build_absint(disassembly, cfa: Optional[CfaResult] = None,
                 tracked_depth: int = 32,
                 max_iters: int = 64,
                 mem_regions: int = 8
                 ) -> Optional[AbsintResult]:
    """Run the interval/region fixpoint over a Disassembly's CFA.

    Returns None when there is no CFA (pass disabled or bailed) — every
    consumer treats None as "no verdict" and keeps its dynamic path."""
    from .summary import recover_loops

    if cfa is None:
        from .cfa import build_cfa

        cfa = build_cfa(disassembly)
    if cfa is None:
        return None

    instructions = disassembly.instruction_list
    loops, _loop_header_of = recover_loops(cfa, instructions)
    #: header block id -> its loop's body block set (for back-edge
    #: classification during propagation)
    loop_body_of: Dict[int, Set[int]] = {
        loop.header_block: set(loop.blocks) for loop in loops}

    entry_states: Dict[int, AbsState] = {0: _ENTRY_STATE}
    #: loop header -> entry state merged over NON-back-edge preds only
    #: (the state trip-count proving must start from)
    outside_entry: Dict[int, AbsState] = {}
    visits: Dict[int, int] = {}
    #: JUMPI site pc -> branch-direction observations across visits
    jumpi_obs: Dict[int, Set[str]] = {}
    widenings = 0
    iterations = 0
    worklist: List[int] = [0]
    # defensive convergence cap (widening guarantees termination; the
    # cap turns a domain bug into a bail instead of a hang)
    iteration_cap = max(256, 32 * len(cfa.blocks))

    def propagate(src: int, target: int, state: AbsState) -> None:
        nonlocal widenings
        body = loop_body_of.get(target)
        back_edge = body is not None and src in body
        old = entry_states.get(target)
        if not back_edge:
            prev = outside_entry.get(target)
            if body is not None:
                outside_entry[target] = state if prev is None \
                    else merge_states(prev, state)
        if old is None:
            new = state
        else:
            widen = back_edge or visits.get(target, 0) >= _WIDEN_AFTER
            new = merge_states(old, state, widen=widen)
            if widen and new != old:
                widenings += 1
        if new != old:
            entry_states[target] = new
            if target not in worklist:
                worklist.append(target)

    while worklist:
        iterations += 1
        if iterations > iteration_cap:
            log.warning("absint: fixpoint did not converge in %d "
                        "iterations — skipping value-range analysis",
                        iteration_cap)
            return None
        block_id = worklist.pop()
        visits[block_id] = visits.get(block_id, 0) + 1
        block = cfa.blocks[block_id]
        entry = entry_states[block_id]
        try:
            exit_state, jump_dest, jumpi_cond = simulate_block(
                block, instructions, entry, tracked_depth)
        except _Underflow:
            continue  # provable throw; cfa already routed to exit
        if block.terminator == "JUMPI" and jumpi_cond is not None:
            site = instructions[block.last_index].address
            if _definitely_nonzero(jumpi_cond):
                direction = "taken"
            elif _definitely_zero(jumpi_cond):
                direction = "fall"
            else:
                direction = "both"
            jumpi_obs.setdefault(site, set()).add(direction)
        for target, state in _successor_states(
                cfa, block, instructions, exit_state, jump_dest):
            propagate(block_id, target, state)

    # -- per-block write effects over the fixpoint entry states ------------------
    block_writes: Dict[int, Optional[Tuple[Tuple[int, int], ...]]] = {}
    for block_id in sorted(entry_states):
        writes: List[_Write] = []
        try:
            simulate_block(cfa.blocks[block_id], instructions,
                           entry_states[block_id], tracked_depth,
                           writes=writes)
        except _Underflow:
            writes = []
        if any(write is None for write in writes):
            block_writes[block_id] = None
        else:
            merged = _merge_regions(
                [write for write in writes if write is not None])
            block_writes[block_id] = merged \
                if len(merged) <= _BLOCK_REGION_CAP else None

    # -- diamond write regions per post-dominator join ---------------------------
    # For each branch site, the blocks strictly between the branch and
    # its join (DFS from the branch's successors, stopping at the join)
    # bound what either arm may have written when two siblings meet
    # there. Several sites can share a join; their regions union.
    join_acc: Dict[int, Optional[List[Tuple[int, int]]]] = {}
    for site, merge_pc in cfa.branch_merge_pc.items():
        branch_block = cfa.block_at(site)
        join_block = cfa.block_at(merge_pc)
        if branch_block is None or join_block is None:
            continue
        regions = join_acc.setdefault(merge_pc, [])
        if regions is None:
            continue  # an earlier site already forced ⊤
        stack = [succ for succ in cfa.blocks[branch_block].successors
                 if succ != cfa.exit_id and succ != join_block]
        diamond: Set[int] = set()
        while stack:
            node = stack.pop()
            if node in diamond:
                continue
            diamond.add(node)
            for succ in cfa.blocks[node].successors:
                if succ != cfa.exit_id and succ != join_block \
                        and succ not in diamond:
                    stack.append(succ)
        for node in diamond:
            if node not in entry_states:
                continue  # unreachable: cannot execute, cannot write
            effect = block_writes.get(node)
            if effect is None:
                join_acc[merge_pc] = None
                break
            regions.extend(effect)
    join_regions = {
        merge_pc: _merge_regions(regions)
        for merge_pc, regions in join_acc.items() if regions is not None}

    # -- proven loop bounds ------------------------------------------------------
    loop_bounds: Dict[int, int] = {}
    for loop in loops:
        entry = outside_entry.get(loop.header_block)
        if entry is None:
            continue
        bound = _prove_loop_bound(cfa, instructions, loop, entry,
                                  tracked_depth, max_iters)
        if bound is not None:
            loop_bounds[loop.header_pc] = bound

    const_jumpis = {
        site: observations == {"taken"}
        for site, observations in jumpi_obs.items()
        if observations in ({"taken"}, {"fall"})}

    return AbsintResult(
        code_length=cfa.code_length,
        entry_intervals=dict(entry_states),
        block_writes=block_writes,
        join_regions=join_regions,
        loop_bounds=loop_bounds,
        const_jumpis=const_jumpis,
        widenings=widenings,
        iterations=iterations,
        mem_regions_cap=mem_regions,
    )
