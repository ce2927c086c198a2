"""Static control-flow analysis of EVM bytecode (the cfa pass).

One pass over ``frontends/disassembler.py`` output that recovers basic
blocks, resolves jump targets with an abstract stack/constant dataflow
(push-constant tracking through DUP/SWAP/arithmetic/AND-mask idioms),
builds the CFG, computes reachability and dominator/post-dominator trees
(iterative CHK, see :mod:`.domtree`), and emits dense device-consumable
tables:

* ``pc_to_block`` — byte address -> block id (immediates inherit their
  PUSH's block);
* ``block_merge_pc`` — block id -> pc of the nearest post-dominating
  block (-1 when none): the veritesting merge point for branch blocks
  (ROADMAP item 3) and the reconvergence pc every lane in the block is
  heading to;
* ``valid_target_bitmap`` / ``valid_targets`` — the JUMPDEST bitmap
  refined to *reachable* JUMPDESTs;
* ``dead_mask`` — bytes proven statically unreachable.

Soundness direction: the CFG **over-approximates** real control flow —
an unresolved jump conservatively fans out to every JUMPDEST (plus the
virtual exit, so post-dominator claims shrink rather than grow). Hence
"statically dead" implies genuinely unreachable, and a jump site
"resolved to T" means every execution of that site jumps to T: both are
safe to act on without a solver. Jump targets pushed inside their own
block (the solc idiom) stay resolved even when unknown-stack states fan
in, so resolution survives the conservative edges.

This module is stdlib-only (plus the in-package opcode table): the
port's own copy of the JAX package's cfa pass, whose knob reads
(MYTHRIL_TPU_CFA_STACK_DEPTH / _MAX_BLOCKS) are keyword defaults here.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..ops.opcodes import OPCODES, STACK
from . import domtree

log = logging.getLogger(__name__)

_WORD_MASK = (1 << 256) - 1

#: opcodes that end a block with no fall-through
TERMINATORS = {"STOP", "RETURN", "REVERT", "INVALID", "SELFDESTRUCT"}

#: abstract-stack slots tracked per block entry (deeper slots are UNKNOWN);
#: must cover DUP16/SWAP16 reach (the MYTHRIL_TPU_CFA_STACK_DEPTH default)
_DEFAULT_TRACKED_DEPTH = 32

#: block-count bail-out guard (the MYTHRIL_TPU_CFA_MAX_BLOCKS default)
_DEFAULT_MAX_BLOCKS = 16384


class _Underflow(Exception):
    """Abstract execution popped below a KNOWN-height stack: the real
    machine would throw, so the block exits exceptionally."""


@dataclass
class BasicBlock:
    """One basic block: a maximal straight-line instruction run."""

    block_id: int
    start_pc: int            #: byte address of the first instruction
    end_pc: int              #: byte address AFTER the last instruction's bytes
    first_index: int         #: index into Disassembly.instruction_list
    last_index: int          #: inclusive
    terminator: str          #: op_code of the last instruction ("" = fallthrough)
    successors: Set[int] = field(default_factory=set)  #: block ids (+ exit id)
    entry_height: Optional[int] = None  #: abstract stack height on entry


@dataclass
class CfaResult:
    """The CFA verdict for one Disassembly: CFG + dense tables."""

    blocks: List[BasicBlock]
    exit_id: int                       #: virtual exit node (== len(blocks))
    code_length: int
    pc_to_block: List[int]             #: per byte, -1 when code is empty
    block_merge_pc: List[int]          #: per block, -1 when no postdom merge
    branch_merge_pc: Dict[int, int]    #: branch-site pc -> merge pc
    valid_targets: Set[int]            #: reachable JUMPDEST pcs
    valid_target_bitmap: bytearray     #: per byte, 1 = reachable JUMPDEST
    dead_mask: bytearray               #: per byte, 1 = statically unreachable
    jump_targets: Dict[int, Tuple[int, ...]]  #: resolved site pc -> targets
    unresolved_jumps: Tuple[int, ...]  #: site pcs the dataflow could not pin
    reachable: Set[int]                #: reachable block ids
    idom: List[Optional[int]]          #: dominator tree (entry block 0)
    ipostdom: List[Optional[int]]      #: post-dominator tree (virtual exit)
    n_edges: int

    # -- queries (the consumer surface) ------------------------------------------
    def block_at(self, pc: int) -> Optional[int]:
        if 0 <= pc < len(self.pc_to_block):
            block = self.pc_to_block[pc]
            return block if block >= 0 else None
        return None

    def is_valid_target(self, pc: int) -> bool:
        return 0 <= pc < len(self.valid_target_bitmap) \
            and bool(self.valid_target_bitmap[pc])

    def is_dead(self, pc: int) -> bool:
        return 0 <= pc < len(self.dead_mask) and bool(self.dead_mask[pc])

    def merge_pc_at(self, pc: int) -> Optional[int]:
        """The reconvergence pc the block containing `pc` flows into, or
        None when the block has no real post-dominator."""
        block = self.block_at(pc)
        if block is None:
            return None
        merge = self.block_merge_pc[block]
        return merge if merge >= 0 else None

    def resolved_targets(self, pc: int) -> Optional[Tuple[int, ...]]:
        """Resolved target pcs of the jump site at `pc`; () when the site
        provably throws (constant non-JUMPDEST target); None when the
        site is unresolved or not a reachable jump site."""
        return self.jump_targets.get(pc)

    @property
    def n_jump_sites(self) -> int:
        return len(self.jump_targets) + len(self.unresolved_jumps)

    @property
    def fully_resolved(self) -> bool:
        return not self.unresolved_jumps

    @property
    def merge_points(self) -> Set[int]:
        return set(self.branch_merge_pc.values())

    @property
    def dead_bytes(self) -> int:
        return sum(self.dead_mask)


# -- abstract stack ------------------------------------------------------------------
# A value is an int (known constant) or None (unknown). A state is
# (height, vals): total stack height (None = conflicting/unknown) plus the
# top `tracked_depth` values, top of stack LAST. Slots below the tracked
# window are implicitly unknown.

_AbsState = Tuple[Optional[int], Tuple[Optional[int], ...]]


def _merge_states(a: _AbsState, b: _AbsState) -> _AbsState:
    height = a[0] if a[0] == b[0] else None
    vals_a, vals_b = a[1], b[1]
    keep = min(len(vals_a), len(vals_b))
    merged = tuple(
        x if x == y else None
        for x, y in zip(vals_a[len(vals_a) - keep:],
                        vals_b[len(vals_b) - keep:]))
    return (height, merged)


def _fold_binary(op: str, a: Optional[int],
                 b: Optional[int]) -> Optional[int]:
    """Constant-fold op(µ0=a, µ1=b); None when either operand is unknown.
    Only the pure word ops the solc jump idioms flow targets through."""
    if a is None or b is None:
        return None
    if op == "ADD":
        return (a + b) & _WORD_MASK
    if op == "SUB":
        return (a - b) & _WORD_MASK
    if op == "MUL":
        return (a * b) & _WORD_MASK
    if op == "DIV":
        return 0 if b == 0 else a // b
    if op == "AND":
        return a & b
    if op == "OR":
        return a | b
    if op == "XOR":
        return a ^ b
    if op == "SHL":
        return (b << a) & _WORD_MASK if a < 256 else 0
    if op == "SHR":
        return b >> a if a < 256 else 0
    if op == "EQ":
        return int(a == b)
    if op == "LT":
        return int(a < b)
    if op == "GT":
        return int(a > b)
    return None


_UNARY_FOLDS = {"ISZERO", "NOT"}
_BINARY_FOLDS = {"ADD", "SUB", "MUL", "DIV", "AND", "OR", "XOR",
                 "SHL", "SHR", "EQ", "LT", "GT"}


def push_immediate(ins) -> Optional[int]:
    """The concrete immediate of a PUSH instruction (PUSH0 and an empty
    argument decode to 0), or None when the hex argument is unparsable.
    The one shared decode site (R9): every consumer outside this package
    — the superoptimizer's block layout, future peepholes — reads PUSH
    immediates through here instead of re-implementing the fold."""
    if ins.op_code == "PUSH0" or not ins.argument:
        return 0
    try:
        return int(ins.argument, 16)
    except ValueError:
        return None


class _Stack:
    """Mutable abstract stack for simulating one block."""

    __slots__ = ("vals", "below", "tracked")

    def __init__(self, state: _AbsState, tracked: int):
        height, vals = state
        self.vals: List[Optional[int]] = list(vals)
        #: unknown slots beneath the tracked window; None = unbounded
        self.below: Optional[int] = None if height is None \
            else height - len(vals)
        self.tracked = tracked

    def pop(self) -> Optional[int]:
        if self.vals:
            return self.vals.pop()
        if self.below is None:
            return None
        if self.below <= 0:
            raise _Underflow
        self.below -= 1
        return None

    def push(self, value: Optional[int]) -> None:
        self.vals.append(value)
        if len(self.vals) > self.tracked:
            del self.vals[0]
            if self.below is not None:
                self.below += 1

    def peek(self, depth: int) -> Optional[int]:
        """Value `depth` slots below the top (0 = top), None when outside
        the tracked window."""
        if depth < len(self.vals):
            return self.vals[-1 - depth]
        if self.below is not None and self.below < depth - len(self.vals) + 1:
            raise _Underflow
        return None

    def swap(self, depth: int) -> None:
        """SWAPn: exchange top with the slot `depth` below it."""
        while len(self.vals) <= depth:
            if self.below is not None:
                if self.below <= 0:
                    raise _Underflow
                self.below -= 1
            self.vals.insert(0, None)
        self.vals[-1], self.vals[-1 - depth] = \
            self.vals[-1 - depth], self.vals[-1]

    def state(self) -> _AbsState:
        height = None if self.below is None else self.below + len(self.vals)
        return (height, tuple(self.vals))


def _simulate(block: BasicBlock, instructions, entry: _AbsState,
              tracked: int):
    """Abstractly execute a block body (everything up to, but excluding,
    the control effect of its terminator).

    Returns (exit_state, jump_dest) where jump_dest is the abstract value
    on top of the stack *consumed by* a JUMP/JUMPI terminator (already
    popped, condition included), or None for other terminators. Raises
    _Underflow when the block provably underflows a known-height stack."""
    stack = _Stack(entry, tracked)
    jump_dest: Optional[int] = None
    for index in range(block.first_index, block.last_index + 1):
        ins = instructions[index]
        op = ins.op_code
        if op.startswith("PUSH"):
            stack.push(push_immediate(ins))
        elif op.startswith("DUP"):
            stack.push(stack.peek(int(op[3:]) - 1))
        elif op.startswith("SWAP"):
            stack.swap(int(op[4:]))
        elif op == "POP":
            stack.pop()
        elif op == "PC":
            stack.push(ins.address)
        elif op == "JUMPDEST":
            pass
        elif op == "JUMP":
            jump_dest = stack.pop()
        elif op == "JUMPI":
            jump_dest = stack.pop()
            stack.pop()  # condition
        elif op in _UNARY_FOLDS:
            value = stack.pop()
            if value is None:
                stack.push(None)
            elif op == "ISZERO":
                stack.push(int(value == 0))
            else:  # NOT
                stack.push(~value & _WORD_MASK)
        elif op in _BINARY_FOLDS:
            a, b = stack.pop(), stack.pop()
            stack.push(_fold_binary(op, a, b))
        elif op in OPCODES:
            pops, pushes = OPCODES[op][STACK]
            for _ in range(pops):
                stack.pop()
            for _ in range(pushes):
                stack.push(None)
        else:
            # unassigned opcode: the machine throws; treated as a
            # terminator at block-construction time, nothing to simulate
            break
    return stack.state(), jump_dest


# -- CFG construction ----------------------------------------------------------------

def _recover_blocks(instructions, code_length: int) -> List[BasicBlock]:
    """Split the linear-sweep decode into basic blocks: leaders are pc 0,
    every JUMPDEST, and every instruction following a JUMP/JUMPI or a
    terminator (including unassigned opcodes, which throw)."""
    if not instructions:
        return []
    leaders = {0}
    for index, ins in enumerate(instructions):
        if ins.op_code == "JUMPDEST":
            leaders.add(index)
        if (ins.op_code in ("JUMP", "JUMPI") or ins.op_code in TERMINATORS
                or ins.op_code not in OPCODES) \
                and index + 1 < len(instructions):
            leaders.add(index + 1)
    ordered = sorted(leaders)
    blocks: List[BasicBlock] = []
    for block_id, first in enumerate(ordered):
        last = (ordered[block_id + 1] - 1 if block_id + 1 < len(ordered)
                else len(instructions) - 1)
        end_pc = (instructions[last + 1].address
                  if last + 1 < len(instructions) else code_length)
        last_op = instructions[last].op_code
        terminator = last_op if (last_op in ("JUMP", "JUMPI")
                                 or last_op in TERMINATORS
                                 or last_op not in OPCODES) else ""
        blocks.append(BasicBlock(
            block_id=block_id, start_pc=instructions[first].address,
            end_pc=end_pc, first_index=first, last_index=last,
            terminator=terminator))
    return blocks


def build_cfa(disassembly, tracked_depth: int = _DEFAULT_TRACKED_DEPTH,
              max_blocks: int = _DEFAULT_MAX_BLOCKS) -> Optional[CfaResult]:
    """Run the full pass over a ``frontends.disassembler.Disassembly``.

    Returns None when the contract exceeds the block budget (the screen
    and all consumers treat None as "no verdict" and keep their dynamic
    paths)."""
    instructions = disassembly.instruction_list
    code_length = len(getattr(disassembly, "raw_code", b"")) or (
        instructions[-1].address + 1 if instructions else 0)
    blocks = _recover_blocks(instructions, code_length)
    if not blocks:
        return None
    if len(blocks) > max_blocks:
        log.info("cfa: %d blocks exceeds max_blocks=%d — "
                 "skipping static analysis", len(blocks), max_blocks)
        return None

    exit_id = len(blocks)
    block_of_pc = {block.start_pc: block.block_id for block in blocks}
    jumpdest_blocks = [block.block_id for block in blocks
                       if instructions[block.first_index].op_code
                       == "JUMPDEST"]

    # -- worklist dataflow: entry states + dynamically discovered edges ----------
    entry_states: Dict[int, _AbsState] = {0: (0, ())}
    succs: List[Set[int]] = [set() for _ in blocks]
    fanned_out: Set[int] = set()       # jump-site block ids already fanned out
    # site pc -> every abstract dest observed across (re-)simulations; a
    # site re-simulated under merged entry states can yield different
    # constants, and ALL of them are feasible targets
    jump_value: Dict[int, Set[Optional[int]]] = {}
    worklist = [0]

    def propagate(target: int, state: _AbsState) -> None:
        old = entry_states.get(target)
        new = state if old is None else _merge_states(old, state)
        if new != old:
            entry_states[target] = new
            if target not in worklist:
                worklist.append(target)

    def fan_out(block: BasicBlock) -> None:
        """Unresolved jump: conservative edges to every JUMPDEST block,
        plus the virtual exit so post-dominator claims stay sound."""
        if block.block_id in fanned_out:
            return
        fanned_out.add(block.block_id)
        succs[block.block_id].add(exit_id)
        unknown: _AbsState = (None, ())
        for target in jumpdest_blocks:
            succs[block.block_id].add(target)
            propagate(target, unknown)

    iterations = 0
    iteration_cap = max(64, 8 * len(blocks) * (tracked_depth + 2))
    while worklist:
        iterations += 1
        if iterations > iteration_cap:  # defensive: lattice guarantees
            log.warning("cfa: dataflow did not converge in %d iterations — "
                        "skipping static analysis", iteration_cap)
            return None
        block = blocks[worklist.pop()]
        entry = entry_states[block.block_id]
        try:
            exit_state, jump_dest = _simulate(
                block, instructions, entry, tracked_depth)
        except _Underflow:
            succs[block.block_id].add(exit_id)  # provable throw
            continue
        term = block.terminator
        next_id = block.block_id + 1 if block.block_id + 1 < len(blocks) \
            else exit_id

        if term == "":
            succs[block.block_id].add(next_id)
            if next_id != exit_id:
                propagate(next_id, exit_state)
        elif term == "JUMPI":
            succs[block.block_id].add(next_id)
            if next_id != exit_id:
                propagate(next_id, exit_state)
            site = instructions[block.last_index].address
            jump_value.setdefault(site, set()).add(jump_dest)
            if jump_dest is None:
                fan_out(block)
            elif jump_dest in block_of_pc and \
                    instructions[blocks[block_of_pc[jump_dest]]
                                 .first_index].op_code == "JUMPDEST":
                target = block_of_pc[jump_dest]
                succs[block.block_id].add(target)
                propagate(target, exit_state)
            else:
                succs[block.block_id].add(exit_id)  # constant invalid target
        elif term == "JUMP":
            site = instructions[block.last_index].address
            jump_value.setdefault(site, set()).add(jump_dest)
            if jump_dest is None:
                fan_out(block)
            elif jump_dest in block_of_pc and \
                    instructions[blocks[block_of_pc[jump_dest]]
                                 .first_index].op_code == "JUMPDEST":
                target = block_of_pc[jump_dest]
                succs[block.block_id].add(target)
                propagate(target, exit_state)
            else:
                succs[block.block_id].add(exit_id)
        else:  # STOP/RETURN/REVERT/SELFDESTRUCT/INVALID/unassigned
            succs[block.block_id].add(exit_id)

    # -- final tables over the fixpoint -------------------------------------------
    reachable = set(entry_states)
    for block in blocks:
        block.entry_height = entry_states.get(block.block_id, (None, ()))[0] \
            if block.block_id in reachable else None
        block.successors = succs[block.block_id] if block.block_id \
            in reachable else set()

    # classify reachable jump sites from their fixpoint dest values
    jump_targets: Dict[int, Tuple[int, ...]] = {}
    unresolved: List[int] = []
    for block in blocks:
        if block.block_id not in reachable \
                or block.terminator not in ("JUMP", "JUMPI"):
            continue
        site = instructions[block.last_index].address
        if block.block_id in fanned_out:
            unresolved.append(site)
            continue
        dests = jump_value.get(site)
        if not dests:
            # simulated only via an underflowing entry: provable throw
            jump_targets[site] = ()
        else:
            jump_targets[site] = tuple(sorted(
                dest for dest in dests
                if dest is not None and dest in block_of_pc
                and instructions[blocks[block_of_pc[dest]].first_index]
                .op_code == "JUMPDEST"))

    # dense byte tables
    pc_to_block = [-1] * code_length
    for block in blocks:
        for pc in range(block.start_pc, min(block.end_pc, code_length)):
            pc_to_block[pc] = block.block_id
    dead_mask = bytearray(code_length)
    for block in blocks:
        if block.block_id not in reachable:
            for pc in range(block.start_pc, min(block.end_pc, code_length)):
                dead_mask[pc] = 1
    valid_targets = {block.start_pc for block in blocks
                     if block.block_id in reachable
                     and instructions[block.first_index].op_code
                     == "JUMPDEST"}
    valid_target_bitmap = bytearray(code_length)
    for pc in valid_targets:
        valid_target_bitmap[pc] = 1

    # dominators / post-dominators over reachable blocks + virtual exit
    graph: List[List[int]] = [sorted(block.successors) for block in blocks]
    graph.append([])                      # the virtual exit has no successors
    idom = domtree.compute_idoms(graph, entry=0)
    reverse: List[List[int]] = [[] for _ in range(len(graph))]
    for node, nexts in enumerate(graph):
        for nxt in nexts:
            reverse[nxt].append(node)
    ipostdom = domtree.compute_idoms(reverse, entry=exit_id)

    block_merge_pc = [-1] * len(blocks)
    branch_merge_pc: Dict[int, int] = {}
    n_edges = sum(len(block.successors) for block in blocks)
    for block in blocks:
        pdom = ipostdom[block.block_id]
        if pdom is not None and pdom != exit_id:
            block_merge_pc[block.block_id] = blocks[pdom].start_pc
        real_succs = [s for s in block.successors if s != exit_id]
        if len(real_succs) >= 2 and block_merge_pc[block.block_id] >= 0:
            site = instructions[block.last_index].address
            branch_merge_pc[site] = block_merge_pc[block.block_id]

    return CfaResult(
        blocks=blocks, exit_id=exit_id, code_length=code_length,
        pc_to_block=pc_to_block, block_merge_pc=block_merge_pc,
        branch_merge_pc=branch_merge_pc, valid_targets=valid_targets,
        valid_target_bitmap=valid_target_bitmap, dead_mask=dead_mask,
        jump_targets=jump_targets, unresolved_jumps=tuple(unresolved),
        reachable=reachable, idom=idom, ipostdom=ipostdom, n_edges=n_edges)
