"""Per-contract analysis summaries: functions, loops, sink taints.

Packages the :mod:`.taint` fixpoint with two cheap structural passes
over the same ``CfaResult`` into one memoizable, JSON-serializable
``ContractSummary``:

* **functions** — the public selectors the disassembler already
  recovered from the dispatcher idiom (``Disassembly.func_hashes``),
  cross-checked against reachable JUMPDESTs and expanded to per-function
  block cover sets by forward DFS from each entry block. Blocks reached
  from exactly one selector are "owned" by it (shared runtime helpers
  stay unowned), giving fleet scheduling a per-function work partition.
* **loops** — natural loops from the dominator tree: a back edge is a
  CFG edge ``u -> h`` where ``h`` dominates ``u``; the loop body is the
  reverse-reachable set from ``u`` that stays below ``h``. Emitted as
  per-loop-header hint tables (header pc, back-edge sites, body, nesting
  depth) for bounded-unroll lane budgeting in the device frontier.
* **sinks** — the taint pass's per-sink-site operand verdicts plus the
  reachable opcode set the module screen consults.

Consumers go through ``analysis/module_screen.py`` (the counted adapter,
mirroring ``smt/solver/cfa_screen.py`` for the cfa tables); the serve
daemon persists summaries by code hash via ``to_json``/``from_json``.
Stdlib-only: the port's own copy of the JAX package's module.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .cfa import CfaResult
from .taint import SinkSite, TaintResult, build_taint

log = logging.getLogger(__name__)

#: bump when the JSON layout changes; from_json rejects other versions
SUMMARY_VERSION = 1


@dataclass
class FunctionInfo:
    """One public function recovered from the dispatcher."""

    name: str                     #: signature or _function_0x<selector>
    selector: Optional[str]       #: 0x-prefixed 4-byte hash, None = fallback
    entry_pc: int
    blocks: Tuple[int, ...]       #: block ids reachable from the entry
    ops: FrozenSet[str]           #: opcodes appearing in those blocks

    def to_json(self) -> dict:
        return {"name": self.name, "selector": self.selector,
                "entry_pc": self.entry_pc, "blocks": list(self.blocks),
                "ops": sorted(self.ops)}

    @classmethod
    def from_json(cls, data: dict) -> "FunctionInfo":
        return cls(name=str(data["name"]), selector=data.get("selector"),
                   entry_pc=int(data["entry_pc"]),
                   blocks=tuple(int(b) for b in data["blocks"]),
                   ops=frozenset(data["ops"]))


@dataclass
class LoopInfo:
    """One natural loop (per-loop-header hint table row)."""

    header_pc: int
    header_block: int
    back_edge_pcs: Tuple[int, ...]   #: pc of each back-edge jump site
    blocks: Tuple[int, ...]          #: body block ids, header included
    depth: int                       #: nesting depth, outermost = 1

    def to_json(self) -> dict:
        return {"header_pc": self.header_pc,
                "header_block": self.header_block,
                "back_edge_pcs": list(self.back_edge_pcs),
                "blocks": list(self.blocks), "depth": self.depth}

    @classmethod
    def from_json(cls, data: dict) -> "LoopInfo":
        return cls(header_pc=int(data["header_pc"]),
                   header_block=int(data["header_block"]),
                   back_edge_pcs=tuple(int(p)
                                       for p in data["back_edge_pcs"]),
                   blocks=tuple(int(b) for b in data["blocks"]),
                   depth=int(data["depth"]))


@dataclass
class ContractSummary:
    """The per-contract static summary the screens and the serve daemon
    consume. Block ids refer to the contract's ``CfaResult``."""

    code_length: int
    functions: Tuple[FunctionInfo, ...]
    loops: Tuple[LoopInfo, ...]
    sink_sites: Dict[int, SinkSite]       #: site pc -> operand taints
    reachable_ops: FrozenSet[str]
    rounds: int                           #: storage rounds the fixpoint ran
    converged: bool
    loop_header_of: Dict[int, int] = field(default_factory=dict)
    #: block id -> innermost loop header pc
    function_of: Dict[int, int] = field(default_factory=dict)
    #: block id -> index into `functions` (uniquely-owned blocks only)

    # -- queries (the consumer surface) ------------------------------------------
    def sink_at(self, pc: int) -> Optional[SinkSite]:
        return self.sink_sites.get(pc)

    def function_order(self) -> Tuple[int, ...]:
        """Function entry pcs in dispatcher order (selector functions
        first, by entry pc)."""
        return tuple(f.entry_pc for f in self.functions)

    @property
    def n_sink_sites(self) -> int:
        return len(self.sink_sites)

    def to_json(self) -> dict:
        return {
            "version": SUMMARY_VERSION,
            "code_length": self.code_length,
            "functions": [f.to_json() for f in self.functions],
            "loops": [l.to_json() for l in self.loops],
            "sink_sites": {str(pc): site.to_json()
                           for pc, site in sorted(self.sink_sites.items())},
            "reachable_ops": sorted(self.reachable_ops),
            "rounds": self.rounds,
            "converged": self.converged,
            "loop_header_of": {str(b): pc for b, pc
                               in sorted(self.loop_header_of.items())},
            "function_of": {str(b): i for b, i
                            in sorted(self.function_of.items())},
        }

    @classmethod
    def from_json(cls, data: dict) -> Optional["ContractSummary"]:
        """Rebuild a summary from its JSON form; None when the payload is
        malformed or from another summary version (callers fall back to a
        fresh build)."""
        try:
            if int(data["version"]) != SUMMARY_VERSION:
                return None
            return cls(
                code_length=int(data["code_length"]),
                functions=tuple(FunctionInfo.from_json(f)
                                for f in data["functions"]),
                loops=tuple(LoopInfo.from_json(l) for l in data["loops"]),
                sink_sites={int(pc): SinkSite.from_json(site)
                            for pc, site in data["sink_sites"].items()},
                reachable_ops=frozenset(data["reachable_ops"]),
                rounds=int(data["rounds"]),
                converged=bool(data["converged"]),
                loop_header_of={int(b): int(pc) for b, pc
                                in data["loop_header_of"].items()},
                function_of={int(b): int(i) for b, i
                             in data["function_of"].items()},
            )
        except (KeyError, TypeError, ValueError, AttributeError):
            return None


# -- structural passes ---------------------------------------------------------------

def _function_cover(cfa: CfaResult, entry_block: int) -> List[int]:
    """Block ids reachable from `entry_block` along CFG edges (virtual
    exit excluded), sorted."""
    seen: Set[int] = {entry_block}
    stack = [entry_block]
    while stack:
        block = cfa.blocks[stack.pop()]
        for succ in block.successors:
            if succ != cfa.exit_id and succ not in seen:
                seen.add(succ)
                stack.append(succ)
    return sorted(seen)


def recover_functions(disassembly,
                      cfa: CfaResult) -> Tuple[Tuple[FunctionInfo, ...],
                                               Dict[int, int]]:
    """Cross-check the disassembler's dispatcher table against the CFA
    and expand each entry to its block cover; returns (functions,
    block id -> unique owner index)."""
    instructions = disassembly.instruction_list
    name_to_hash = getattr(disassembly, "function_name_to_hash", {}) or {}
    entries = sorted(
        (getattr(disassembly, "function_name_to_address", {}) or {}).items(),
        key=lambda kv: kv[1])
    functions: List[FunctionInfo] = []
    covers: List[List[int]] = []
    for name, entry_pc in entries:
        block = cfa.block_at(entry_pc)
        if block is None or block not in cfa.reachable \
                or not cfa.is_valid_target(entry_pc):
            continue  # dispatcher pattern matched dead/invalid code
        cover = _function_cover(cfa, block)
        ops = frozenset(
            instructions[index].op_code
            for bid in cover
            for index in range(cfa.blocks[bid].first_index,
                               cfa.blocks[bid].last_index + 1))
        functions.append(FunctionInfo(
            name=name, selector=name_to_hash.get(name), entry_pc=entry_pc,
            blocks=tuple(cover), ops=ops))
        covers.append(cover)
    function_of: Dict[int, int] = {}
    owner_count: Dict[int, int] = {}
    for index, cover in enumerate(covers):
        for bid in cover:
            owner_count[bid] = owner_count.get(bid, 0) + 1
            function_of[bid] = index
    function_of = {bid: index for bid, index in function_of.items()
                   if owner_count[bid] == 1}
    return tuple(functions), function_of


def recover_loops(cfa: CfaResult, instructions) -> Tuple[Tuple[LoopInfo, ...],
                                                         Dict[int, int]]:
    """Natural loops from the dominator tree; returns (loops, block id ->
    innermost loop header pc)."""
    instructions_pc = {block.block_id: block.start_pc
                       for block in cfa.blocks}

    def dominates(a: int, b: int) -> bool:
        node: Optional[int] = b
        while node is not None:
            if node == a:
                return True
            if node == 0:
                return False
            node = cfa.idom[node] if node < len(cfa.idom) else None
        return False

    preds: Dict[int, List[int]] = {}
    for block in cfa.blocks:
        if block.block_id not in cfa.reachable:
            continue
        for succ in block.successors:
            if succ != cfa.exit_id:
                preds.setdefault(succ, []).append(block.block_id)

    bodies: Dict[int, Set[int]] = {}       # header block -> body
    back_sites: Dict[int, List[int]] = {}  # header block -> back-edge pcs
    for block in cfa.blocks:
        if block.block_id not in cfa.reachable:
            continue
        for succ in block.successors:
            if succ == cfa.exit_id or succ not in cfa.reachable:
                continue
            if not dominates(succ, block.block_id):
                continue
            header = succ
            body = bodies.setdefault(header, {header})
            # the back-edge site is the block's jump instruction; for
            # fallthrough back edges report the block start
            if block.terminator in ("JUMP", "JUMPI"):
                site_pc = instructions[block.last_index].address
            else:
                site_pc = block.start_pc
            back_sites.setdefault(header, []).append(site_pc)
            stack = [block.block_id]
            if block.block_id != header:
                body.add(block.block_id)
            while stack:
                node = stack.pop()
                if node == header:
                    continue
                for pred in preds.get(node, ()):
                    if pred not in body:
                        body.add(pred)
                        stack.append(pred)
    loops: List[LoopInfo] = []
    for header in sorted(bodies):
        depth = 1 + sum(1 for other, body in bodies.items()
                        if other != header and header in body)
        loops.append(LoopInfo(
            header_pc=instructions_pc[header], header_block=header,
            back_edge_pcs=tuple(sorted(set(back_sites[header]))),
            blocks=tuple(sorted(bodies[header])), depth=depth))
    loop_header_of: Dict[int, int] = {}
    for loop in sorted(loops, key=lambda l: -len(l.blocks)):
        for bid in loop.blocks:
            loop_header_of[bid] = loop.header_pc  # smallest body wins
    return tuple(loops), loop_header_of


def build_summary(disassembly,
                  cfa: Optional[CfaResult]) -> Optional[ContractSummary]:
    """Build the full summary for one contract over its CfaResult; None
    when the cfa tables are unavailable or the taint fixpoint bailed."""
    if cfa is None:
        return None
    instructions = disassembly.instruction_list
    taint: Optional[TaintResult] = build_taint(cfa, instructions)
    if taint is None:
        return None
    functions, function_of = recover_functions(disassembly, cfa)
    loops, loop_header_of = recover_loops(cfa, instructions)
    return ContractSummary(
        code_length=cfa.code_length,
        functions=functions, loops=loops,
        sink_sites=taint.sink_sites, reachable_ops=taint.reachable_ops,
        rounds=taint.rounds, converged=taint.converged,
        loop_header_of=loop_header_of, function_of=function_of)
