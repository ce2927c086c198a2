"""Pre-solver screen backed by the static CFA tables.

The host engine decides jump-target validity dynamically on every
JUMP/JUMPI execution (``index_of_address`` + opcode check), and several
modules re-derive target sets per state. The CFA pass already knows the
answers per *contract*: this module is the thin, counted adapter between
the two worlds — consumers call it with a Disassembly + pc and get
either a static verdict or None, in which case they keep their dynamic
path.

Soundness: CFA reachability over-approximates real reachability, so
every concretely-reachable JUMPDEST is in the refined bitmap and screen
verdicts coincide with the dynamic check — `--no-cfa` vs default produce
identical detection results by construction. The only divergence is
*work*: invalid/dead targets are dropped before any constraint is built
or solver query issued.

Everything funnels through :func:`enabled` so ``--no-cfa`` (the
``args.cfa`` singleton field) and the ``ENABLED["cfa"]`` switch both gate
the whole surface for A/B runs.

The port's own copy of the JAX package's module; its ``cfa.screen.*`` and
``absint.*`` counters wait for the port's metric registry.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ...staticanalysis import (ENABLED, AbsintResult, CfaResult, get_absint,
                               get_cfa)
from ...support.support_args import args

__all__ = [
    "enabled",
    "cfa_for",
    "screen_jump_target",
    "resolved_jump_targets",
    "merge_point_at",
    "statically_dead",
    "block_key",
    "warm",
    "absint_enabled",
    "absint_for",
    "jumpi_verdict",
    "loop_bound_at",
    "merge_mem_windows",
    "merge_window_pcs",
]


def enabled() -> bool:
    """The screen is live: neither --no-cfa nor the cfa switch off."""
    return bool(getattr(args, "cfa", True)) and ENABLED["cfa"]


def absint_enabled() -> bool:
    """The value-range screen is live: the cfa screen is on AND neither
    --no-absint nor the absint switch off."""
    return enabled() and bool(getattr(args, "absint", True)) \
        and ENABLED["absint"]


def cfa_for(disassembly) -> Optional[CfaResult]:
    """The (memoized) CFA tables for a contract, or None when the screen
    is off or the pass bailed."""
    if disassembly is None or not enabled():
        return None
    return get_cfa(disassembly)


def warm(disassembly) -> None:
    """Build the tables eagerly (e.g. at frontier seed time) so the
    first screened jump doesn't pay the build inside the step loop.
    Warms the absint tables too when that screen is live."""
    cfa_for(disassembly)
    absint_for(disassembly)


def screen_jump_target(disassembly, jump_address: int) -> Optional[bool]:
    """Static validity verdict for a concrete jump target.

    True  -> `jump_address` is a statically-reachable JUMPDEST;
    False -> provably not a valid target (prune before the solver);
    None  -> no verdict (screen off, pass bailed, address out of range).
    """
    result = cfa_for(disassembly)
    if result is None:
        return None
    if not 0 <= jump_address < result.code_length:
        return None  # out-of-range: leave to the dynamic path's error
    return result.is_valid_target(jump_address)


def resolved_jump_targets(disassembly,
                          site_pc: int) -> Optional[Tuple[int, ...]]:
    """Statically-resolved target pcs of the jump site at `site_pc`;
    () when the site provably throws; None when unresolved/unscreened."""
    result = cfa_for(disassembly)
    if result is None:
        return None
    return result.resolved_targets(site_pc)


def merge_point_at(disassembly, pc: int) -> Optional[int]:
    """The post-dominator merge pc the block containing `pc` flows into,
    or None (no merge / no verdict)."""
    result = cfa_for(disassembly)
    if result is None:
        return None
    return result.merge_pc_at(pc)


def statically_dead(disassembly, pc: int) -> bool:
    """True only when `pc` is PROVEN unreachable (False = no claim)."""
    result = cfa_for(disassembly)
    return bool(result is not None and result.is_dead(pc))


def absint_for(disassembly) -> Optional[AbsintResult]:
    """The (memoized) value-range/memory-region tables for a contract,
    or None when the absint screen is off or the fixpoint bailed."""
    if disassembly is None or not absint_enabled():
        return None
    return get_absint(disassembly)


def jumpi_verdict(disassembly, site_pc: int) -> Optional[bool]:
    """Static branch-direction verdict for the JUMPI at `site_pc`.

    True  -> the condition is provably always nonzero (always taken);
    False -> provably always zero (never taken);
    None  -> no verdict (screen off, bailed, data-dependent condition).

    The infeasible side is dropped before any constraint is appended or
    solver query issued."""
    result = absint_for(disassembly)
    if result is None:
        return None
    return result.jumpi_verdict(site_pc)


def loop_bound_at(disassembly, header_pc: int) -> Optional[int]:
    """Statically proven header-arrival bound for the natural loop at
    `header_pc`, or None (no proof / no verdict)."""
    result = absint_for(disassembly)
    if result is None:
        return None
    return result.loop_bound(header_pc)


def merge_mem_windows(disassembly, join_pc: int):
    """Non-overlapping 32-byte window start offsets covering the proven
    diamond write regions at `join_pc`, or None (untracked join / screen
    off). The frontier ships these to the widened merge phase."""
    result = absint_for(disassembly)
    if result is None:
        return None
    return result.word_windows(join_pc)


#: ops that write the memory plane — a join's window fact stops
#: bounding NEW divergence past the block's first such instruction
_MEM_WRITERS = frozenset({
    "MSTORE", "MSTORE8", "CALLDATACOPY", "CODECOPY", "EXTCODECOPY",
    "RETURNDATACOPY", "MCOPY", "CALL", "CALLCODE", "DELEGATECALL",
    "STATICCALL"})


def merge_window_pcs(disassembly, join_pc: int) -> Tuple[int, ...]:
    """Every pc of the join block where the join's window fact still
    bounds any arm-divergent memory bytes: from `join_pc` through the
    block's first memory-writing instruction (inclusive — a lane
    sitting ON the writer has not executed it yet).

    The widened merge phase is eligibility-gated on the lane pc at pass
    time, and the merge cadence can land a chunk after the lanes step
    off the join — shipping a row per covered pc keeps the reconverged
    pair mergeable anywhere in the join block. Rows past a memory write
    would merely fail the kernel's diff-containment check (missed
    blend, never a wrong one), but they carry no signal, so stop."""
    cfa = cfa_for(disassembly)
    block = cfa.block_at(join_pc) if cfa is not None else None
    if block is None:
        return (join_pc,)
    info = cfa.blocks[block]
    pcs = []
    for ins in disassembly.instruction_list[
            info.first_index:info.last_index + 1]:
        if ins.address < join_pc:
            continue
        pcs.append(ins.address)
        if ins.op_code in _MEM_WRITERS:
            break
    return tuple(pcs) or (join_pc,)


def block_key(disassembly, pc: int) -> int:
    """Stable basic-block key for `pc` — the block's start pc, so
    per-block bookkeeping (dependency pruner) keys one entry per block
    instead of re-deriving JUMPDEST sets. Falls back to `pc` itself when
    there is no verdict."""
    result = cfa_for(disassembly)
    if result is None:
        return pc
    block = result.block_at(pc)
    return result.blocks[block].start_pc if block is not None else pc
