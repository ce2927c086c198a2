"""Static control-flow analysis (cfa) of EVM bytecode.

Stdlib-only: block recovery, jump-target resolution via abstract
stack/constant dataflow, CFG + dominator/post-dominator trees, and the
dense device-consumable tables (pc->block, merge-pc, refined JUMPDEST
bitmap, dead-code mask) that frontier pruning and on-device state
merging (ROADMAP item 3) consume.

Entry point for consumers: :func:`get_cfa` — memoized per Disassembly,
returns None when analysis is disabled or bails (over the block budget),
in which case callers keep their dynamic paths.

On top of the cfa tables, :mod:`.taint` + :mod:`.summary` add a
source->sink taint dataflow, selector/function partitioning, and
natural-loop hint tables; :func:`get_summary` is the memoized entry
point with the same None-means-no-verdict contract. :mod:`.absint`
adds the value-range / memory-region abstract interpretation (interval
stack cells, diamond write regions, proven loop bounds, constant-JUMPI
verdicts) behind :func:`get_absint`, same contract again.

The port's own copy of the JAX package's static analysis (stdlib only).
The three passes are switched by :data:`ENABLED` (all on, as the JAX
package's MYTHRIL_TPU_CFA / TAINT / ABSINT knobs default); each build is
a span (``cfa.build``, ``taint.build``, ``absint.build``) and counted on
the metric registry, as the JAX package's are.
"""

from __future__ import annotations

from typing import Optional

from .absint import AbsintResult, build_absint
from .cfa import BasicBlock, CfaResult, TERMINATORS, build_cfa
from .domtree import compute_idoms, dominator_depth, postorder
from .summary import ContractSummary, FunctionInfo, LoopInfo, build_summary
from .taint import SinkSite, TaintResult, build_taint

__all__ = [
    "AbsintResult",
    "BasicBlock",
    "CfaResult",
    "ContractSummary",
    "FunctionInfo",
    "LoopInfo",
    "SinkSite",
    "TERMINATORS",
    "TaintResult",
    "build_absint",
    "build_cfa",
    "build_summary",
    "build_taint",
    "compute_idoms",
    "dominator_depth",
    "get_absint",
    "get_cfa",
    "get_summary",
    "install_summary",
    "postorder",
    "ENABLED",
]

#: the passes' switches: a pass switched off leaves its getter at None
ENABLED = {"cfa": True, "taint": True, "absint": True}

_MISS = object()  # memo sentinel: distinguishes "not built" from "bailed"


def get_cfa(disassembly) -> Optional[CfaResult]:
    """Build (once) and return the CFA tables for a Disassembly.

    Memoized on the Disassembly instance itself (`_cfa_result`), so every
    consumer of the same contract shares one build. Returns None when the
    pass is switched off (``ENABLED["cfa"]``) or bailed out; the None
    verdict is memoized too, so a bailing contract pays the bail check once.
    """
    from ..observe import metrics, trace

    cached = getattr(disassembly, "_cfa_result", _MISS)
    if cached is not _MISS:
        return cached

    if not ENABLED["cfa"]:
        disassembly._cfa_result = None
        return None

    with trace.span("cfa.build") as span:
        result = build_cfa(disassembly)
        if result is None:
            span.set(bailed=True)
        else:
            span.set(
                blocks=len(result.blocks),
                edges=result.n_edges,
                resolved=len(result.jump_targets),
                unresolved=len(result.unresolved_jumps),
                merge_points=len(result.merge_points),
            )
            metrics.inc("cfa.blocks", len(result.blocks))
            metrics.inc("cfa.jumps_resolved", len(result.jump_targets))
            metrics.inc("cfa.jumps_unresolved",
                        len(result.unresolved_jumps))
            metrics.inc("cfa.merge_points", len(result.merge_points))
            metrics.inc("cfa.dead_bytes", result.dead_bytes)
    disassembly._cfa_result = result
    return result


def get_summary(disassembly) -> Optional[ContractSummary]:
    """Build (once) and return the taint/function/loop summary for a
    Disassembly.

    Memoized on the Disassembly instance (`_taint_summary`), like
    :func:`get_cfa`. Returns None when ``ENABLED["taint"]`` is off, the
    cfa tables are unavailable, or the taint fixpoint bailed — consumers
    treat None as "no verdict" and keep their dynamic paths.
    """
    from ..observe import metrics, trace

    cached = getattr(disassembly, "_taint_summary", _MISS)
    if cached is not _MISS:
        return cached

    if not ENABLED["taint"]:
        disassembly._taint_summary = None
        return None

    cfa = get_cfa(disassembly)
    if cfa is None:
        disassembly._taint_summary = None
        return None

    with trace.span("taint.build") as span:
        result = build_summary(disassembly, cfa)
        if result is None:
            span.set(bailed=True)
        else:
            span.set(
                functions=len(result.functions),
                loops=len(result.loops),
                sinks=len(result.sink_sites),
                rounds=result.rounds,
            )
            metrics.inc("taint.functions", len(result.functions))
            metrics.inc("taint.loops", len(result.loops))
    disassembly._taint_summary = result
    return result


def install_summary(disassembly, summary: Optional[ContractSummary]) -> None:
    """Pre-seed the summary memo (serve warm path: summaries persisted by
    code hash skip the rebuild on repeat contracts)."""
    disassembly._taint_summary = summary


def get_absint(disassembly) -> Optional[AbsintResult]:
    """Build (once) and return the value-range/memory-region tables for
    a Disassembly.

    Memoized on the Disassembly instance (`_absint_result`), like
    :func:`get_cfa`. Returns None when ``ENABLED["absint"]`` is off, the
    cfa tables are unavailable, or the fixpoint bailed — consumers
    treat None as "no verdict" and keep their dynamic paths.
    """
    import time

    from ..observe import metrics, trace

    cached = getattr(disassembly, "_absint_result", _MISS)
    if cached is not _MISS:
        return cached

    if not ENABLED["absint"]:
        disassembly._absint_result = None
        return None

    cfa = get_cfa(disassembly)
    if cfa is None:
        disassembly._absint_result = None
        return None

    with trace.span("absint.build") as span:
        start = time.perf_counter()
        result = build_absint(disassembly, cfa)
        if result is None:
            span.set(bailed=True)
        else:
            span.set(
                blocks=len(result.entry_intervals),
                widenings=result.widenings,
                regions=result.regions_proven,
                loop_bounds=len(result.loop_bounds),
                const_jumpis=len(result.const_jumpis),
            )
            metrics.observe(
                "absint.build_ms",
                (time.perf_counter() - start) * 1000.0)
            metrics.inc("absint.widenings", result.widenings)
            metrics.inc("absint.regions_proven", result.regions_proven)
    disassembly._absint_result = result
    return result
