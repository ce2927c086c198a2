"""Taint-summary screening of detection modules (the module screen).

The counted adapter between the per-contract taint summaries
(``staticanalysis/summary.py``) and the opcode-hook-driven detection
modules — the same consumer-funnel shape ``smt/solver/cfa_screen.py``
gives the cfa tables. Two screening levels:

* **module-level** (:func:`screen_modules`, consulted once at hook
  registration): a module whose pre+post hook opcodes none appear in the
  contract's reachable code can never fire — skipping it wholesale is
  trivially detection-identical. Only applied when no dynamic loader is
  configured and the contract cannot spawn code at runtime
  (CREATE/CREATE2 reachable ⇒ hooks may fire on constructor bytecode the
  summary never saw).
* **site-level** (:func:`should_skip_site`, consulted per pre-hook
  firing): a module may declare, via its ``taint_sinks`` attribute, that
  specific operands being untainted at a hook site makes an issue
  impossible there; the screen then skips the hook — and its solver
  queries — at sites the summary proves untainted. Untainted means
  "deterministic function of the bytecode alone" (see
  ``staticanalysis/taint.py``), so the declaration must hold for
  deterministic operand values too; modules that cannot promise that
  declare presence-only sinks (empty operand tuple) and are never
  site-screened.

Everything funnels through :func:`enabled` — ``args.taint`` and the
``ENABLED["taint"]`` switch disable both levels for A/B parity runs, and
a missing summary (cfa bailed, fixpoint blew its cap) means "no verdict":
every module runs, every hook fires. Skips are counted in the
``taint.screen.*`` metrics.

The port's own copy of the JAX package's module.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..observe import metrics
from ..staticanalysis import ENABLED, ContractSummary, get_summary
from ..support.support_args import args


def enabled() -> bool:
    """Screening on? Both the flag (`args.taint`) and the pass switch
    (``ENABLED["taint"]``) can turn the consumers off."""
    return bool(getattr(args, "taint", True)) and ENABLED["taint"]


def summary_for(disassembly) -> Optional[ContractSummary]:
    """The contract's taint summary, or None when screening is disabled
    or the analysis had no verdict."""
    if not enabled() or disassembly is None:
        return None
    return get_summary(disassembly)


def warm(disassembly) -> None:
    """Force-build the summary ahead of the hot path (lane seeding,
    serve warmup)."""
    summary_for(disassembly)


def module_hook_ops(module) -> frozenset:
    """Every opcode a module hooks, pre and post."""
    return frozenset(getattr(module, "pre_hooks", None) or ()) \
        | frozenset(getattr(module, "post_hooks", None) or ())


def screen_modules(modules: Sequence, disassembly) -> Tuple[List, List]:
    """Partition `modules` into (kept, skipped): skipped modules hook
    only opcodes absent from the contract's reachable code, so their
    hooks can never fire. Returns everything kept when screening is off,
    the summary is missing, or the contract can spawn code at runtime."""
    modules = list(modules)
    summary = summary_for(disassembly)
    if summary is None:
        return modules, []
    if summary.reachable_ops & {"CREATE", "CREATE2"}:
        # runtime-spawned constructor code executes under this contract's
        # hook set but was never summarized — no sound whole-module skip
        return modules, []
    kept, skipped = [], []
    for module in modules:
        hooks = module_hook_ops(module)
        if hooks and not (hooks & summary.reachable_ops):
            skipped.append(module)
        else:
            kept.append(module)
    if skipped:
        metrics.inc("taint.screen.modules_skipped", len(skipped))
    return kept, skipped


def should_skip_site(module, op_code: str, global_state) -> bool:
    """True when the summary proves the module's declared sink operands
    untainted (deterministic) at this pre-hook site, so executing the
    module cannot produce an issue here. Conservative on every miss:
    undeclared ops, presence-only sinks, unknown pcs, and missing
    summaries all run the hook."""
    sinks = getattr(module, "taint_sinks", None)
    if not sinks:
        return False
    operand_indices = sinks.get(op_code)
    if not operand_indices:
        return False  # undeclared or presence-only: not site-screenable
    try:
        disassembly = global_state.environment.code
        pc = global_state.get_current_instruction()["address"]
    except (AttributeError, IndexError, KeyError, TypeError):
        return False
    summary = summary_for(disassembly)
    if summary is None:
        return False
    site = summary.sink_at(pc)
    if site is None or site.op != op_code:
        return False  # site the summary never saw: run the hook
    try:
        untainted = all(not site.operand_taint[index]
                        for index in operand_indices)
    except IndexError:
        return False
    if untainted:
        metrics.inc("taint.screen.sites_skipped")
        return True
    return False


def loop_header_at(disassembly, pc: int) -> Optional[int]:
    """Header pc of the innermost natural loop containing `pc`, or None
    (no loop, screening off, no verdict). The frontier tags lanes with
    this for bounded-unroll budgeting."""
    summary = summary_for(disassembly)
    if summary is None or not summary.loop_header_of:
        return None
    from ..staticanalysis import get_cfa
    cfa = get_cfa(disassembly)
    if cfa is None:
        return None
    block = cfa.block_at(pc)
    if block is None:
        return None
    return summary.loop_header_of.get(block)


def function_order(disassembly) -> Tuple[int, ...]:
    """Function entry pcs in dispatcher order; () without a verdict.
    Fleet seeding uses this to group per-function work."""
    summary = summary_for(disassembly)
    if summary is None:
        return ()
    return summary.function_order()
