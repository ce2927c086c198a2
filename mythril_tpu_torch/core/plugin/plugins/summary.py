"""Symbolic transaction summaries: record a transaction's effect once, replay
it on later transactions instead of re-executing (capability parity:
mythril/laser/plugin/plugins/summary/core.py:59,118,240 + summary.py:88).

A summary is a transaction's effect — (path condition delta, storage-write
chains, balance-write chain) — parameterized over a symbolic entry state:
at transaction entry every account's storage is swapped for a fresh
placeholder array `summary_storage_<addr>` (balances for `summary_balance`),
so the recorded store chains and constraints are functions of *any* entry
state. Applying a summary substitutes the placeholders with the target
state's actual arrays and the recording transaction's input symbols
(sender/calldata/callvalue/gasprice) with the current transaction's, then
feasibility-checks the combined constraints.

Because this framework's terms are immutable and hash-consed, recording works
by raw-term substitution (terms.substitute) instead of the reference's
in-place z3 AST rewriting — one mapping dict per apply, shared across the
whole state via the substitution cache.

Enabled by `--enable-summaries`.

The port's copy of mythril_tpu/core/plugin/plugins/summary.py."""

from __future__ import annotations

import logging
from copy import copy, deepcopy
from typing import Dict, List, Optional, Tuple

from ....exceptions import UnsatError
from ....smt import Array, Bool, symbol_factory, terms
from ....support.model import get_model
from ...state.annotation import StateAnnotation
from ...state.global_state import GlobalState
from ...transaction.transaction_models import (BaseTransaction,
                                               ContractCreationTransaction)
from ..builder import PluginBuilder
from ..interface import LaserPlugin
from ..signals import PluginSkipState
from .mutation_pruner import MutationAnnotation

log = logging.getLogger(__name__)


def _placeholder_storage(address: int) -> Array:
    return Array(f"summary_storage_{address}", 256, 256)


def _placeholder_balances() -> Array:
    return Array("summary_balance", 256, 256)


def _tx_symbol_mapping(recorded_tx_id: str, current_tx_id: str
                       ) -> Dict[terms.Term, terms.Term]:
    """Rename the recording transaction's input symbols to the current
    transaction's (naming scheme: core/transaction/symbolic.py:91-103 and
    core/state/calldata.py:135-138)."""
    mapping: Dict[terms.Term, terms.Term] = {}
    for template in ("sender_{}", "call_value{}", "gas_price{}",
                     "{}_calldatasize"):
        old = symbol_factory.BitVecSym(template.format(recorded_tx_id), 256)
        new = symbol_factory.BitVecSym(template.format(current_tx_id), 256)
        mapping[old.raw] = new.raw
    old_calldata = Array(f"{recorded_tx_id}_calldata", 256, 8)
    new_calldata = Array(f"{current_tx_id}_calldata", 256, 8)
    mapping[old_calldata.raw] = new_calldata.raw
    return mapping


class SummaryTrackingAnnotation(StateAnnotation):
    """Rides on the global state between summary entry and transaction end."""

    def __init__(self, entry_constraint_count: int,
                 storage_pairs: List[Tuple[int, terms.Term, terms.Term]],
                 balance_pair: Tuple[terms.Term, terms.Term],
                 code: str, tx_id: str):
        #: constraints past this index are the summary's path condition
        self.entry_constraint_count = entry_constraint_count
        #: (address, original storage raw, placeholder raw)
        self.storage_pairs = storage_pairs
        #: (original balances raw, placeholder raw)
        self.balance_pair = balance_pair
        self.code = code
        self.tx_id = tx_id
        self.trace: List[int] = []

    @property
    def persist_over_calls(self) -> bool:
        return True


class SymbolicSummary:
    """One recorded transaction effect (reference summary/summary.py:13)."""

    def __init__(self, code: str, tx_id: str, condition: List[terms.Term],
                 storage_effect: List[Tuple[int, terms.Term]],
                 balance_effect: terms.Term, revert: bool,
                 issues: Optional[list] = None):
        self.code = code
        self.tx_id = tx_id
        self.condition = condition
        self.storage_effect = storage_effect
        self.balance_effect = balance_effect
        self.revert = revert
        #: (conditions_raw, Issue, detector) captured from IssueAnnotations
        self.issues = issues or []
        self.applications = 0

    @property
    def as_dict(self) -> Dict:
        return dict(code_hash=hash(self.code), tx_id=self.tx_id,
                    conditions=len(self.condition),
                    storage_effects=len(self.storage_effect),
                    revert=self.revert, applications=self.applications)


class SymbolicSummaryPlugin(LaserPlugin):
    def __init__(self):
        self.summaries: List[SymbolicSummary] = []
        #: issues already promoted: (swc_id, address, code)
        self.issue_cache: set = set()
        # defer detector issue emission to summary-validation time — during
        # recording the state's storage is an unconstrained placeholder, so a
        # detector's immediate verdict could be a false positive
        # (reference core.py:61 sets the same flag)
        from ....support.support_args import args

        args.use_issue_annotations = True

    def initialize(self, symbolic_vm) -> None:
        self._vm = symbolic_vm

        @symbolic_vm.laser_hook("execute_state")
        def entry_hook(global_state: GlobalState):
            if global_state.mstate.pc != 0:
                return
            if len(global_state.transaction_stack) != 1:
                return  # record only outermost message calls
            if isinstance(global_state.current_transaction,
                          ContractCreationTransaction):
                return
            if list(global_state.get_annotations(SummaryTrackingAnnotation)):
                return
            self._apply_summaries(symbolic_vm, global_state)
            self._summary_entry(global_state)

        @symbolic_vm.laser_hook("transaction_end")
        def exit_hook(global_state: GlobalState, transaction: BaseTransaction,
                      return_global_state: Optional[GlobalState],
                      revert: bool):
            if return_global_state is not None:
                return  # nested frame: the summary spans the outer tx
            annotations = list(
                global_state.get_annotations(SummaryTrackingAnnotation))
            if not annotations:
                return
            annotation = annotations[0]
            global_state.annotations.remove(annotation)
            self._summary_exit(global_state, annotation, revert)

        @symbolic_vm.laser_hook("stop_sym_exec")
        def stop_hook():
            applied = sum(s.applications for s in self.summaries)
            log.info("recorded %d symbolic summaries (%d applications)",
                     len(self.summaries), applied)

    # -- recording -------------------------------------------------------------------

    def _summary_entry(self, global_state: GlobalState) -> None:
        """Swap persistent state for placeholders so the transaction records
        its effect as a function of an arbitrary entry state
        (reference core.py:118)."""
        world_state = global_state.world_state
        storage_pairs = []
        for address, account in world_state.accounts.items():
            original = account.storage._standard_storage.raw
            placeholder = _placeholder_storage(address)
            account.storage._standard_storage.raw = placeholder.raw
            storage_pairs.append((address, original, placeholder.raw))

        original_balances = world_state.balances.raw
        placeholder_balances = _placeholder_balances()
        world_state.balances.raw = placeholder_balances.raw

        annotation = SummaryTrackingAnnotation(
            entry_constraint_count=len(world_state.constraints),
            storage_pairs=storage_pairs,
            balance_pair=(original_balances, placeholder_balances.raw),
            code=global_state.environment.code.bytecode,
            tx_id=str(global_state.current_transaction.id))
        global_state.annotate(annotation)

    def _summary_exit(self, global_state: GlobalState,
                      annotation: SummaryTrackingAnnotation,
                      revert: bool) -> None:
        """Record the effect and substitute the placeholders back so normal
        exploration continues unchanged (reference core.py:323)."""
        world_state = global_state.world_state
        mutated = bool(list(global_state.get_annotations(MutationAnnotation)))

        from ....analysis.issue_annotation import IssueAnnotation

        issue_annotations = list(global_state.get_annotations(IssueAnnotation))
        condition = [c.raw for c in
                     world_state.constraints[annotation.entry_constraint_count:]]
        storage_effect = []
        for address, _original, placeholder in annotation.storage_pairs:
            account = world_state.accounts.get(address)
            if account is None:
                continue
            final = account.storage._standard_storage.raw
            if final is not placeholder:  # something was stored
                storage_effect.append((address, final))
        if (mutated or issue_annotations) and not revert:
            self.summaries.append(SymbolicSummary(
                code=annotation.code, tx_id=annotation.tx_id,
                condition=condition, storage_effect=storage_effect,
                balance_effect=world_state.balances.raw, revert=revert,
                issues=[([c.raw for c in ia.conditions], ia.issue, ia.detector)
                        for ia in issue_annotations]))

        # restore: placeholder -> original, applied across the whole state
        mapping: Dict[terms.Term, terms.Term] = {
            placeholder: original
            for _addr, original, placeholder in annotation.storage_pairs}
        mapping[annotation.balance_pair[1]] = annotation.balance_pair[0]
        self._substitute_state(global_state, mapping,
                               annotation.entry_constraint_count)

        # promote this transaction's issues against the RESTORED state (the
        # placeholder-based detector verdicts were provisional)
        for issue_annotation in issue_annotations:
            self._check_issue(
                global_state,
                [terms.substitute(c.raw, mapping)
                 for c in issue_annotation.conditions],
                issue_annotation.issue, issue_annotation.detector)

    @staticmethod
    def _substitute_state(global_state: GlobalState,
                          mapping: Dict[terms.Term, terms.Term],
                          from_constraint: int) -> None:
        world_state = global_state.world_state
        constraints = world_state.constraints
        for index in range(from_constraint, len(constraints)):
            constraints[index] = Bool(
                terms.substitute(constraints[index].raw, mapping),
                constraints[index].annotations)
        for account in world_state.accounts.values():
            storage = account.storage
            storage._standard_storage.raw = terms.substitute(
                storage._standard_storage.raw, mapping)
        world_state.balances.raw = terms.substitute(world_state.balances.raw,
                                                    mapping)

    def _check_issue(self, global_state: GlobalState,
                     conditions_raw: List[terms.Term], issue, detector) -> None:
        """Validate a deferred issue against a concrete state and promote it
        (reference core.py:276 _check_issue)."""
        key = (issue.swc_id, issue.source_location or issue.address, issue.bytecode)
        if key in self.issue_cache:
            return
        from ....analysis.solver import get_transaction_sequence

        try:
            transaction_sequence = get_transaction_sequence(
                global_state,
                list(global_state.world_state.constraints)
                + [Bool(c) for c in conditions_raw])
        except UnsatError:
            return
        except Exception:
            return  # solver timeout
        promoted = copy(issue)
        promoted.transaction_sequence = transaction_sequence
        detector.issues.append(promoted)
        detector.update_cache([promoted])
        self.issue_cache.add(key)
        log.info("summary validation promoted issue %s at %s", issue.swc_id,
                 issue.address)

    # -- replay ----------------------------------------------------------------------

    def _apply_summaries(self, laser_evm, global_state: GlobalState) -> None:
        """At a later transaction's entry, replay every matching recorded
        effect as a fresh open world state, then skip normal execution
        (reference core.py:240)."""
        code = global_state.environment.code.bytecode
        # every summary's recorded issues are checked against the current
        # entry state — including effect-free summaries (a pure SELFDESTRUCT
        # path writes no storage but carries the finding); reference
        # core.py:245 check_for_issues
        for summary in self.summaries:
            if summary.code != code or not summary.issues:
                continue
            mapping = self._build_mapping(summary, global_state)
            for conditions_raw, issue, detector in summary.issues:
                self._check_issue(
                    global_state,
                    [terms.substitute(c, mapping) for c in conditions_raw],
                    issue, detector)

        placeholder_balances = _placeholder_balances().raw
        candidates = [
            s for s in self.summaries
            if s.code == code and not s.revert
            and (s.storage_effect
                 # balance-only effects (pure ether sends) replay too — the
                 # recorded chain differs from the untouched placeholder
                 or s.balance_effect is not placeholder_balances)]
        if not candidates:
            return
        applied = 0
        for summary in candidates:
            applied_result = self._apply_one(summary, global_state)
            if applied_result is not None:
                resulting, _mapping = applied_result
                laser_evm._add_world_state(resulting)
                summary.applications += 1
                applied += 1
        if applied:
            log.debug("replayed %d summaries at pc=0, skipping re-execution",
                      applied)
            raise PluginSkipState

    @staticmethod
    def _build_mapping(summary: SymbolicSummary, global_state: GlobalState
                       ) -> Dict[terms.Term, terms.Term]:
        """Placeholder arrays -> this state's arrays; recording-tx input
        symbols -> the current transaction's."""
        world_state = global_state.world_state
        mapping = _tx_symbol_mapping(
            summary.tx_id, str(global_state.current_transaction.id))
        for address, account in world_state.accounts.items():
            mapping[_placeholder_storage(address).raw] = \
                account.storage._standard_storage.raw
        mapping[_placeholder_balances().raw] = world_state.balances.raw
        return mapping

    def _apply_one(self, summary: SymbolicSummary, global_state: GlobalState
                   ) -> Optional[Tuple[GlobalState, Dict]]:
        new_state = copy(global_state)
        world_state = new_state.world_state

        for address, _effect in summary.storage_effect:
            if address not in world_state.accounts:
                return None
        mapping = self._build_mapping(summary, new_state)

        new_constraints = [terms.substitute(c, mapping)
                           for c in summary.condition]
        for constraint in new_constraints:
            world_state.constraints.append(Bool(constraint))
        try:
            get_model(tuple(world_state.constraints.get_all_constraints()))
        except UnsatError:
            return None
        except Exception:
            return None  # solver timeout: don't replay what we can't justify

        # effects substitute AFTER feasibility so the mapping still sees the
        # pre-effect arrays the condition was recorded against
        for address, effect in summary.storage_effect:
            account = world_state.accounts[address]
            account.storage._standard_storage.raw = terms.substitute(effect,
                                                                     mapping)
        world_state.balances.raw = terms.substitute(summary.balance_effect,
                                                    mapping)
        new_state.annotate(MutationAnnotation())
        world_state.node = new_state.node
        return new_state, mapping


class SummaryPluginBuilder(PluginBuilder):
    name = "symbolic-summaries"

    def __call__(self, *args, **kwargs) -> LaserPlugin:
        return SymbolicSummaryPlugin()
