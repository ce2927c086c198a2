"""State merging: collapse similar post-transaction world states
(capability parity: mythril/laser/plugin/plugins/state_merge/
state_merge_plugin.py:34, check_mergeability.py:13-106, merge_states.py).

The CPU fan-out killer: after each transaction the open-state list often holds
many world states that differ only in a few path constraints and storage
writes. Two such states collapse into one whose storage is
`If(c1, storage1, storage2)` and whose constraints are the shared prefix plus
`Or(And(unique1), And(unique2))` — halving downstream exploration per merge.
(On the TPU lockstep engine the same role is played by lane compaction; this
plugin serves the host engine, and its mergeability predicate is the future
lane-dedup predicate.)

Enabled by `--enable-state-merging`.

The port's copy of mythril_tpu/core/plugin/plugins/state_merge.py."""

from __future__ import annotations

import logging
from typing import List, Optional, Set, Tuple

from ....smt import And, Bool, If, Or, symbol_factory
from ...state.annotation import MergeableStateAnnotation, StateAnnotation
from ...state.world_state import WorldState
from ..builder import PluginBuilder
from ..interface import LaserPlugin

log = logging.getLogger(__name__)

#: states differing in more than this many constraints are too different to
#: merge profitably (reference check_mergeability.py:8)
CONSTRAINT_DIFFERENCE_LIMIT = 15


class MergeAnnotation(StateAnnotation):
    """Marks a world state as already merged once (merging a state at most
    once bounds expression growth, reference state_merge_plugin.py:41)."""

    @property
    def persist_to_world_state(self) -> bool:
        return True


# -- mergeability ---------------------------------------------------------------------


def _constraints_diff(state_a: WorldState, state_b: WorldState
                      ) -> Optional[Tuple[List[Bool], List[Bool], List[Bool]]]:
    """(common, unique_a, unique_b) or None when the difference is too large.
    Terms are hash-consed, so raw identity is structural equality."""
    raws_a = {c.raw for c in state_a.constraints}
    raws_b = {c.raw for c in state_b.constraints}
    common = [c for c in state_a.constraints if c.raw in raws_b]
    unique_a = [c for c in state_a.constraints if c.raw not in raws_b]
    unique_b = [c for c in state_b.constraints if c.raw not in raws_a]
    if len(unique_a) + len(unique_b) > CONSTRAINT_DIFFERENCE_LIMIT:
        return None
    return common, unique_a, unique_b


def _check_account_merge(account_a, account_b) -> bool:
    return (account_a.nonce == account_b.nonce
            and account_a.deleted == account_b.deleted
            and account_a.code.bytecode == account_b.code.bytecode)


def _check_annotations(state_a: WorldState, state_b: WorldState) -> bool:
    annotations_a = state_a.annotations
    annotations_b = state_b.annotations
    if len(annotations_a) != len(annotations_b):
        return False
    for one, two in zip(annotations_a, annotations_b):
        if type(one) is not type(two):
            return False
        if isinstance(one, MergeableStateAnnotation):
            if not one.check_merge_annotation(two):
                return False
        elif one.__dict__ != two.__dict__:
            return False
    return True


def check_ws_merge_condition(state_a: WorldState, state_b: WorldState) -> bool:
    """Mergeable iff: same node (function/contract/address), account metadata
    equal, annotations compatible, constraint diff within the limit
    (reference check_mergeability.py:41-58)."""
    node_a, node_b = state_a.node, state_b.node
    if node_a and node_b:
        if (node_a.function_name != node_b.function_name
                or node_a.contract_name != node_b.contract_name
                or node_a.start_addr != node_b.start_addr):
            return False
    if set(state_a.accounts.keys()) != set(state_b.accounts.keys()):
        return False
    for address, account in state_b.accounts.items():
        if not _check_account_merge(state_a.accounts[address], account):
            return False
    if not _check_annotations(state_a, state_b):
        return False
    return _constraints_diff(state_a, state_b) is not None


# -- merging --------------------------------------------------------------------------


def merge_states(state_a: WorldState, state_b: WorldState) -> None:
    """Merge state_b into state_a in place (reference merge_states.py:13-45)."""
    diff = _constraints_diff(state_a, state_b)
    assert diff is not None, "merge_states called on unmergeable states"
    common, unique_a, unique_b = diff
    condition_a = And(*unique_a) if unique_a \
        else symbol_factory.BoolVal(True)
    condition_b = And(*unique_b) if unique_b \
        else symbol_factory.BoolVal(True)

    from ...state.constraints import Constraints

    merged = Constraints(common)
    merged.append(Or(condition_a, condition_b))
    state_a.constraints = merged

    # balances: If(c_a, balances_a, balances_b)
    state_a.balances = If(condition_a, state_a.balances, state_b.balances)
    state_a.starting_balances = If(condition_a, state_a.starting_balances,
                                   state_b.starting_balances)

    for address, account_b in state_b.accounts.items():
        account_a = state_a.accounts[address]
        account_a._balances = state_a.balances
        _merge_storage(account_a.storage, account_b.storage, condition_a)

    for one, two in zip(state_a.annotations, state_b.annotations):
        if isinstance(one, MergeableStateAnnotation):
            one.merge_annotation(two)

    state_a.annotate(MergeAnnotation())


def _merge_storage(storage_a, storage_b, condition_a: Bool) -> None:
    storage_a._standard_storage = If(condition_a, storage_a._standard_storage,
                                     storage_b._standard_storage)
    storage_a.storage_keys_loaded |= storage_b.storage_keys_loaded
    storage_a.keys_set |= storage_b.keys_set
    storage_a.keys_get |= storage_b.keys_get
    for key, value in storage_b.printable_storage.items():
        if key in storage_a.printable_storage:
            storage_a.printable_storage[key] = If(
                condition_a, storage_a.printable_storage[key], value)
        else:
            storage_a.printable_storage[key] = If(condition_a, 0, value)
    for key in list(storage_a.printable_storage):
        if key not in storage_b.printable_storage:
            # a-only keys are conditional too: on b's path they were never set
            storage_a.printable_storage[key] = If(
                condition_a, storage_a.printable_storage[key], 0)


# -- plugin ---------------------------------------------------------------------------


class StateMergePlugin(LaserPlugin):
    """Runs after every symbolic transaction; repeatedly sweeps the open-state
    list merging the first mergeable pair until a fixpoint."""

    def initialize(self, symbolic_vm) -> None:
        @symbolic_vm.laser_hook("stop_sym_trans")
        def merge_open_states_hook():
            open_states = symbolic_vm.open_states
            if len(open_states) <= 1:
                return
            before = len(open_states)
            result: List[WorldState] = list(open_states)
            changed = True
            while changed:
                changed = False
                merged_away: Set[int] = set()
                kept: List[WorldState] = []
                for i, state in enumerate(result):
                    if i in merged_away:
                        continue
                    if list(state.get_annotations(MergeAnnotation)):
                        kept.append(state)
                        continue
                    for j in range(i + 1, len(result)):
                        if j in merged_away:
                            continue
                        other = result[j]
                        if list(other.get_annotations(MergeAnnotation)):
                            continue
                        if check_ws_merge_condition(state, other):
                            merge_states(state, other)
                            merged_away.add(j)
                            changed = True
                            break
                    kept.append(state)
                result = kept
            if len(result) != before:
                log.info("state merge: %d open states -> %d", before,
                         len(result))
            symbolic_vm.open_states = result


class StateMergePluginBuilder(PluginBuilder):
    name = "state-merge"

    def __call__(self, *args, **kwargs) -> LaserPlugin:
        return StateMergePlugin()
