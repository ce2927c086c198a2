"""Mutation pruner (capability parity:
mythril/laser/plugin/plugins/mutation_pruner.py:22).

Annotates paths that mutate state (SSTORE/CALL/CREATE); read-only transactions
cannot enable new behavior in later transactions, so their post-tx world states are
dropped (unless value was payable into the contract).

The port's copy of mythril_tpu/core/plugin/plugins/mutation_pruner.py."""

from __future__ import annotations

from ....smt import UGT, symbol_factory
from ....exceptions import UnsatError
from ....support.model import get_model
from ...state.annotation import StateAnnotation
from ...state.global_state import GlobalState
from ..builder import PluginBuilder
from ..interface import LaserPlugin
from ..signals import PluginSkipWorldState


class MutationAnnotation(StateAnnotation):
    """Path has mutated the world state."""

    @property
    def persist_over_calls(self) -> bool:
        return True


class MutationPruner(LaserPlugin):
    def initialize(self, symbolic_vm) -> None:
        @symbolic_vm.instr_hook("pre", "SSTORE")
        def sstore_mutator_hook(global_state: GlobalState):
            global_state.annotate(MutationAnnotation())

        @symbolic_vm.instr_hook("pre", "TSTORE")
        def tstore_mutator_hook(global_state: GlobalState):
            global_state.annotate(MutationAnnotation())

        @symbolic_vm.instr_hook("pre", "CALL")
        def call_mutator_hook(global_state: GlobalState):
            global_state.annotate(MutationAnnotation())

        @symbolic_vm.instr_hook("pre", "STATICCALL")
        def staticcall_mutator_hook(global_state: GlobalState):
            global_state.annotate(MutationAnnotation())

        @symbolic_vm.laser_hook("add_world_state")
        def world_state_filter_hook(global_state: GlobalState):
            if list(global_state.get_annotations(MutationAnnotation)):
                return
            from ...transaction.transaction_models import ContractCreationTransaction

            if isinstance(global_state.current_transaction,
                          ContractCreationTransaction):
                return
            # payable tx with nonzero value still matters for balances
            try:
                get_model(tuple(
                    global_state.world_state.constraints.get_all_constraints()
                    + [UGT(global_state.current_transaction.call_value,
                           symbol_factory.BitVecVal(0, 256))]))
                return  # value can flow in: keep the state
            except UnsatError:
                raise PluginSkipWorldState


class MutationPrunerBuilder(PluginBuilder):
    name = "mutation-pruner"

    def __call__(self, *args, **kwargs) -> LaserPlugin:
        return MutationPruner()
