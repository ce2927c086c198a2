"""Dependency pruner (capability parity:
mythril/laser/plugin/plugins/dependency_pruner.py:79).

Builds per-basic-block storage read/write maps across transactions; in transaction
n, skips blocks whose reads cannot alias any location written in transaction n-1
(aliasing decided by solver queries).

The port's copy of mythril_tpu/core/plugin/plugins/dependency_pruner.py."""

from __future__ import annotations

import logging
from typing import Dict, List, Set

from ....exceptions import UnsatError
from ....smt.solver import cfa_screen
from ....support.model import get_model
from ...state.annotation import StateAnnotation
from ...state.global_state import GlobalState
from ..builder import PluginBuilder
from ..interface import LaserPlugin
from ..signals import PluginSkipState

log = logging.getLogger(__name__)


class DependencyAnnotation(StateAnnotation):
    """Per-path record of storage locations read/written and blocks visited."""

    def __init__(self):
        self.storage_loaded: List = []
        self.storage_written: Dict[int, List] = {}
        self.has_call: bool = False
        self.path: List[int] = [0]
        self.blocks_seen: Set[int] = set()

    def __copy__(self):
        result = DependencyAnnotation()
        result.storage_loaded = list(self.storage_loaded)
        result.storage_written = {k: list(v) for k, v in self.storage_written.items()}
        result.has_call = self.has_call
        result.path = list(self.path)
        result.blocks_seen = set(self.blocks_seen)
        return result

    @property
    def persist_to_world_state(self) -> bool:
        return True

    def get_storage_write_cache(self, iteration: int) -> List:
        return self.storage_written.get(iteration, [])

    def extend_storage_write_cache(self, iteration: int, value) -> None:
        entries = self.storage_written.setdefault(iteration, [])
        if value not in entries:
            entries.append(value)


class WSDependencyAnnotation(StateAnnotation):
    """World-state-level container carrying the path annotation across txs."""

    def __init__(self):
        self.annotations_stack: List[DependencyAnnotation] = []

    def __copy__(self):
        result = WSDependencyAnnotation()
        result.annotations_stack = [a.__copy__() for a in self.annotations_stack]
        return result


def get_dependency_annotation(state: GlobalState) -> DependencyAnnotation:
    annotations = list(state.get_annotations(DependencyAnnotation))
    if annotations:
        return annotations[0]
    ws_annotations = list(state.world_state.get_annotations(WSDependencyAnnotation))
    if ws_annotations and ws_annotations[0].annotations_stack:
        annotation = ws_annotations[0].annotations_stack[-1].__copy__()
    else:
        annotation = DependencyAnnotation()
    state.annotate(annotation)
    return annotation


class DependencyPruner(LaserPlugin):
    def __init__(self):
        self.iteration = 0
        #: address -> set of storage locations written in earlier iterations
        self.sloads_on_path: Dict[int, List] = {}
        self.sstores_on_path: Dict[int, List] = {}

    def initialize(self, symbolic_vm) -> None:
        self.iteration = 0

        @symbolic_vm.laser_hook("start_sym_trans")
        def start_sym_trans_hook():
            self.iteration += 1

        @symbolic_vm.instr_hook("pre", "SLOAD")
        def sload_hook(global_state: GlobalState):
            annotation = get_dependency_annotation(global_state)
            location = global_state.mstate.stack[-1]
            if location not in annotation.storage_loaded:
                annotation.storage_loaded.append(location)

        @symbolic_vm.instr_hook("pre", "SSTORE")
        def sstore_hook(global_state: GlobalState):
            annotation = get_dependency_annotation(global_state)
            annotation.extend_storage_write_cache(
                self.iteration, global_state.mstate.stack[-1])

        @symbolic_vm.instr_hook("pre", "CALL")
        def call_hook(global_state: GlobalState):
            annotation = get_dependency_annotation(global_state)
            annotation.has_call = True

        @symbolic_vm.instr_hook("pre", "JUMPDEST")
        def jumpdest_hook(global_state: GlobalState):
            if self.iteration < 2:
                return
            annotation = get_dependency_annotation(global_state)
            address = global_state.get_current_instruction()["address"]
            # key block bookkeeping by the CFA block (its start pc) rather
            # than re-deriving basic blocks from raw JUMPDEST addresses;
            # block_key falls back to the raw address when the cfa is off,
            # and a JUMPDEST is its own block leader either way
            block = cfa_screen.block_key(global_state.environment.code, address)
            if block in annotation.blocks_seen:
                return
            annotation.blocks_seen.add(block)
            annotation.path.append(block)

        @symbolic_vm.laser_hook("add_world_state")
        def world_state_hook(global_state: GlobalState):
            annotation = get_dependency_annotation(global_state)
            ws_annotations = list(global_state.world_state.get_annotations(
                WSDependencyAnnotation))
            if not ws_annotations:
                ws_annotation = WSDependencyAnnotation()
                global_state.world_state.annotate(ws_annotation)
            else:
                ws_annotation = ws_annotations[0]
            ws_annotation.annotations_stack.append(annotation)

        @symbolic_vm.laser_hook("execute_state")
        def execute_state_hook(global_state: GlobalState):
            if self.iteration < 2:
                return
            opcode = global_state.get_current_instruction()["opcode"]
            if opcode != "JUMPDEST":
                return
            annotation = get_dependency_annotation(global_state)
            if annotation.has_call:
                return
            writes: List = []
            ws_annotations = list(global_state.world_state.get_annotations(
                WSDependencyAnnotation))
            for ws_annotation in ws_annotations:
                for dep in ws_annotation.annotations_stack:
                    for iteration, entries in dep.storage_written.items():
                        if iteration < self.iteration:
                            writes.extend(entries)
            if not writes:
                return
            reads = annotation.storage_loaded
            if not reads:
                return
            if not self._may_alias(global_state, reads, writes):
                log.debug("dependency pruner skipping block at iteration %d",
                          self.iteration)
                raise PluginSkipState

    @staticmethod
    def _may_alias(global_state: GlobalState, reads: List, writes: List) -> bool:
        from ....smt import Or

        options = []
        for read in reads:
            for write in writes:
                equality = read == write
                if equality.is_true:
                    return True
                if not equality.is_false:
                    options.append(equality)
        if not options:
            return False
        try:
            get_model(tuple(
                global_state.world_state.constraints.get_all_constraints()
                + [Or(*options)]))
            return True
        except UnsatError:
            return False


class DependencyPrunerBuilder(PluginBuilder):
    name = "dependency-pruner"

    def __call__(self, *args, **kwargs) -> LaserPlugin:
        return DependencyPruner()
