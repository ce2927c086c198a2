"""LaserEVM: the worklist symbolic executor (API parity:
mythril/laser/ethereum/svm.py — LaserEVM:43, sym_exec:151, execute_transactions:220,
exec:325, execute_state:401, _end_message_call:525, manage_cfg:581, and the
11 lifecycle hook types + per-opcode pre/post hooks).

This is the host/oracle engine: one state at a time, exact semantics. The TPU
engine (parallel/) steps thousands of lanes in lockstep against the same
instruction semantics; `--engine tpu` routes exploration there with this engine as
the semantic referee.

The port's copy of mythril_tpu/core/svm.py. `engine="tpu"` without a
`fleet_gate` hands each message-call transaction to the single-contract
device driver `parallel/frontier.execute_message_call_tpu`, on the device
`frontier.configure` names (the card by default: `sym_exec` raises before
exploring anything when there is none). A `checkpoint_path` saves the
host worklist with support/checkpoint.py at every transaction boundary and
periodically inside one (the device frontier's .npz rides beside it, with
a `.device` suffix); a `resume_path` continues from such a save."""

from __future__ import annotations

import logging
from collections import defaultdict
from copy import copy
from datetime import datetime, timedelta
from typing import Callable, Dict, List, Optional, Tuple, Union

from ..exceptions import UnsatError
from ..observe import trace
from ..smt import Bool, symbol_factory
from ..support.model import get_model
from .instructions import Instruction, transfer_ether
from .node import Edge, JumpType, Node, NodeFlags
from .plugin.signals import PluginSkipState, PluginSkipWorldState
from .state.global_state import GlobalState
from .state.world_state import WorldState
from .strategy.basic import BasicSearchStrategy, DepthFirstSearchStrategy
from .time_handler import time_handler
from .transaction import (ContractCreationTransaction, MessageCallTransaction,
                          TransactionEndSignal, TransactionStartSignal,
                          execute_contract_creation, execute_message_call)
from .transaction.transaction_models import BaseTransaction, tx_id_manager
from .util import VmException
from .state.machine_state import StackUnderflowException
from ..ops.opcodes import OPCODES, STACK

log = logging.getLogger(__name__)

#: _exec_pass sentinel: the budget ended (distinct from "worklist ran dry",
#: which lets exec() refill from the frontier feeder)
_EXEC_TIMED_OUT = object()


class SVMError(Exception):
    pass


class LaserEVM:
    """Worklist symbolic virtual machine."""

    def __init__(self, dynamic_loader=None, max_depth: int = 128,
                 execution_timeout: Optional[int] = 60,
                 create_timeout: Optional[int] = 10,
                 strategy=DepthFirstSearchStrategy,
                 transaction_count: int = 2,
                 requires_statespace: bool = True,
                 iprof=None, use_reachability_check: bool = True,
                 beam_width: Optional[int] = None,
                 tx_strategy: Optional[str] = None,
                 pruning_factor: Optional[float] = None,
                 engine: str = "host",
                 checkpoint_path: Optional[str] = None,
                 resume_path: Optional[str] = None):
        #: "host" = Python worklist; "tpu" = device symbolic frontier
        #: (parallel/frontier.py) with host continuation of escaped lanes
        self.engine = engine
        #: host-phase checkpointing (support/checkpoint.py): periodic
        #: worklist snapshots + tx-boundary saves; device .npz rides beside
        self.checkpoint_path = checkpoint_path
        self.resume_path = resume_path
        #: the device frontier reads its .npz resume point from here — the
        #: host-resume logic consumes self.resume_path before the frontier
        #: ever runs, so it must not share the attribute
        self._device_resume_path = resume_path
        #: the transaction being explored (the coverage of a partial report)
        self._current_tx_index = 0
        #: set when the global analysis deadline fired mid-exploration: the
        #: run drained gracefully (final checkpoint + partial report flagged
        #: `incomplete`) instead of dying mid-transaction
        self.timed_out = False
        #: worklist states abandoned at the deadline (coverage stat)
        self.dropped_states = 0
        self._states_since_checkpoint = 0
        import time as time_module

        # a 0.0 sentinel vs monotonic() would force a full checkpoint pickle
        # on the very first popped state instead of after SAVE_INTERVAL_S
        self._last_checkpoint_time = time_module.monotonic()
        self.dynamic_loader = dynamic_loader
        self.open_states: List[WorldState] = []
        self.total_states = 0

        self.work_list: List[GlobalState] = []
        self.strategy: BasicSearchStrategy = strategy(
            self.work_list, max_depth, beam_width=beam_width)
        self.max_depth = max_depth
        self.transaction_count = transaction_count
        self.executed_transactions = False
        self.tx_strategy = tx_strategy

        self.execution_timeout = execution_timeout or 0
        self.create_timeout = create_timeout or 0
        self.use_reachability_check = use_reachability_check
        self.pruning_factor = pruning_factor

        self.requires_statespace = requires_statespace
        self.nodes: Dict[int, Node] = {}
        self.edges: List[Edge] = []

        self.time: Optional[datetime] = None
        self.executed_nodes = 0

        self.iprof = iprof
        self.instr_pre_hook: Dict[str, List[Callable]] = defaultdict(list)
        self.instr_post_hook: Dict[str, List[Callable]] = defaultdict(list)

        # lifecycle hooks (the 11 hook types of the reference, svm.py:107-145)
        self._add_world_state_hooks: List[Callable] = []
        self._execute_state_hooks: List[Callable] = []
        self._start_exec_hooks: List[Callable] = []
        self._stop_exec_hooks: List[Callable] = []
        self._start_sym_trans_hooks: List[Callable] = []
        self._stop_sym_trans_hooks: List[Callable] = []
        self._start_sym_exec_hooks: List[Callable] = []
        self._stop_sym_exec_hooks: List[Callable] = []
        self._transaction_end_hooks: List[Callable] = []

    # -- strategy wrapping ------------------------------------------------------------
    def extend_strategy(self, extension: type, **kwargs) -> None:
        self.strategy = extension(self.strategy, **kwargs)

    # -- entry points ----------------------------------------------------------------
    def sym_exec(self, world_state: Optional[WorldState] = None,
                 target_address: Optional[int] = None,
                 creation_code: Optional[str] = None,
                 contract_name: Optional[str] = None) -> None:
        """Symbolically execute: either from an existing world state + target, or a
        creation transaction from scratch."""
        pre_configuration_mode = world_state is not None and target_address is not None
        scratch_mode = creation_code is not None and contract_name is not None
        if pre_configuration_mode == scratch_mode:
            raise SVMError("need exactly one of (world_state, target) | creation code")
        if self.engine == "tpu" and getattr(self, "fleet_gate", None) is None:
            # no card, no exploration: never a host or CPU run in its place
            from ..parallel import frontier

            frontier.resolve_device()

        self._start_time = datetime.now()
        for hook in self._start_sym_exec_hooks:
            hook()

        if pre_configuration_mode:
            self.open_states = [world_state]
            log.info("starting message call transaction to %s", hex(target_address))
            self.execute_transactions(symbol_factory.BitVecVal(target_address, 256))
        else:
            log.info("starting contract creation transaction")
            self.time = datetime.now()
            time_handler.start_execution(self.create_timeout or self.execution_timeout)
            with trace.span("svm.create_tx",
                            contract=contract_name or "") as create_span:
                created_account = execute_contract_creation(
                    self, creation_code, contract_name)
                create_span.set(open_states=len(self.open_states))
            log.info("finished contract creation, found %d open states",
                     len(self.open_states))
            if not self.open_states:
                log.warning("no contract was created during the creation transaction")
            self.execute_transactions(created_account.address)

        for hook in self._stop_sym_exec_hooks:
            hook()

    def execute_transactions(self, address) -> None:
        """Drive `transaction_count` message-call transactions (reference svm.py:220).

        With a tx_strategy (RF prioritizer, `--incremental-txs False`), each
        transaction is restricted to the predicted function's selector
        (reference svm.py:241 _execute_transactions_non_ordered)."""
        self.executed_transactions = True
        time_handler.start_execution(self.execution_timeout)
        self.time = datetime.now()
        # explicit user input wins: the reference applies
        # args.transaction_sequences unconditionally in execute_message_call,
        # so a tx_strategy's predictions must not shadow a CLI restriction
        # (ADVICE r4)
        predicted_hashes = self._cli_transaction_sequences()
        if not predicted_hashes:
            predicted_hashes = self._predicted_function_hashes(address)
        start_tx, pending_work_list = 0, None
        if self.resume_path:
            from ..support.checkpoint import (load_host_checkpoint,
                                              restore_into_laser)

            payload = load_host_checkpoint(
                self.resume_path,
                expected_contract_id=getattr(self, "contract_id", None))
            if payload is not None:
                start_tx, pending_work_list = restore_into_laser(payload, self)
            self.resume_path = None  # consume once
        for i in range(start_tx, self.transaction_count):
            self._current_tx_index = i
            if pending_work_list is not None:
                # mid-transaction resume: drain the restored worklist instead
                # of opening a fresh transaction. The tx lifecycle hooks fire
                # so plugins see the same protocol as an uninterrupted run
                # (plugin-internal counters still restart: the dependency
                # pruner may prune differently across a mid-tx resume; see
                # support/checkpoint.py)
                self.work_list.extend(pending_work_list)
                pending_work_list = None
                if self.work_list:
                    log.info("resuming mid-transaction worklist, iteration: "
                             "%d, %d states", i, len(self.work_list))
                    for hook in self._start_sym_trans_hooks:
                        hook()
                    with trace.span("svm.tx", index=i, resumed=True,
                                    states=len(self.work_list)):
                        self.exec()
                    for hook in self._stop_sym_trans_hooks:
                        hook()
                    self._save_checkpoint(tx_index=i + 1)
                    continue
            if len(self.open_states) == 0:
                log.info("no open states left, ending transaction sequence")
                break
            old_states_count = len(self.open_states)
            if self.use_reachability_check:
                self.open_states = [
                    state for state in self.open_states
                    if state.constraints.is_possible()]
                prune_count = old_states_count - len(self.open_states)
                if prune_count:
                    log.info("pruned %d unreachable states", prune_count)
            log.info("starting message call transaction, iteration: %d, "
                     "%d initial states", i, len(self.open_states))
            for hook in self._start_sym_trans_hooks:
                hook()
            hashes = (predicted_hashes[i]
                      if i < len(predicted_hashes) else None)
            with trace.span("svm.tx", index=i, engine=self.engine,
                            states=len(self.open_states)):
                if self.engine == "tpu":
                    gate = getattr(self, "fleet_gate", None)
                    if gate is not None:
                        # fleet member: the driver seeds this contract's
                        # lanes into the shared frontier and runs the
                        # device phase for all packed contracts at once
                        gate(self, address, func_hashes=hashes)
                    else:
                        from ..parallel.frontier import \
                            execute_message_call_tpu

                        execute_message_call_tpu(self, address,
                                                 func_hashes=hashes)
                else:
                    execute_message_call(self, address, func_hashes=hashes)
            for hook in self._stop_sym_trans_hooks:
                hook()
            self._save_checkpoint(tx_index=i + 1)

    def _save_checkpoint(self, tx_index: int, in_flight=None) -> None:
        if not self.checkpoint_path:
            return
        import time as time_module

        from ..support.checkpoint import save_host_checkpoint

        save_host_checkpoint(self.checkpoint_path, self, tx_index,
                             in_flight=in_flight)
        self._last_checkpoint_time = time_module.monotonic()
        self._states_since_checkpoint = 0

    @staticmethod
    def _cli_transaction_sequences() -> List[Optional[List]]:
        """`--transaction-sequences [[hash,...],...]`: per-tx selector
        restriction from the CLI (reference svm.py:233,294-299 — ints become
        4-byte selectors; -1/-2 pass through for fallback/receive)."""
        from ..support.support_args import args

        sequences = getattr(args, "transaction_sequences", None)
        if not sequences:
            return []
        hashes: List[Optional[List]] = []
        for tx_hashes in sequences:
            if tx_hashes is None:
                hashes.append(None)
                continue
            converted = []
            for h in tx_hashes:
                if isinstance(h, bool):
                    # bool is an int subclass: True would silently become
                    # selector b"\x00\x00\x00\x01"
                    raise ValueError(
                        f"--transaction-sequences entry {h!r} is not a "
                        "4-byte selector or -1/-2")
                if h in (-1, -2):
                    converted.append(h)
                elif isinstance(h, int) and 0 <= h < 2 ** 32:
                    converted.append(h.to_bytes(4, "big"))
                else:
                    raise ValueError(
                        f"--transaction-sequences entry {h!r} is not a "
                        "4-byte selector or -1/-2")
            hashes.append(converted)
        return hashes

    def _predicted_function_hashes(self, address) -> List[Optional[List]]:
        """Map the tx_strategy's predicted function indices to 4-byte
        selectors (one singleton list per upcoming transaction)."""
        if self.tx_strategy is None:
            return []
        try:
            sequence = self.tx_strategy.__next__(address)
        except Exception as error:
            log.warning("tx prioritizer failed (%s); falling back to "
                        "unordered exploration", error)
            return []
        if not sequence:
            return []
        log.info("tx prioritizer predicted function sequence: %s", sequence)
        hashes: List[Optional[List]] = []
        for function_index in sequence:
            selector = self._selector_for_function_index(function_index)
            hashes.append([selector] if selector is not None else None)
        return hashes

    def _selector_for_function_index(self, function_index: int):
        """Predicted function index -> 4-byte selector (as bytes, the format
        generate_function_constraints consumes), matched by the recovered
        function name on any open account's dispatcher table."""
        names = getattr(self.tx_strategy, "function_names", [])
        if not (0 <= function_index < len(names)):
            return None
        bare_name = names[function_index]
        for state in self.open_states:
            for account in state.accounts.values():
                table = getattr(account.code, "function_name_to_hash", {})
                for recovered, selector in table.items():
                    if recovered == bare_name or \
                            recovered.startswith(f"{bare_name}("):
                        return bytes.fromhex(selector[2:].rjust(8, "0"))
        return None

    # -- main loop --------------------------------------------------------------------
    def exec(self, create: bool = False, track_gas: bool = False) -> Optional[List[GlobalState]]:
        final_states: List[GlobalState] = []
        while True:
            result = self._exec_pass(create, track_gas, final_states)
            if result is not None:
                return None if result is _EXEC_TIMED_OUT else result
            # refill from the TPU frontier's deferred-row feeder: drained
            # escape rows materialize LAZILY, on demand, within this exec
            # budget — rows never reached are dropped exactly like the
            # host's own mid-worklist states at timeout
            feeder = getattr(self, "frontier_feeder", None)
            if feeder is None or not feeder():
                break
        return final_states if track_gas else None

    def _exec_pass(self, create: bool, track_gas: bool,
                   final_states: List[GlobalState]):
        """One drain of the current worklist; returns a non-None result to
        END exec (timeout), or None when the worklist ran dry."""
        import time as time_module

        from ..support import resilience
        from ..support.checkpoint import (SAVE_INTERVAL_S,
                                          checkpoint_state_interval)

        state_interval = checkpoint_state_interval()
        for global_state in self.strategy:
            if not create:
                # deterministic host-crash injection boundary
                # (`--inject-fault host_crash:N` kills the run at exactly the
                # Nth popped message-call state — the checkpoint/resume
                # equivalent of kill -9)
                resilience.fire("host")
                self._states_since_checkpoint += 1
            if self.checkpoint_path and not create and \
                    (time_module.monotonic() - self._last_checkpoint_time
                     > SAVE_INTERVAL_S
                     or self._states_since_checkpoint >= state_interval):
                # periodic mid-transaction save (time OR state-count
                # cadence); the popped state rides along so a kill between
                # here and execute_state loses nothing
                self._save_checkpoint(self._current_tx_index,
                                      in_flight=global_state)
            if create and self.create_timeout and \
                    self.time + timedelta(seconds=self.create_timeout) <= datetime.now():
                log.debug("hit create timeout, returning")
                return final_states + self.work_list if track_gas \
                    else _EXEC_TIMED_OUT
            if not create and self.execution_timeout and \
                    self.time + timedelta(seconds=self.execution_timeout) <= datetime.now():
                # global deadline: drain gracefully — count the abandoned
                # frontier, checkpoint it (popped state included), and let
                # the analyzer emit a partial report flagged `incomplete`
                self.timed_out = True
                self.dropped_states += len(self.work_list) + 1
                log.warning(
                    "hit execution timeout with %d worklist states pending "
                    "— draining gracefully (checkpoint + partial report)",
                    len(self.work_list) + 1)
                self._save_checkpoint(self._current_tx_index,
                                      in_flight=global_state)
                return final_states + self.work_list if track_gas \
                    else _EXEC_TIMED_OUT

            try:
                new_states, op_code = self.execute_state(global_state)
            except NotImplementedError:
                log.debug("encountered unimplemented instruction")
                continue

            if self.pruning_factor is not None and new_states:
                import random

                if random.random() > self.pruning_factor:
                    # stochastic mid-run feasibility pruning (reference svm.py:351-358)
                    new_states = [
                        state for state in new_states
                        if state.world_state.constraints.is_possible()]

            if self.requires_statespace:
                self.manage_cfg(op_code, new_states)
            self.work_list.extend(new_states)
            if not new_states and track_gas:
                final_states.append(global_state)
            self.total_states += len(new_states)
        return None  # worklist dry: exec() may refill from the feeder

    def execute_state(self, global_state: GlobalState
                      ) -> Tuple[List[GlobalState], Optional[str]]:
        """Execute one instruction on one state (reference svm.py:401)."""
        instructions = global_state.environment.code.instruction_list
        try:
            op_code = instructions[global_state.mstate.pc].op_code
        except IndexError:
            op_code = "STOP"  # running off code end halts (and unwinds call frames)
        global_state.op_code = op_code

        try:
            for hook in self._execute_state_hooks:
                hook(global_state)
        except PluginSkipState:
            # drop the state (reference svm.py:410-414): pruners raise this
            # when the path cannot add new behavior; summaries raise it after
            # replaying the recorded effect as a fresh open state
            return [], None

        # stack preflight (reference svm.py:423-434)
        meta = OPCODES.get(op_code)
        if meta is not None and len(global_state.mstate.stack) < meta[STACK][0]:
            error_state = copy(global_state)
            self._handle_vm_exception(
                error_state, op_code,
                StackUnderflowException(f"{op_code} needs {meta[STACK][0]} stack items"))
            return [], op_code

        try:
            new_global_states = Instruction(
                op_code, self.dynamic_loader,
                pre_hooks=self.instr_pre_hook[op_code],
                post_hooks=self.instr_post_hook[op_code],
            ).evaluate(global_state)

        except PluginSkipState:
            new_global_states = []

        except VmException as error:
            error_state = copy(global_state)
            self._handle_vm_exception(error_state, op_code, error)
            new_global_states = []

        except StackUnderflowException as error:
            error_state = copy(global_state)
            self._handle_vm_exception(error_state, op_code, error)
            new_global_states = []

        except TransactionStartSignal as start_signal:
            # open a nested call frame (reference svm.py:459-473)
            parent_state = start_signal.global_state
            new_global_state = start_signal.transaction.initial_global_state()
            new_global_state.transaction_stack = (
                list(parent_state.transaction_stack)
                + [(start_signal.transaction, parent_state)])
            new_global_state.node = global_state.node
            new_global_state.world_state.transient_storage.checkpoint()
            new_global_state.mstate.depth = parent_state.mstate.depth
            log.debug("starting nested %s transaction", start_signal.op_code)
            return [new_global_state], op_code

        except TransactionEndSignal as end_signal:
            transaction, return_global_state = \
                end_signal.global_state.transaction_stack[-1]

            for hook in self._transaction_end_hooks:
                hook(end_signal.global_state, transaction, return_global_state,
                     end_signal.revert)

            if return_global_state is None:
                # outermost transaction ends
                if (not isinstance(transaction, ContractCreationTransaction)
                        or transaction.return_data) and not end_signal.revert:
                    end_signal.global_state.world_state.node = global_state.node
                    self._add_world_state(end_signal.global_state)
                new_global_states = []
            else:
                # nested call returns to caller frame (reference svm.py:525)
                new_global_states = self._end_message_call(
                    end_signal, transaction, return_global_state)

        self.executed_nodes += 1
        # depth counts JUMPI BRANCHES, not instructions (reference
        # increments only in jumpi_, instructions.py:1640,1665): a
        # per-instruction count made max_depth=128 truncate any
        # straight-line run past 128 instructions — every real solc
        # constructor — silently gutting coverage
        return new_global_states, op_code

    def _end_message_call(self, end_signal: TransactionEndSignal,
                          transaction: BaseTransaction,
                          return_global_state: GlobalState) -> List[GlobalState]:
        return_global_state = copy(return_global_state)
        # adopt the callee world state unless reverted
        if not end_signal.revert:
            return_global_state.world_state = end_signal.global_state.world_state
            return_global_state.environment.active_account = \
                end_signal.global_state.world_state.accounts[
                    return_global_state.environment.active_account.address.raw.value]
            return_global_state.world_state.transient_storage.commit()
        else:
            return_global_state.world_state.transient_storage.rollback()
            transaction.return_data = None

        return_global_state.last_return_data = transaction.return_data

        # rerun the calling instruction's post-handler
        op_code = return_global_state.get_current_instruction()["opcode"]
        try:
            new_global_states = Instruction(
                op_code, self.dynamic_loader).evaluate(return_global_state, post=True)
        except VmException as error:
            self._handle_vm_exception(return_global_state, op_code, error)
            new_global_states = []
        return new_global_states

    def _handle_vm_exception(self, global_state: GlobalState, op_code: str,
                             error) -> None:
        """Path terminates with an exception: revert frame or record world state
        (reference svm.py:382-399)."""
        transaction, return_global_state = global_state.transaction_stack[-1]
        log.debug("%s at pc %d: %s", type(error).__name__,
                  global_state.mstate.pc, error)
        if return_global_state is None:
            # outermost frame: the tx fails, world state not persisted
            return
        # nested frame fails: caller sees retval 0
        try:
            transaction.return_data = None
            end_signal = TransactionEndSignal(global_state, revert=True)
            new_states = self._end_message_call(end_signal, transaction,
                                                return_global_state)
            self.work_list.extend(new_states)
        except Exception:
            log.debug("error unwinding failed call frame", exc_info=True)

    def _add_world_state(self, global_state: GlobalState) -> None:
        """Record a post-transaction open world state (reference svm.py:_add_world_state)."""
        try:
            for hook in self._add_world_state_hooks:
                hook(global_state)
        except PluginSkipWorldState:
            return
        self.open_states.append(global_state.world_state)

    # -- CFG --------------------------------------------------------------------------
    def new_node_for_transaction(self, global_state: GlobalState,
                                 transaction: BaseTransaction) -> None:
        new_node = Node(global_state.environment.active_account.contract_name)
        self.nodes[new_node.uid] = new_node
        if getattr(transaction.world_state, "node", None):
            self.edges.append(Edge(transaction.world_state.node.uid, new_node.uid,
                                   edge_type=JumpType.Transaction, condition=None))
        global_state.node = new_node
        new_node.states.append(global_state)

    def manage_cfg(self, opcode: Optional[str], new_states: List[GlobalState]) -> None:
        """Maintain nodes/edges (reference svm.py:581)."""
        if opcode is None:
            return
        if opcode == "JUMP":
            for state in new_states:
                self._new_node_state(state, JumpType.UNCONDITIONAL)
        elif opcode == "JUMPI":
            for state in new_states:
                condition = state.world_state.constraints[-1] \
                    if state.world_state.constraints else None
                self._new_node_state(state, JumpType.CONDITIONAL, condition)
        elif opcode in ("CALL", "CALLCODE", "DELEGATECALL", "STATICCALL",
                        "CREATE", "CREATE2"):
            for state in new_states:
                self._new_node_state(state, JumpType.CALL)
        elif opcode in ("RETURN", "STOP", "REVERT"):
            for state in new_states:
                self._new_node_state(state, JumpType.RETURN)
        for state in new_states:
            if state.node:
                state.node.states.append(state)

    def _new_node_state(self, state: GlobalState,
                        edge_type: JumpType = JumpType.UNCONDITIONAL,
                        condition=None) -> None:
        try:
            address = state.environment.code.instruction_list[state.mstate.pc].address
        except IndexError:
            return
        new_node = Node(state.environment.active_account.contract_name,
                        start_addr=address)
        old_node = state.node
        state.node = new_node
        new_node.constraints = list(state.world_state.constraints)
        self.nodes[new_node.uid] = new_node
        if old_node:
            self.edges.append(Edge(old_node.uid, new_node.uid, edge_type, condition))

        if edge_type == JumpType.RETURN:
            new_node.flags.append(NodeFlags.CALL_RETURN)

        environment = state.environment
        disassembly = environment.code
        if address in disassembly.address_to_function_name:
            new_node.flags.append(NodeFlags.FUNC_ENTRY)
            environment.active_function_name = \
                disassembly.address_to_function_name[address]
        new_node.function_name = getattr(environment, "active_function_name",
                                         "unknown")

    # -- hook registration (parity with svm.py:669-741) --------------------------------
    def register_hooks(self, hook_type: str,
                       hook_dict: Dict[str, List[Callable]]) -> None:
        registry = self.instr_pre_hook if hook_type == "pre" else self.instr_post_hook
        for op_code, funcs in hook_dict.items():
            registry[op_code].extend(funcs)

    def register_laser_hooks(self, hook_type: str, hook: Callable) -> None:
        mapping = {
            "add_world_state": self._add_world_state_hooks,
            "execute_state": self._execute_state_hooks,
            "start_exec": self._start_exec_hooks,
            "stop_exec": self._stop_exec_hooks,
            "start_sym_exec": self._start_sym_exec_hooks,
            "stop_sym_exec": self._stop_sym_exec_hooks,
            "start_sym_trans": self._start_sym_trans_hooks,
            "stop_sym_trans": self._stop_sym_trans_hooks,
            "transaction_end": self._transaction_end_hooks,
        }
        if hook_type not in mapping:
            raise ValueError(f"invalid hook type {hook_type}")
        mapping[hook_type].append(hook)

    def register_instr_hooks(self, hook_type: str, op_code: str, hook: Callable) -> None:
        registry = self.instr_pre_hook if hook_type == "pre" else self.instr_post_hook
        if not op_code:
            for op in OPCODES:
                registry[op].append(hook)
        else:
            registry[op_code].append(hook)

    def instr_hook(self, hook_type: str, op_code: str) -> Callable:
        def hook_decorator(function: Callable) -> Callable:
            self.register_instr_hooks(hook_type, op_code, function)
            return function

        return hook_decorator

    def laser_hook(self, hook_type: str) -> Callable:
        def hook_decorator(function: Callable) -> Callable:
            self.register_laser_hooks(hook_type, function)
            return function

        return hook_decorator

    def hook(self, op_code: str) -> Callable:
        return self.instr_hook("pre", op_code)
