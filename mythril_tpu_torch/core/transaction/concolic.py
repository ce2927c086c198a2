"""Concrete-valued transaction execution (API parity:
mythril/laser/ethereum/transaction/concolic.py — execute_message_call:23,
execute_transaction:74). Used by the VMTests conformance harness and the concolic
subsystem; the same concrete lanes ride the TPU lockstep interpreter.

The port's copy of mythril_tpu/core/transaction/concolic.py."""

from __future__ import annotations

import logging
from datetime import datetime
from typing import List, Optional

from ...smt import symbol_factory
from ..state.calldata import ConcreteCalldata
from ..state.world_state import WorldState
from .transaction_models import MessageCallTransaction, get_next_transaction_id

log = logging.getLogger(__name__)


def execute_message_call(laser_evm, callee_address, caller_address, value,
                         data: List[int], gas_limit: int, gas_price: int,
                         origin_address=None, code=None,
                         block_number: Optional[int] = None,
                         track_gas: bool = False) -> Optional[List]:
    """Execute one concrete message call tx against the current open state."""
    open_states = laser_evm.open_states[:]
    del laser_evm.open_states[:]
    if origin_address is None:
        origin_address = caller_address

    final_states = []
    for open_world_state in open_states:
        next_transaction_id = get_next_transaction_id()
        callee_account = open_world_state.accounts_exist_or_load(
            callee_address if isinstance(callee_address, int)
            else callee_address.value, laser_evm.dynamic_loader)
        transaction = MessageCallTransaction(
            world_state=open_world_state,
            identifier=next_transaction_id,
            gas_price=symbol_factory.BitVecVal(gas_price, 256),
            gas_limit=gas_limit,
            origin=symbol_factory.BitVecVal(
                origin_address if isinstance(origin_address, int)
                else origin_address.value, 256),
            code=code or callee_account.code,
            caller=symbol_factory.BitVecVal(
                caller_address if isinstance(caller_address, int)
                else caller_address.value, 256),
            callee_account=callee_account,
            call_data=ConcreteCalldata(next_transaction_id, data),
            call_value=symbol_factory.BitVecVal(
                value if isinstance(value, int) else value.value, 256),
        )
        _setup_global_state_for_execution(laser_evm, transaction)
        if block_number is not None:
            # concrete block context (VMTests env / concolic replay)
            laser_evm.work_list[-1].environment.block_number = \
                symbol_factory.BitVecVal(block_number, 256)
        laser_evm.time = datetime.now()
        result = laser_evm.exec(track_gas=track_gas)
        if result:
            final_states.extend(result)
    return final_states if track_gas else None


def _setup_global_state_for_execution(laser_evm, transaction) -> None:
    global_state = transaction.initial_global_state()
    global_state.transaction_stack.append((transaction, None))
    if getattr(laser_evm, "requires_statespace", False):
        laser_evm.new_node_for_transaction(global_state, transaction)
    laser_evm.work_list.append(global_state)

def execute_contract_creation(laser_evm, callee_address, caller_address,
                              value, data: List[int], gas_limit: int,
                              gas_price: int, code: str = "",
                              origin_address=None,
                              contract_name: str = "Unknown") -> None:
    """Execute one concrete creation tx from every open state
    (reference transaction/concolic.py:74 execute_transaction creation arm)."""
    from ...frontends.disassembler import Disassembly
    from .transaction_models import ContractCreationTransaction

    open_states = laser_evm.open_states[:]
    del laser_evm.open_states[:]
    if origin_address is None:
        origin_address = caller_address
    for open_world_state in open_states:
        next_transaction_id = get_next_transaction_id()
        transaction = ContractCreationTransaction(
            world_state=open_world_state,
            identifier=next_transaction_id,
            gas_price=symbol_factory.BitVecVal(gas_price, 256),
            gas_limit=gas_limit,
            origin=symbol_factory.BitVecVal(origin_address, 256),
            code=Disassembly(code),
            caller=symbol_factory.BitVecVal(caller_address, 256),
            contract_name=contract_name,
            call_data=ConcreteCalldata(next_transaction_id, data),
            call_value=symbol_factory.BitVecVal(value, 256),
        )
        _setup_global_state_for_execution(laser_evm, transaction)
        laser_evm.time = datetime.now()
        laser_evm.exec(True)
