"""Symbolic transaction drivers (API parity:
mythril/laser/ethereum/transaction/symbolic.py — Actors:29 fixed CREATOR/ATTACKER/
SOMEGUY addresses, generate_function_constraints:77 4-byte selector fixing,
execute_message_call:106, execute_contract_creation:154,
_setup_global_state_for_execution:202 with the caller-in-ACTORS constraint).

The port's copy of mythril_tpu/core/transaction/symbolic.py."""

from __future__ import annotations

import logging
from typing import List, Optional

from ...smt import BitVec, Bool, Or, symbol_factory
from ..state.calldata import SymbolicCalldata
from ..state.world_state import WorldState
from .transaction_models import (ContractCreationTransaction,
                                 MessageCallTransaction, get_next_transaction_id)

log = logging.getLogger(__name__)

CREATOR_ADDRESS = 0xAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFE
ATTACKER_ADDRESS = 0xDEADBEEFDEADBEEFDEADBEEFDEADBEEFDEADBEEF
SOMEGUY_ADDRESS = 0xAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA


class Actors:
    """The fixed actor model: every symbolic tx sender is constrained to one of
    these three addresses (reference symbolic.py:29-53)."""

    def __init__(self, creator=CREATOR_ADDRESS, attacker=ATTACKER_ADDRESS,
                 someguy=SOMEGUY_ADDRESS):
        self.addresses = {
            "CREATOR": symbol_factory.BitVecVal(creator, 256),
            "ATTACKER": symbol_factory.BitVecVal(attacker, 256),
            "SOMEGUY": symbol_factory.BitVecVal(someguy, 256),
        }

    def __setitem__(self, actor: str, address: str):
        self.addresses[actor] = symbol_factory.BitVecVal(int(address, 16), 256)

    @property
    def creator(self) -> BitVec:
        return self.addresses["CREATOR"]

    @property
    def attacker(self) -> BitVec:
        return self.addresses["ATTACKER"]

    @property
    def someguy(self) -> BitVec:
        return self.addresses["SOMEGUY"]

    def __getitem__(self, actor: str) -> BitVec:
        return self.addresses[actor]


ACTORS = Actors()


def generate_function_constraints(calldata: SymbolicCalldata,
                                  func_hashes: List[List[int]]) -> List[Bool]:
    """Fix the 4-byte selector of a tx to one of the given hashes
    (used by --transaction-sequences and the tx prioritizer)."""
    if not func_hashes:
        return []
    constraints = []
    options = []
    for func_hash in func_hashes:
        if func_hash == -1:  # fallback function: short calldata
            from ...smt import ULT

            options.append(ULT(calldata.calldatasize, 4))
        elif func_hash == -2:  # receive function: empty calldata
            options.append(calldata.calldatasize == 0)
        else:
            word = [calldata[i] == func_hash[i] for i in range(4)]
            from ...smt import And

            options.append(And(*word))
    constraints.append(Or(*options))
    return constraints


def execute_message_call(laser_evm, callee_address: BitVec,
                         func_hashes: Optional[List] = None) -> None:
    """Drive one symbolic message-call tx from every currently-open world state."""
    open_states = laser_evm.open_states[:]
    del laser_evm.open_states[:]
    for open_world_state in open_states:
        if open_world_state[callee_address].deleted:
            log.debug("skipping dead contract")
            continue
        next_transaction_id = get_next_transaction_id()
        external_sender = symbol_factory.BitVecSym(
            f"sender_{next_transaction_id}", 256)
        calldata = SymbolicCalldata(next_transaction_id)
        transaction = MessageCallTransaction(
            world_state=open_world_state,
            identifier=next_transaction_id,
            gas_price=symbol_factory.BitVecSym(f"gas_price{next_transaction_id}", 256),
            gas_limit=8000000,
            origin=external_sender,
            caller=external_sender,
            callee_account=open_world_state[callee_address],
            call_data=calldata,
            call_value=symbol_factory.BitVecSym(f"call_value{next_transaction_id}", 256),
        )
        constraints = (generate_function_constraints(calldata, func_hashes)
                       if func_hashes else None)
        _setup_global_state_for_execution(laser_evm, transaction, constraints)
    laser_evm.exec()


def execute_contract_creation(laser_evm, contract_initialization_code: str,
                              contract_name: Optional[str] = None,
                              world_state: Optional[WorldState] = None) -> "Account":
    """Drive the creation transaction; returns the new account."""
    from ...frontends.disassembler import Disassembly

    world_state = world_state or WorldState()
    open_states = [world_state]
    del laser_evm.open_states[:]
    new_account = None
    for open_world_state in open_states:
        next_transaction_id = get_next_transaction_id()
        transaction = ContractCreationTransaction(
            world_state=open_world_state,
            identifier=next_transaction_id,
            gas_price=symbol_factory.BitVecSym(f"gas_price{next_transaction_id}", 256),
            gas_limit=8000000,
            origin=ACTORS.creator,
            code=Disassembly(contract_initialization_code),
            caller=ACTORS.creator,
            contract_name=contract_name,
            # symbolic, not []: constructor ARGUMENTS live past the end of
            # the creation code and read through codesize/codecopy
            # (reference transaction_models.py:233 models them exactly so)
            call_data=SymbolicCalldata(next_transaction_id),
            call_value=symbol_factory.BitVecSym(f"call_value{next_transaction_id}", 256),
        )
        _setup_global_state_for_execution(laser_evm, transaction)
        new_account = new_account or transaction.callee_account
    laser_evm.exec(True)
    return new_account


def _setup_global_state_for_execution(laser_evm, transaction,
                                      initial_constraints: Optional[List[Bool]] = None) -> None:
    """Build the initial GlobalState, add the actor constraint, push to worklist."""
    global_state = transaction.initial_global_state()
    global_state.transaction_stack.append((transaction, None))
    global_state.world_state.constraints += initial_constraints or []

    global_state.world_state.constraints.append(
        Or(*[transaction.caller == actor
             for actor in ACTORS.addresses.values()]))

    # notify lifecycle hooks (plugin bus)
    for hook in laser_evm._start_sym_trans_hooks:
        hook()
    if getattr(laser_evm, "requires_statespace", False):
        laser_evm.new_node_for_transaction(global_state, transaction)
    laser_evm.work_list.append(global_state)
