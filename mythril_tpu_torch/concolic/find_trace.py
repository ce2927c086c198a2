"""Concrete replay + trace recording (capability parity:
mythril/concolic/find_trace.py:45 — setup_concrete_initial_state:24,
concrete_execution with the TraceFinder plugin).

The port's copy of mythril_tpu/concolic/find_trace.py. The replay runs on
the host engine: neither package's concolic driver calls the batched
interpreter (parallel/lockstep.py), whatever `--engine` says."""

from __future__ import annotations

from copy import deepcopy
from typing import List, Tuple

from ..core.plugin.loader import LaserPluginLoader
from ..core.plugin.plugins.trace import TraceFinderBuilder
from ..core.state.world_state import WorldState
from ..core.svm import LaserEVM
from ..core.transaction.concolic import (execute_contract_creation,
                                         execute_message_call)
from ..frontends.disassembler import Disassembly
from ..smt import symbol_factory
from .concrete_data import ConcreteData, validate_concrete_data


def setup_concrete_initial_state(concrete_data: ConcreteData) -> WorldState:
    """initialState.accounts -> WorldState (reference find_trace.py:24)."""
    world_state = WorldState()
    for address_hex, details in concrete_data["initialState"]["accounts"].items():
        account = world_state.create_account(
            balance=int(details.get("balance", "0x0"), 16),
            address=int(address_hex, 16),
            concrete_storage=True,
            nonce=details.get("nonce", 0))
        code = details.get("code", "")
        account.code = Disassembly(code[2:] if code.startswith("0x") else code)
        for slot_hex, value_hex in details.get("storage", {}).items():
            account.storage[symbol_factory.BitVecVal(int(slot_hex, 16), 256)] = \
                symbol_factory.BitVecVal(int(value_hex, 16), 256)
    return world_state


def concrete_execution(concrete_data: ConcreteData
                       ) -> Tuple[WorldState, List[List[Tuple[int, str]]]]:
    """Replay all steps concretely; returns (initial world state, trace).
    trace is a list per transaction of (pc_address, tx_id) pairs."""
    validate_concrete_data(concrete_data)
    init_state = setup_concrete_initial_state(concrete_data)
    laser_evm = LaserEVM(execution_timeout=1000, requires_statespace=False)
    laser_evm.open_states = [deepcopy(init_state)]

    plugin_loader = LaserPluginLoader()
    plugin_loader.reset()
    trace_plugin_builder = TraceFinderBuilder()
    plugin = trace_plugin_builder()
    plugin.initialize(laser_evm)

    for transaction in concrete_data["steps"]:
        input_hex = transaction["input"]
        data = bytes.fromhex(input_hex[2:] if input_hex.startswith("0x")
                             else input_hex)
        target = transaction.get("address", "")
        caller = int(transaction.get("origin", "0x" + "a" * 40), 16)
        value = int(transaction.get("value", "0x0"), 16)
        gas_limit = int(transaction.get("gasLimit", hex(8_000_000)), 16)
        gas_price = int(transaction.get("gasPrice", "0x0"), 16)
        if target in ("", None):
            execute_contract_creation(
                laser_evm, callee_address="",
                caller_address=caller, origin_address=caller,
                code=input_hex[2:] if input_hex.startswith("0x") else input_hex,
                data=list(data), gas_limit=gas_limit, gas_price=gas_price,
                value=value)
        else:
            execute_message_call(
                laser_evm, callee_address=int(target, 16),
                caller_address=caller, origin_address=caller,
                data=list(data), gas_limit=gas_limit, gas_price=gas_price,
                value=value)
    return init_state, plugin.tx_trace
