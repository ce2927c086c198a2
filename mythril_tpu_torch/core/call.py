"""CALL-family parameter extraction and callee resolution (API parity:
mythril/laser/ethereum/call.py — get_call_parameters:36, get_callee_address:86,
get_callee_account:130, get_call_data:153, native_call:199).

The port's copy of mythril_tpu/core/call.py."""

from __future__ import annotations

import logging
import re
from typing import List, Optional, Tuple, Union

from ..smt import BitVec, simplify, symbol_factory
from ..support.support_args import args as global_args
from .natives import NativeContractException, native_contracts
from .state.account import Account
from .state.calldata import BaseCalldata, ConcreteCalldata, SymbolicCalldata
from .state.global_state import GlobalState

log = logging.getLogger(__name__)

PRECOMPILE_ADDRESSES = set(range(1, 11))
#: hevm/forge cheat-code VM address (modeled as a no-op unless cheat codes enabled)
CHEAT_CODE_ADDRESS = 0x7109709ECFA91A80626FF3989D68F67F5B1DD12D

SYMBOLIC_CALLDATA_SIZE = 320  # symbolic retdata window, matches reference


def get_call_parameters(global_state: GlobalState, dynamic_loader,
                        with_value: bool = False):
    """Pop and resolve CALL-family args:
    returns (callee_address, callee_account, call_data, value, gas, memory_out_offset,
    memory_out_size). callee_account None <=> unresolvable (symbolic) target."""
    gas, to = global_state.mstate.pop(2)
    value = global_state.mstate.pop() if with_value else symbol_factory.BitVecVal(0, 256)
    memory_input_offset, memory_input_size = global_state.mstate.pop(2)
    memory_out_offset, memory_out_size = global_state.mstate.pop(2)

    callee_address = get_callee_address(global_state, dynamic_loader, to)
    callee_account = None
    call_data = get_call_data(global_state, memory_input_offset, memory_input_size)

    # resolve an account only for concrete non-precompile targets; a symbolic
    # target stays unresolved (no phantom account minted into the world state)
    if isinstance(callee_address, str) and int(callee_address, 16) > 10:
        callee_account = get_callee_account(global_state, callee_address,
                                            dynamic_loader)
    return (callee_address, callee_account, call_data, value, gas,
            memory_out_offset, memory_out_size)


def get_callee_address(global_state: GlobalState, dynamic_loader,
                       symbolic_to_address: BitVec) -> Union[str, BitVec]:
    """Concrete hex address, or the symbolic expression if unresolvable; the
    Storage[i]-pattern DynLoader resolution of the reference (call.py:105-117)."""
    environment = global_state.environment
    if symbolic_to_address.raw.is_const:
        return "0x" + "{:040x}".format(symbolic_to_address.value)
    if dynamic_loader is None:
        return symbolic_to_address

    match = re.search(r"Storage\[(\d+)\]",
                      str(simplify(symbolic_to_address).raw))
    if match is None:
        return symbolic_to_address
    index = int(match.group(1))
    try:
        callee_address = dynamic_loader.read_storage(
            contract_address="0x{:040x}".format(
                environment.active_account.address.value), index=index)
    except Exception:
        return symbolic_to_address
    return "0x" + callee_address[-40:].rjust(40, "0")


def get_callee_account(global_state: GlobalState,
                       callee_address: Union[str, BitVec], dynamic_loader) -> Account:
    if isinstance(callee_address, BitVec):
        if callee_address.raw.is_const:
            callee_address = "0x{:040x}".format(callee_address.value)
        else:
            return global_state.world_state.accounts_exist_or_load(
                callee_address, dynamic_loader)
    return global_state.world_state.accounts_exist_or_load(callee_address,
                                                           dynamic_loader)


def get_call_data(global_state: GlobalState,
                  memory_start: Union[int, BitVec],
                  size: Union[int, BitVec]) -> BaseCalldata:
    """Build a calldata view over the caller's memory."""
    mstate = global_state.mstate
    transaction_id = f"{global_state.current_transaction.id}_internalcall"

    if isinstance(memory_start, BitVec) and memory_start.raw.is_const:
        memory_start = memory_start.value
    if isinstance(size, BitVec) and size.raw.is_const:
        size = size.value

    if isinstance(memory_start, int) and isinstance(size, int):
        if size == 0:
            return ConcreteCalldata(transaction_id, [])
        data = mstate.memory[memory_start:memory_start + size]
        if all(isinstance(byte, BitVec) and byte.raw.is_const for byte in data):
            return ConcreteCalldata(transaction_id, [byte.value for byte in data])
        return _MemoryViewCalldata(transaction_id, data)  # mixed/symbolic bytes
    log.debug("unsupported symbolic memory offset/size for calldata view")
    return SymbolicCalldata(transaction_id)


class _MemoryViewCalldata(BaseCalldata):
    """Calldata over a list of (possibly symbolic) byte expressions."""

    def __init__(self, tx_id, byte_expressions: List[BitVec]):
        self._bytes = list(byte_expressions)
        super().__init__(tx_id)

    def _load(self, item):
        if isinstance(item, int):
            if item < len(self._bytes):
                return self._bytes[item]
            return symbol_factory.BitVecVal(0, 8)
        from ..smt import If

        value = symbol_factory.BitVecVal(0, 8)
        for index in range(len(self._bytes) - 1, -1, -1):
            value = If(item == index, self._bytes[index], value)
        return value

    @property
    def size(self) -> int:
        return len(self._bytes)

    def concrete(self, model) -> list:
        out = []
        for byte in self._bytes:
            if byte.raw.is_const:
                out.append(byte.value)
            else:
                out.append(model.eval(byte) if model else 0)
        return out


def native_call(global_state: GlobalState, callee_address: Union[str, BitVec],
                call_data: BaseCalldata, memory_out_offset, memory_out_size) -> Optional[List[GlobalState]]:
    """Handle precompile targets in-place (no new tx). Returns successor states or
    None if the target is not a precompile."""
    if isinstance(callee_address, BitVec) or int(callee_address, 16) not in PRECOMPILE_ADDRESSES:
        return None
    contract_index = int(callee_address, 16)

    global_state.mstate.stack.append(symbol_factory.BitVecVal(1, 256))
    try:
        data = native_contracts[contract_index](call_data)
    except NativeContractException:
        # symbolic input: write symbolic retdata bytes
        contract_name = native_contracts[contract_index].__name__
        if isinstance(memory_out_offset, BitVec) and not memory_out_offset.raw.is_const:
            return [global_state]
        offset = memory_out_offset.value if isinstance(memory_out_offset, BitVec) \
            else memory_out_offset
        size = memory_out_size.value if (isinstance(memory_out_size, BitVec)
                                         and memory_out_size.raw.is_const) else 0
        for i in range(min(size, SYMBOLIC_CALLDATA_SIZE)):
            global_state.mstate.memory[offset + i] = global_state.new_bitvec(
                f"{contract_name}({str(call_data)})_{i}", 8)
        return [global_state]

    if isinstance(memory_out_offset, BitVec) and not memory_out_offset.raw.is_const:
        return [global_state]
    offset = memory_out_offset.value if isinstance(memory_out_offset, BitVec) \
        else memory_out_offset
    if isinstance(memory_out_size, BitVec):
        # symbolic out-size: conservatively write the full precompile output
        out_size = memory_out_size.value if memory_out_size.raw.is_const \
            else len(data)
    else:
        out_size = memory_out_size
    write_size = min(out_size, len(data))
    global_state.mstate.mem_extend(offset, write_size)
    for i in range(write_size):
        global_state.mstate.memory[offset + i] = data[i]
    from .state.return_data import ReturnData

    global_state.last_return_data = ReturnData(
        [symbol_factory.BitVecVal(b, 8) for b in data], len(data))
    return [global_state]
