"""Symbolic EVM instruction semantics (capability parity:
mythril/laser/ethereum/instructions.py — StateTransition:99, Instruction:206,
evaluate:236, and every opcode-family handler through Cancun).

Each handler maps GlobalState -> List[GlobalState]. JUMPI forks by copying the state
(cheap here: expressions are immutable/hash-consed so copies are shallow) and
appending the branch condition to world_state.constraints. CALL-family raises
TransactionStartSignal; RETURN/STOP/REVERT/SELFDESTRUCT raise TransactionEndSignal
(svm.py catches both). The TPU lockstep interpreter (parallel/lockstep.py) implements
the same semantics over dense lanes; tests/test_lockstep.py differential-tests the
two against each other per opcode.

The port's copy of mythril_tpu/core/instructions.py."""

from __future__ import annotations

import logging
from copy import copy
from functools import wraps
from typing import Callable, List, Optional, Tuple, Union

from ..exceptions import UnsatError
from ..ops.opcodes import OPCODES, GAS, STACK
from ..smt.solver import cfa_screen
from ..smt import (And, BitVec, Bool, Concat, Extract, If, LShR, Not, Or, SignExt,
                   UDiv, UGE, UGT, ULE, ULT, URem, SRem, SDiv, ZeroExt, simplify,
                   symbol_factory)
from ..utils.helpers import TT256, ceil32
from ..utils.keccak import keccak256
from .function_managers import exponent_function_manager, keccak_function_manager
from .call import (SYMBOLIC_CALLDATA_SIZE, get_call_parameters, native_call)
from .cheat_code import handle_cheat_codes, hevm_cheat_code
from .state.calldata import ConcreteCalldata
from .state.global_state import GlobalState
from .state.return_data import ReturnData
from .transaction.transaction_models import (ContractCreationTransaction,
                                             MessageCallTransaction,
                                             TransactionEndSignal,
                                             TransactionStartSignal,
                                             get_next_transaction_id)
from .util import (InvalidInstruction, InvalidJumpDestination, OutOfGasException,
                   VmException, WriteProtection, get_concrete_int)

log = logging.getLogger(__name__)

TT255 = 2 ** 255


def transfer_ether(global_state: GlobalState, sender: BitVec, receiver: BitVec,
                   value: BitVec) -> None:
    """Value transfer with sufficiency constraint on the path."""
    world_state = global_state.world_state
    world_state.constraints.append(UGE(world_state.balances[sender], value))
    world_state.balances[receiver] = world_state.balances[receiver] + value
    world_state.balances[sender] = world_state.balances[sender] - value


class StateTransition:
    """Handler decorator: copy the incoming state, run, account gas, advance pc
    (reference instructions.py:99-203 incl. static-call write protection)."""

    def __init__(self, increment_pc: bool = True, enable_gas: bool = True,
                 is_state_mutation_instruction: bool = False):
        self.increment_pc = increment_pc
        self.enable_gas = enable_gas
        self.is_state_mutation_instruction = is_state_mutation_instruction

    def __call__(self, func: Callable) -> Callable:
        @wraps(func)
        def wrapper(instruction: "Instruction", global_state: GlobalState):
            if self.is_state_mutation_instruction and global_state.environment.static:
                raise WriteProtection(
                    f"{func.__name__[:-1].upper()} in static call context")
            new_global_state = copy(global_state)
            new_global_state.mstate.prev_pc = global_state.mstate.pc
            states = func(instruction, new_global_state)
            for state in states:
                if self.enable_gas:
                    instruction.accumulate_gas(state)
                if self.increment_pc:
                    state.mstate.pc += 1
            return states

        return wrapper


class Instruction:
    """One opcode's semantics, dispatched by mnemonic mangling
    (PUSH1->push_, DUP3->dup_, SWAP5->swap_, LOG2->log_)."""

    def __init__(self, op_code: str, dynamic_loader=None, pre_hooks=None,
                 post_hooks=None):
        self.op_code = op_code.upper()
        self.dynamic_loader = dynamic_loader
        self.pre_hook = pre_hooks or []
        self.post_hook = post_hooks or []

    def accumulate_gas(self, global_state: GlobalState) -> None:
        meta = OPCODES.get(self.op_code)
        if meta is None:
            return
        gas_min, gas_max = meta[GAS]
        global_state.mstate.min_gas_used += gas_min
        global_state.mstate.max_gas_used += gas_max
        # certainly-OOG paths abort here (reference instructions.py:163-187)
        global_state.mstate.check_gas()

    def evaluate(self, global_state: GlobalState, post: bool = False) -> List[GlobalState]:
        op = self.op_code.lower()
        if op.startswith("push") and op != "push0":
            op = "push"
        elif op.startswith("dup"):
            op = "dup"
        elif op.startswith("swap"):
            op = "swap"
        elif op.startswith("log"):
            op = "log"
        elif op == "difficulty":
            op = "prevrandao"
        handler_name = op + ("_post" if post else "_")
        handler = getattr(self, handler_name, None)
        if handler is None:
            raise InvalidInstruction(f"unknown opcode {self.op_code}")

        if not post:
            for hook in self.pre_hook:
                hook(global_state)
        result = handler(global_state)
        if not post:
            for hook in self.post_hook:
                for state in result:
                    hook(state)
        return result

    # == arithmetic ================================================================
    @StateTransition()
    def add_(self, s: GlobalState) -> List[GlobalState]:
        a, b = s.mstate.pop(2)
        s.mstate.stack.append(a + b)
        return [s]

    @StateTransition()
    def sub_(self, s: GlobalState) -> List[GlobalState]:
        a, b = s.mstate.pop(2)
        s.mstate.stack.append(a - b)
        return [s]

    @StateTransition()
    def mul_(self, s: GlobalState) -> List[GlobalState]:
        a, b = s.mstate.pop(2)
        s.mstate.stack.append(a * b)
        return [s]

    @StateTransition()
    def div_(self, s: GlobalState) -> List[GlobalState]:
        a, b = s.mstate.pop(2)
        s.mstate.stack.append(If(b == 0, symbol_factory.BitVecVal(0, 256), UDiv(a, b)))
        return [s]

    @StateTransition()
    def sdiv_(self, s: GlobalState) -> List[GlobalState]:
        a, b = s.mstate.pop(2)
        s.mstate.stack.append(If(b == 0, symbol_factory.BitVecVal(0, 256), SDiv(a, b)))
        return [s]

    @StateTransition()
    def mod_(self, s: GlobalState) -> List[GlobalState]:
        a, b = s.mstate.pop(2)
        s.mstate.stack.append(If(b == 0, symbol_factory.BitVecVal(0, 256), URem(a, b)))
        return [s]

    @StateTransition()
    def smod_(self, s: GlobalState) -> List[GlobalState]:
        a, b = s.mstate.pop(2)
        s.mstate.stack.append(If(b == 0, symbol_factory.BitVecVal(0, 256), SRem(a, b)))
        return [s]

    @StateTransition()
    def addmod_(self, s: GlobalState) -> List[GlobalState]:
        a, b, m = s.mstate.pop(3)
        wide = ZeroExt(256, a) + ZeroExt(256, b)
        result = Extract(255, 0, URem(wide, ZeroExt(256, m)))
        s.mstate.stack.append(If(m == 0, symbol_factory.BitVecVal(0, 256), result))
        return [s]

    @StateTransition()
    def mulmod_(self, s: GlobalState) -> List[GlobalState]:
        a, b, m = s.mstate.pop(3)
        wide = ZeroExt(256, a) * ZeroExt(256, b)
        result = Extract(255, 0, URem(wide, ZeroExt(256, m)))
        s.mstate.stack.append(If(m == 0, symbol_factory.BitVecVal(0, 256), result))
        return [s]

    @StateTransition()
    def exp_(self, s: GlobalState) -> List[GlobalState]:
        base, exponent = s.mstate.pop(2)
        if base.raw.is_const and exponent.raw.is_const:
            s.mstate.stack.append(symbol_factory.BitVecVal(
                pow(base.value, exponent.value, TT256), 256))
            return [s]
        if exponent.raw.is_const and exponent.value <= 8 and not base.raw.is_const:
            # small concrete exponent: expand to repeated multiply (exact semantics)
            result = symbol_factory.BitVecVal(1, 256)
            for _ in range(exponent.value):
                result = result * base
            s.mstate.stack.append(result)
            return [s]
        power, conditions = exponent_function_manager.create_condition(base, exponent)
        s.world_state.constraints.append(conditions)
        s.mstate.stack.append(power)
        return [s]

    @StateTransition()
    def signextend_(self, s: GlobalState) -> List[GlobalState]:
        index, value = s.mstate.pop(2)
        if index.raw.is_const:
            i = index.value
            if i >= 31:
                s.mstate.stack.append(value)
            else:
                bits = 8 * (i + 1)
                s.mstate.stack.append(SignExt(256 - bits, Extract(bits - 1, 0, value)))
            return [s]
        result = value
        for i in range(31):
            bits = 8 * (i + 1)
            result = If(index == i,
                        SignExt(256 - bits, Extract(bits - 1, 0, value)), result)
        s.mstate.stack.append(result)
        return [s]

    # == comparison / bitwise ======================================================
    @StateTransition()
    def lt_(self, s: GlobalState) -> List[GlobalState]:
        a, b = s.mstate.pop(2)
        s.mstate.stack.append(If(ULT(a, b), symbol_factory.BitVecVal(1, 256),
                                 symbol_factory.BitVecVal(0, 256)))
        return [s]

    @StateTransition()
    def gt_(self, s: GlobalState) -> List[GlobalState]:
        a, b = s.mstate.pop(2)
        s.mstate.stack.append(If(UGT(a, b), symbol_factory.BitVecVal(1, 256),
                                 symbol_factory.BitVecVal(0, 256)))
        return [s]

    @StateTransition()
    def slt_(self, s: GlobalState) -> List[GlobalState]:
        a, b = s.mstate.pop(2)
        s.mstate.stack.append(If(a < b, symbol_factory.BitVecVal(1, 256),
                                 symbol_factory.BitVecVal(0, 256)))
        return [s]

    @StateTransition()
    def sgt_(self, s: GlobalState) -> List[GlobalState]:
        a, b = s.mstate.pop(2)
        s.mstate.stack.append(If(a > b, symbol_factory.BitVecVal(1, 256),
                                 symbol_factory.BitVecVal(0, 256)))
        return [s]

    @StateTransition()
    def eq_(self, s: GlobalState) -> List[GlobalState]:
        a, b = s.mstate.pop(2)
        s.mstate.stack.append(If(a == b, symbol_factory.BitVecVal(1, 256),
                                 symbol_factory.BitVecVal(0, 256)))
        return [s]

    @StateTransition()
    def iszero_(self, s: GlobalState) -> List[GlobalState]:
        value = s.mstate.pop()
        s.mstate.stack.append(If(value == 0, symbol_factory.BitVecVal(1, 256),
                                 symbol_factory.BitVecVal(0, 256)))
        return [s]

    @StateTransition()
    def and_(self, s: GlobalState) -> List[GlobalState]:
        a, b = s.mstate.pop(2)
        s.mstate.stack.append(a & b)
        return [s]

    @StateTransition()
    def or_(self, s: GlobalState) -> List[GlobalState]:
        a, b = s.mstate.pop(2)
        s.mstate.stack.append(a | b)
        return [s]

    @StateTransition()
    def xor_(self, s: GlobalState) -> List[GlobalState]:
        a, b = s.mstate.pop(2)
        s.mstate.stack.append(a ^ b)
        return [s]

    @StateTransition()
    def not_(self, s: GlobalState) -> List[GlobalState]:
        value = s.mstate.pop()
        s.mstate.stack.append(~value)
        return [s]

    @StateTransition()
    def byte_(self, s: GlobalState) -> List[GlobalState]:
        index, word = s.mstate.pop(2)
        if index.raw.is_const:
            i = index.value
            if i >= 32:
                s.mstate.stack.append(symbol_factory.BitVecVal(0, 256))
            else:
                s.mstate.stack.append(ZeroExt(
                    248, Extract(255 - 8 * i, 248 - 8 * i, word)))
            return [s]
        result = symbol_factory.BitVecVal(0, 256)
        for i in range(32):
            result = If(index == i,
                        ZeroExt(248, Extract(255 - 8 * i, 248 - 8 * i, word)), result)
        s.mstate.stack.append(result)
        return [s]

    @StateTransition()
    def shl_(self, s: GlobalState) -> List[GlobalState]:
        shift, value = s.mstate.pop(2)
        s.mstate.stack.append(value << shift)
        return [s]

    @StateTransition()
    def shr_(self, s: GlobalState) -> List[GlobalState]:
        shift, value = s.mstate.pop(2)
        s.mstate.stack.append(LShR(value, shift))
        return [s]

    @StateTransition()
    def sar_(self, s: GlobalState) -> List[GlobalState]:
        shift, value = s.mstate.pop(2)
        s.mstate.stack.append(value >> shift)
        return [s]

    # == sha3 ======================================================================
    @StateTransition()
    def sha3_(self, s: GlobalState) -> List[GlobalState]:
        offset, length = s.mstate.pop(2)
        if length.raw.is_const and length.value == 0:
            s.mstate.stack.append(symbol_factory.BitVecVal(
                int.from_bytes(keccak256(b""), "big"), 256))
            return [s]
        if not length.raw.is_const or not offset.raw.is_const:
            # symbolic bounds: unconstrained fresh word (reference approximation)
            result = s.new_bitvec(f"KECCAC_mem[{offset}]", 256)
            s.mstate.stack.append(result)
            return [s]
        start, size = offset.value, length.value
        s.mstate.mem_extend(start, size)
        byte_list = [s.mstate.memory[i] for i in range(start, start + size)]
        if all(byte.raw.is_const for byte in byte_list):
            data = bytes(byte.value for byte in byte_list)
            s.mstate.stack.append(symbol_factory.BitVecVal(
                int.from_bytes(keccak256(data), "big"), 256))
            return [s]
        data_word = simplify(Concat(*byte_list)) if len(byte_list) > 1 else byte_list[0]
        result = keccak_function_manager.create_keccak(data_word)
        s.mstate.stack.append(result)
        return [s]

    # == environment ===============================================================
    @StateTransition()
    def address_(self, s: GlobalState) -> List[GlobalState]:
        s.mstate.stack.append(s.environment.address)
        return [s]

    @StateTransition()
    def balance_(self, s: GlobalState) -> List[GlobalState]:
        address = s.mstate.pop()
        s.mstate.stack.append(s.world_state.balances[address])
        return [s]

    @StateTransition()
    def origin_(self, s: GlobalState) -> List[GlobalState]:
        s.mstate.stack.append(s.environment.origin)
        return [s]

    @StateTransition()
    def caller_(self, s: GlobalState) -> List[GlobalState]:
        s.mstate.stack.append(s.environment.sender)
        return [s]

    @StateTransition()
    def callvalue_(self, s: GlobalState) -> List[GlobalState]:
        s.mstate.stack.append(s.environment.callvalue)
        return [s]

    @StateTransition()
    def calldataload_(self, s: GlobalState) -> List[GlobalState]:
        offset = s.mstate.pop()
        s.mstate.stack.append(s.environment.calldata.get_word_at(offset))
        return [s]

    @StateTransition()
    def calldatasize_(self, s: GlobalState) -> List[GlobalState]:
        s.mstate.stack.append(s.environment.calldata.calldatasize)
        return [s]

    def _copy_to_memory(self, s: GlobalState, mem_offset, size,
                        fetch: Callable[[int], BitVec], label: str) -> None:
        """Shared body of CALLDATACOPY/CODECOPY/RETURNDATACOPY/EXTCODECOPY/MCOPY.
        `fetch(i)` yields source byte i of the copy (callers close over their own
        source offset, symbolic or concrete)."""
        if not (mem_offset.raw.is_const and size.raw.is_const):
            # symbolic target/size: fresh bytes over an approximation window
            if mem_offset.raw.is_const:
                for i in range(SYMBOLIC_CALLDATA_SIZE):
                    s.mstate.memory[mem_offset.value + i] = s.new_bitvec(
                        f"{label}_{i}", 8)
            return
        start, length = mem_offset.value, size.value
        if length == 0:
            return
        s.mstate.mem_extend(start, length)
        for i in range(length):
            s.mstate.memory[start + i] = fetch(i)

    @StateTransition()
    def calldatacopy_(self, s: GlobalState) -> List[GlobalState]:
        mem_offset, data_offset, size = s.mstate.pop(3)
        if isinstance(s.current_transaction, ContractCreationTransaction):
            # creation "calldata" is code||args, but the symbolic creation
            # calldata models ONLY the args (served through codecopy past
            # the code end) — copying from offset 0 here would conflate
            # code bytes with arg bytes. The reference no-ops CALLDATACOPY
            # in creation txs (instructions.py:891-893).
            log.debug("CALLDATACOPY during contract creation: no-op")
            return [s]
        calldata = s.environment.calldata
        if data_offset.raw.is_const:
            base = data_offset.value
            fetch = lambda i: calldata[base + i]
        else:
            fetch = lambda i: calldata[data_offset + i]  # symbolic source index
        self._copy_to_memory(s, mem_offset, size, fetch, "calldatacopy")
        return [s]

    @StateTransition()
    def codesize_(self, s: GlobalState) -> List[GlobalState]:
        no_of_bytes = len(s.environment.code.raw_code)
        transaction = s.current_transaction
        if isinstance(transaction, ContractCreationTransaction):
            # constructor ARGUMENTS are appended past the creation code;
            # reserve space for 16 32-byte args and pin the symbolic
            # calldata's size to it (reference instructions.py:983-1004)
            calldata = s.environment.calldata
            if isinstance(calldata, ConcreteCalldata):
                no_of_bytes += calldata.size
            else:
                no_of_bytes += 0x200
                s.world_state.constraints.append(
                    calldata.calldatasize ==
                    symbol_factory.BitVecVal(no_of_bytes, 256))
        s.mstate.stack.append(symbol_factory.BitVecVal(no_of_bytes, 256))
        return [s]

    @StateTransition()
    def codecopy_(self, s: GlobalState) -> List[GlobalState]:
        mem_offset, code_offset, size = s.mstate.pop(3)
        code = s.environment.code.raw_code
        if isinstance(s.current_transaction, ContractCreationTransaction) \
                and code_offset.raw.is_const \
                and code_offset.value >= len(code):
            # creation code past its end = the constructor arguments,
            # served from the (symbolic) creation calldata
            # (reference instructions.py:1078-1105)
            arg_offset = symbol_factory.BitVecVal(
                code_offset.value - len(code), 256)
            calldata = s.environment.calldata

            def fetch(i: int) -> BitVec:
                return calldata[arg_offset + i]

            self._copy_to_memory(s, mem_offset, size, fetch, "codecopy")
            return [s]
        fetch = self._code_fetcher(s, code, code_offset, "codecopy")
        self._copy_to_memory(s, mem_offset, size, fetch, "codecopy")
        return [s]

    def _code_fetcher(self, s: GlobalState, code: bytes, code_offset,
                      label: str) -> Callable[[int], BitVec]:
        if code_offset.raw.is_const:
            base = code_offset.value

            def fetch(i: int) -> BitVec:
                position = base + i
                if position < len(code):
                    return symbol_factory.BitVecVal(code[position], 8)
                return symbol_factory.BitVecVal(0, 8)  # STOP padding
        else:
            def fetch(i: int) -> BitVec:
                return s.new_bitvec(f"{label}_{i}", 8)  # symbolic code offset
        return fetch

    @StateTransition()
    def gasprice_(self, s: GlobalState) -> List[GlobalState]:
        s.mstate.stack.append(s.environment.gasprice)
        return [s]

    @StateTransition()
    def extcodesize_(self, s: GlobalState) -> List[GlobalState]:
        address = s.mstate.pop()
        if address.raw.is_const and address.value in s.world_state.accounts:
            code = s.world_state.accounts[address.value].code.raw_code
            s.mstate.stack.append(symbol_factory.BitVecVal(len(code), 256))
        else:
            s.mstate.stack.append(s.new_bitvec(f"extcodesize_{address}", 256))
        return [s]

    @StateTransition()
    def extcodecopy_(self, s: GlobalState) -> List[GlobalState]:
        address, mem_offset, code_offset, size = s.mstate.pop(4)
        code = b""
        if address.raw.is_const and address.value in s.world_state.accounts:
            code = s.world_state.accounts[address.value].code.raw_code
        fetch = self._code_fetcher(s, code, code_offset, "extcodecopy")
        self._copy_to_memory(s, mem_offset, size, fetch, "extcodecopy")
        return [s]

    @StateTransition()
    def returndatasize_(self, s: GlobalState) -> List[GlobalState]:
        if s.last_return_data is None:
            s.mstate.stack.append(symbol_factory.BitVecVal(0, 256))
        else:
            s.mstate.stack.append(s.last_return_data.size)
        return [s]

    @StateTransition()
    def returndatacopy_(self, s: GlobalState) -> List[GlobalState]:
        mem_offset, return_offset, size = s.mstate.pop(3)
        return_data = s.last_return_data
        base = return_offset.value if return_offset.raw.is_const else return_offset

        def fetch(i: int) -> BitVec:
            if return_data is None:
                return symbol_factory.BitVecVal(0, 8)
            value = return_data[base + i]
            return value if isinstance(value, BitVec) \
                else symbol_factory.BitVecVal(value, 8)

        self._copy_to_memory(s, mem_offset, size, fetch, "returndatacopy")
        return [s]

    @StateTransition()
    def extcodehash_(self, s: GlobalState) -> List[GlobalState]:
        address = s.mstate.pop()
        if address.raw.is_const and address.value in s.world_state.accounts:
            code = s.world_state.accounts[address.value].code.raw_code
            s.mstate.stack.append(symbol_factory.BitVecVal(
                int.from_bytes(keccak256(code), "big"), 256))
        else:
            s.mstate.stack.append(s.new_bitvec(f"extcodehash_{address}", 256))
        return [s]

    @StateTransition()
    def mcopy_(self, s: GlobalState) -> List[GlobalState]:
        dst, src, size = s.mstate.pop(3)
        if dst.raw.is_const and src.raw.is_const and size.raw.is_const:
            length = size.value
            s.mstate.mem_extend(dst.value, length)
            source_bytes = [s.mstate.memory[src.value + i] for i in range(length)]
            for i in range(length):
                s.mstate.memory[dst.value + i] = source_bytes[i]
        return [s]

    # == block data ================================================================
    @StateTransition()
    def blockhash_(self, s: GlobalState) -> List[GlobalState]:
        block_number = s.mstate.pop()
        s.mstate.stack.append(s.new_bitvec(f"blockhash_block_{block_number}", 256))
        return [s]

    @StateTransition()
    def coinbase_(self, s: GlobalState) -> List[GlobalState]:
        s.mstate.stack.append(s.new_bitvec("coinbase", 256))
        return [s]

    @StateTransition()
    def timestamp_(self, s: GlobalState) -> List[GlobalState]:
        s.mstate.stack.append(s.new_bitvec("timestamp", 256))
        return [s]

    @StateTransition()
    def number_(self, s: GlobalState) -> List[GlobalState]:
        if s.environment.block_number is None:
            s.environment.block_number = s.new_bitvec("block_number", 256)
        s.mstate.stack.append(s.environment.block_number)
        return [s]

    @StateTransition()
    def prevrandao_(self, s: GlobalState) -> List[GlobalState]:
        s.mstate.stack.append(s.new_bitvec("prevrandao", 256))
        return [s]

    @StateTransition()
    def gaslimit_(self, s: GlobalState) -> List[GlobalState]:
        s.mstate.stack.append(symbol_factory.BitVecVal(s.mstate.gas_limit, 256))
        return [s]

    @StateTransition()
    def chainid_(self, s: GlobalState) -> List[GlobalState]:
        s.mstate.stack.append(s.environment.chainid)
        return [s]

    @StateTransition()
    def selfbalance_(self, s: GlobalState) -> List[GlobalState]:
        s.mstate.stack.append(s.world_state.balances[s.environment.address])
        return [s]

    @StateTransition()
    def basefee_(self, s: GlobalState) -> List[GlobalState]:
        s.mstate.stack.append(s.environment.basefee)
        return [s]

    @StateTransition()
    def blobhash_(self, s: GlobalState) -> List[GlobalState]:
        index = s.mstate.pop()
        s.mstate.stack.append(s.new_bitvec(f"blobhash_{index}", 256))
        return [s]

    @StateTransition()
    def blobbasefee_(self, s: GlobalState) -> List[GlobalState]:
        s.mstate.stack.append(s.new_bitvec("blobbasefee", 256))
        return [s]

    # == stack / memory / storage ==================================================
    @StateTransition()
    def pop_(self, s: GlobalState) -> List[GlobalState]:
        s.mstate.pop()
        return [s]

    @StateTransition()
    def push_(self, s: GlobalState) -> List[GlobalState]:
        instruction = s.get_current_instruction()
        width = int(self.op_code[4:])
        argument = instruction.get("argument", "0x0")
        if isinstance(argument, BitVec):
            # symbolic immediate (immutable deployed from a constructor arg)
            s.mstate.stack.append(ZeroExt(256 - argument.size(), argument)
                                  if argument.size() < 256 else argument)
            return [s]
        if isinstance(argument, str):
            value = int(argument, 16) if len(argument) > 2 else 0  # "0x": no immediate
        else:
            value = argument
        # truncated immediate at end-of-code pads with zeros on the right
        immediate_bytes = (len(argument) - 2) // 2 if isinstance(argument, str) else width
        if immediate_bytes < width:
            value = value << (8 * (width - immediate_bytes))
        s.mstate.stack.append(symbol_factory.BitVecVal(value, 256))
        return [s]

    @StateTransition()
    def push0_(self, s: GlobalState) -> List[GlobalState]:
        s.mstate.stack.append(symbol_factory.BitVecVal(0, 256))
        return [s]

    @StateTransition()
    def dup_(self, s: GlobalState) -> List[GlobalState]:
        depth = int(self.op_code[3:])
        s.mstate.stack.append(s.mstate.stack[-depth])
        return [s]

    @StateTransition()
    def swap_(self, s: GlobalState) -> List[GlobalState]:
        depth = int(self.op_code[4:])
        stack = s.mstate.stack
        stack[-1], stack[-depth - 1] = stack[-depth - 1], stack[-1]
        return [s]

    @StateTransition()
    def mload_(self, s: GlobalState) -> List[GlobalState]:
        offset = s.mstate.pop()
        s.mstate.mem_extend(offset, 32)
        s.mstate.stack.append(s.mstate.memory.get_word_at(
            offset if not offset.raw.is_const else offset.value))
        return [s]

    @StateTransition()
    def mstore_(self, s: GlobalState) -> List[GlobalState]:
        offset, value = s.mstate.pop(2)
        s.mstate.mem_extend(offset, 32)
        s.mstate.memory.write_word_at(
            offset if not offset.raw.is_const else offset.value, value)
        return [s]

    @StateTransition()
    def mstore8_(self, s: GlobalState) -> List[GlobalState]:
        offset, value = s.mstate.pop(2)
        s.mstate.mem_extend(offset, 1)
        s.mstate.memory[offset if not offset.raw.is_const else offset.value] = \
            Extract(7, 0, value)
        return [s]

    @StateTransition()
    def sload_(self, s: GlobalState) -> List[GlobalState]:
        index = s.mstate.pop()
        s.mstate.stack.append(s.environment.active_account.storage[index])
        return [s]

    @StateTransition(is_state_mutation_instruction=True)
    def sstore_(self, s: GlobalState) -> List[GlobalState]:
        index, value = s.mstate.pop(2)
        s.environment.active_account.storage[index] = value
        return [s]

    @StateTransition()
    def tload_(self, s: GlobalState) -> List[GlobalState]:
        index = s.mstate.pop()
        s.mstate.stack.append(s.world_state.transient_storage.get(
            s.environment.address, index))
        return [s]

    @StateTransition(is_state_mutation_instruction=True)
    def tstore_(self, s: GlobalState) -> List[GlobalState]:
        index, value = s.mstate.pop(2)
        s.world_state.transient_storage.set(s.environment.address, index, value)
        return [s]

    # == control flow ==============================================================
    @StateTransition(increment_pc=False)
    def jump_(self, s: GlobalState) -> List[GlobalState]:
        destination = s.mstate.pop()
        try:
            jump_address = get_concrete_int(destination)
        except TypeError:
            raise InvalidJumpDestination("symbolic JUMP destination")
        index = s.environment.code.index_of_address(jump_address)
        # pre-solver screen: the CFA tables answer target validity
        # statically (counted; a False verdict prunes before any
        # constraint/solver work); None -> dynamic check as before
        verdict = cfa_screen.screen_jump_target(s.environment.code, jump_address)
        if verdict is None:
            valid = (index is not None
                     and s.environment.code.instruction_list[index].op_code
                     == "JUMPDEST")
        else:
            valid = verdict and index is not None
        if not valid:
            raise InvalidJumpDestination(f"JUMP to invalid address {jump_address}")
        s.mstate.pc = index
        return [s]

    @StateTransition(increment_pc=False)
    def jumpi_(self, s: GlobalState) -> List[GlobalState]:
        destination, condition_word = s.mstate.pop(2)
        negated = condition_word == 0
        positive = Not(negated)
        states: List[GlobalState] = []

        # range screen: the interval tables prove some conditions
        # constant for EVERY execution of this site (e.g. out-of-range
        # CALLDATALOAD selector compares) — the infeasible side would
        # only ever produce an unsat branch, so it is dropped here
        # before any constraint is appended or solver query issued.
        # None -> both sides stay on their dynamic checks as before
        range_verdict = cfa_screen.jumpi_verdict(
            s.environment.code, s.get_current_instruction()["address"])

        # fall-through branch
        if range_verdict is not True and not negated.is_false:
            negative_state = copy(s)
            negative_state.mstate.pc += 1
            negative_state.mstate.depth += 1  # depth = branches taken
            negative_state.world_state.constraints.append(negated)
            states.append(negative_state)

        # taken branch
        if range_verdict is not False and not positive.is_false:
            try:
                jump_address = get_concrete_int(destination)
            except TypeError:
                log.debug("skipping symbolic JUMPI destination")
                return states
            index = s.environment.code.index_of_address(jump_address)
            verdict = cfa_screen.screen_jump_target(
                s.environment.code, jump_address)
            if verdict is None:
                valid = (index is not None
                         and s.environment.code.instruction_list[index].op_code
                         == "JUMPDEST")
            else:
                valid = verdict and index is not None
            if valid:
                positive_state = copy(s)
                positive_state.mstate.pc = index
                positive_state.mstate.depth += 1  # depth = branches taken
                positive_state.world_state.constraints.append(positive)
                states.append(positive_state)
        return states

    @StateTransition()
    def pc_(self, s: GlobalState) -> List[GlobalState]:
        instruction = s.get_current_instruction()
        s.mstate.stack.append(symbol_factory.BitVecVal(instruction["address"], 256))
        return [s]

    @StateTransition()
    def msize_(self, s: GlobalState) -> List[GlobalState]:
        s.mstate.stack.append(symbol_factory.BitVecVal(s.mstate.memory_size, 256))
        return [s]

    @StateTransition()
    def gas_(self, s: GlobalState) -> List[GlobalState]:
        s.mstate.stack.append(s.new_bitvec("gas", 256))
        return [s]

    @StateTransition()
    def jumpdest_(self, s: GlobalState) -> List[GlobalState]:
        return [s]

    @StateTransition(is_state_mutation_instruction=True)
    def log_(self, s: GlobalState) -> List[GlobalState]:
        depth = int(self.op_code[3:])
        s.mstate.pop(depth + 2)
        return [s]

    # == transaction boundary ======================================================
    def _create(self, s: GlobalState, value: BitVec, mem_offset: BitVec,
                mem_size: BitVec, salt: Optional[BitVec]) -> List[GlobalState]:
        if not (mem_offset.raw.is_const and mem_size.raw.is_const):
            log.debug("symbolic CREATE code window; pushing unconstrained address")
            s.mstate.stack.append(s.new_bitvec("create_result", 256))
            s.mstate.pc += 1
            return [s]
        code_bytes = s.mstate.memory[mem_offset.value:mem_offset.value + mem_size.value]
        if not all(isinstance(byte, BitVec) and byte.raw.is_const
                   for byte in code_bytes):
            s.mstate.stack.append(s.new_bitvec("create_result", 256))
            s.mstate.pc += 1
            return [s]
        init_code = bytes(byte.value for byte in code_bytes)
        from ..frontends.disassembler import Disassembly
        from ..utils.helpers import generate_salted_address

        creator = s.environment.active_account
        contract_address = None
        if salt is not None and salt.raw.is_const and creator.address.raw.is_const:
            contract_address = generate_salted_address(
                creator.address.value, salt.value, init_code)
        transaction = ContractCreationTransaction(
            world_state=s.world_state,
            caller=s.environment.address,
            code=Disassembly(init_code.hex()),
            call_data=[],
            gas_price=s.environment.gasprice,
            gas_limit=s.mstate.gas_limit,
            origin=s.environment.origin,
            call_value=value,
            contract_address=contract_address,
        )
        raise TransactionStartSignal(transaction, self.op_code, s)

    @StateTransition(is_state_mutation_instruction=True, increment_pc=False)
    def create_(self, s: GlobalState) -> List[GlobalState]:
        value, mem_offset, mem_size = s.mstate.pop(3)
        return self._create(s, value, mem_offset, mem_size, salt=None)

    @StateTransition(is_state_mutation_instruction=True, increment_pc=False)
    def create2_(self, s: GlobalState) -> List[GlobalState]:
        value, mem_offset, mem_size, salt = s.mstate.pop(4)
        return self._create(s, value, mem_offset, mem_size, salt=salt)

    @StateTransition(increment_pc=False)
    def create_post(self, s: GlobalState) -> List[GlobalState]:
        return self._handle_create_post(s)

    @StateTransition(increment_pc=False)
    def create2_post(self, s: GlobalState) -> List[GlobalState]:
        return self._handle_create_post(s)

    def _handle_create_post(self, s: GlobalState) -> List[GlobalState]:
        transaction, return_global_state = s.transaction_stack[-1]
        return_data = transaction.return_data
        if return_data is not None and hasattr(return_data, "address"):
            s.mstate.stack.append(return_data.address)
        else:
            s.mstate.stack.append(symbol_factory.BitVecVal(0, 256))
        s.mstate.pc += 1
        return [s]

    @staticmethod
    def _write_symbolic_returndata(s: GlobalState, memory_out_offset,
                                   memory_out_size) -> None:
        """An un-executable call still RETURNS unknown data: fresh symbolic
        bytes land in the memory-out window (when concrete) and
        last_return_data gets a symbolic size — without this,
        RETURNDATASIZE reads 0 after every unresolved call and solc's
        `returndatasize < 32` guards revert every path (reference
        instructions.py:1971 _write_symbolic_returndata)."""
        try:
            offset = get_concrete_int(memory_out_offset)
            size = get_concrete_int(memory_out_size)
        except TypeError:
            return
        return_bytes = [s.new_bitvec(f"call_output_var({offset + i})_"
                                     f"{s.mstate.pc}", 8)
                        for i in range(size)]
        return_data_size = s.new_bitvec("returndatasize", 256)
        if size:
            s.mstate.mem_extend(offset, size)
            for i in range(size):
                s.mstate.memory[offset + i] = If(
                    symbol_factory.BitVecVal(i, 256) <= return_data_size,
                    return_bytes[i], s.mstate.memory[offset + i])
        s.last_return_data = ReturnData(return_bytes, return_data_size)

    def _call_family(self, s: GlobalState, with_value: bool,
                     static: bool = False, delegate: bool = False,
                     callcode: bool = False) -> List[GlobalState]:
        instruction = s.get_current_instruction()
        (callee_address, callee_account, call_data, value, gas,
         memory_out_offset, memory_out_size) = get_call_parameters(
            s, self.dynamic_loader, with_value)

        if s.environment.static and with_value and not (
                value.raw.is_const and value.value == 0):
            raise WriteProtection("CALL with value inside static context")

        # precompiles execute in-place
        native_result = native_call(s, callee_address, call_data,
                                    memory_out_offset, memory_out_size)
        if native_result is not None:
            for state in native_result:
                state.mstate.pc += 1
            return native_result

        # hevm/forge cheat addresses: modeled as unconditional success
        # (core/cheat_code.py; reference call.py routes these before any
        # account resolution)
        if isinstance(callee_address, str) and \
                hevm_cheat_code.is_cheat_address(callee_address):
            handle_cheat_codes(s, callee_address, call_data,
                               memory_out_offset, memory_out_size)
            s.mstate.pc += 1
            return [s]

        if callee_account is None or (isinstance(callee_address, BitVec)
                                      and not callee_address.raw.is_const):
            # unresolvable target: symbolic retval + retdata
            log.debug("unresolvable callee %s; returning symbolic data",
                      callee_address)
            retval = s.new_bitvec(f"retval_{instruction['address']}", 256)
            s.mstate.stack.append(retval)
            if with_value:
                # get_callee_address renders concrete targets as hex STRINGS
                # (call.py:56,71); the balance array indexes by BitVec
                receiver = callee_address
                if isinstance(receiver, str):
                    receiver = symbol_factory.BitVecVal(int(receiver, 16),
                                                        256)
                transfer_ether(s, s.environment.address, receiver, value)
            s.world_state.constraints.append(Or(retval == 1, retval == 0))
            self._write_symbolic_returndata(s, memory_out_offset,
                                            memory_out_size)
            s.mstate.pc += 1
            return [s]

        if callee_account is not None and callee_account.code.bytecode == "":
            # EOA target: value transfer + success
            log.debug("EOA callee; pushing success")
            if with_value:
                transfer_ether(s, s.environment.address, callee_account.address, value)
            s.mstate.stack.append(symbol_factory.BitVecVal(1, 256))
            self._write_symbolic_returndata(s, memory_out_offset,
                                            memory_out_size)
            s.mstate.pc += 1
            return [s]

        if delegate:
            environment_account = s.environment.active_account
            sender = s.environment.sender
            callvalue = s.environment.callvalue
            code = callee_account.code
            callee = environment_account
        elif callcode:
            sender = s.environment.address
            callvalue = value
            code = callee_account.code
            callee = s.environment.active_account
        else:
            sender = s.environment.address
            callvalue = value
            code = callee_account.code
            callee = callee_account

        transaction = MessageCallTransaction(
            world_state=s.world_state,
            gas_price=s.environment.gasprice,
            gas_limit=s.mstate.gas_limit,
            origin=s.environment.origin,
            caller=sender,
            callee_account=callee,
            code=code,
            call_data=call_data,
            call_value=callvalue,
            static=static or s.environment.static,
        )
        # stash the retdata window for the post-handler
        transaction._memory_out_offset = memory_out_offset
        transaction._memory_out_size = memory_out_size
        raise TransactionStartSignal(transaction, self.op_code, s)

    @StateTransition(increment_pc=False)
    def call_(self, s: GlobalState) -> List[GlobalState]:
        return self._call_family(s, with_value=True)

    @StateTransition(increment_pc=False)
    def callcode_(self, s: GlobalState) -> List[GlobalState]:
        return self._call_family(s, with_value=True, callcode=True)

    @StateTransition(increment_pc=False)
    def delegatecall_(self, s: GlobalState) -> List[GlobalState]:
        return self._call_family(s, with_value=False, delegate=True)

    @StateTransition(increment_pc=False)
    def staticcall_(self, s: GlobalState) -> List[GlobalState]:
        return self._call_family(s, with_value=False, static=True)

    @StateTransition(increment_pc=False)
    def _call_post(self, s: GlobalState) -> List[GlobalState]:
        transaction, return_global_state = s.transaction_stack[-1]
        instruction = s.get_current_instruction()
        return_data = transaction.return_data

        retval = s.new_bitvec(f"retval_{instruction['address']}", 256)
        s.mstate.stack.append(retval)
        if return_data is None:
            s.world_state.constraints.append(retval == 0)
            s.mstate.pc += 1
            return [s]
        s.world_state.constraints.append(retval == 1)
        # write returned bytes into caller memory window
        memory_out_offset = getattr(transaction, "_memory_out_offset", None)
        memory_out_size = getattr(transaction, "_memory_out_size", None)
        if (memory_out_offset is not None and memory_out_offset.raw.is_const
                and memory_out_size is not None and memory_out_size.raw.is_const
                and isinstance(return_data, ReturnData)):
            offset = memory_out_offset.value
            available = len(return_data.return_data)
            out_size = min(memory_out_size.value, available)
            s.mstate.mem_extend(offset, out_size)
            for i in range(out_size):
                value = return_data.return_data[i]
                s.mstate.memory[offset + i] = value if isinstance(value, BitVec) \
                    else symbol_factory.BitVecVal(value, 8)
        s.mstate.pc += 1
        return [s]

    call_post = _call_post
    callcode_post = _call_post
    delegatecall_post = _call_post
    staticcall_post = _call_post

    # == halting ===================================================================
    @StateTransition(increment_pc=False)
    def return_(self, s: GlobalState) -> List[GlobalState]:
        offset, length = s.mstate.pop(2)
        return_data = self._read_return_data(s, offset, length)
        s.current_transaction.end(s, return_data)
        return []  # unreachable: end raises

    @StateTransition(increment_pc=False)
    def revert_(self, s: GlobalState) -> List[GlobalState]:
        offset, length = s.mstate.pop(2)
        return_data = self._read_return_data(s, offset, length)
        s.current_transaction.end(s, return_data, revert=True)
        return []

    def _read_return_data(self, s: GlobalState, offset, length) -> ReturnData:
        if offset.raw.is_const and length.raw.is_const:
            size = length.value
            s.mstate.mem_extend(offset.value, size)
            data = [s.mstate.memory[offset.value + i] for i in range(size)]
            return ReturnData(data, size)
        return ReturnData([s.new_bitvec("return_data", 8)
                           for _ in range(4)], s.new_bitvec("return_size", 256))

    @StateTransition(increment_pc=False)
    def stop_(self, s: GlobalState) -> List[GlobalState]:
        s.current_transaction.end(s, ReturnData([], 0))
        return []

    @StateTransition(is_state_mutation_instruction=True, increment_pc=False)
    def selfdestruct_(self, s: GlobalState) -> List[GlobalState]:
        beneficiary = s.mstate.pop()
        transfer_ether(s, s.environment.address, beneficiary,
                       s.world_state.balances[s.environment.address])
        s.environment.active_account = copy(s.environment.active_account)
        s.environment.active_account.deleted = True
        s.world_state.accounts[
            s.environment.active_account.address.raw.value] = s.environment.active_account
        s.current_transaction.end(s, ReturnData([], 0))
        return []

    @StateTransition(increment_pc=False)
    def invalid_(self, s: GlobalState) -> List[GlobalState]:
        raise InvalidInstruction(f"INVALID opcode at pc {s.mstate.pc}")
