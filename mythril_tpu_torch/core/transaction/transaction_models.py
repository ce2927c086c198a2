"""Transaction models and engine signals (API parity:
mythril/laser/ethereum/transaction/transaction_models.py — TxIdManager:21,
TransactionStartSignal/EndSignal:39-58, BaseTransaction:61 incl. value-transfer
constraints :127-147, MessageCallTransaction:171, ContractCreationTransaction:206).

The reference drives inter-contract calls with Python exceptions; the TPU lockstep
interpreter replaces that idiom with explicit frame-stack tensors (SURVEY.md §7 hard
part 7) — these exception classes remain the host-engine/oracle control flow.

The port's copy of mythril_tpu/core/transaction/transaction_models.py."""

from __future__ import annotations

import copy as copy_module
from typing import Optional, Union

from ...exceptions import MythrilTpuBaseException
from ...smt import BitVec, UGE, symbol_factory
from ..state.account import Account
from ..state.calldata import BaseCalldata, ConcreteCalldata, SymbolicCalldata
from ..state.constraints import Constraints
from ..state.environment import Environment
from ..state.global_state import GlobalState
from ..state.machine_state import MachineState
from ..state.world_state import WorldState


class TxIdManager:
    def __init__(self):
        self._next_transaction_id = 0

    def get_next_tx_id(self) -> str:
        self._next_transaction_id += 1
        return str(self._next_transaction_id)

    def restart_counter(self) -> None:
        self._next_transaction_id = 0

    def set_counter(self, value: int) -> None:
        self._next_transaction_id = value


tx_id_manager = TxIdManager()


def get_next_transaction_id() -> str:
    return tx_id_manager.get_next_tx_id()


class TransactionStartSignal(MythrilTpuBaseException):
    """Raised by CALL-family/CREATE handlers to start a nested transaction."""

    def __init__(self, transaction: "BaseTransaction", op_code: str,
                 global_state: GlobalState):
        self.transaction = transaction
        self.op_code = op_code
        self.global_state = global_state


class TransactionEndSignal(MythrilTpuBaseException):
    """Raised on RETURN/STOP/REVERT/SELFDESTRUCT/exception path termination."""

    def __init__(self, global_state: GlobalState, revert: bool = False):
        self.global_state = global_state
        self.revert = revert


class BaseTransaction:
    def __init__(self, world_state: WorldState, callee_account: Optional[Account] = None,
                 caller: Optional[BitVec] = None, call_data=None,
                 identifier: Optional[str] = None, gas_price=None, gas_limit=None,
                 origin=None, code=None, call_value=None, init_call_data: bool = True,
                 static: bool = False, base_fee=None):
        assert isinstance(world_state, WorldState)
        self.world_state = world_state
        self.id = identifier or get_next_transaction_id()

        self.gas_price = (gas_price if gas_price is not None
                          else symbol_factory.BitVecSym(f"{self.id}_gasprice", 256))
        self.base_fee = (base_fee if base_fee is not None
                         else symbol_factory.BitVecSym(f"{self.id}_basefee", 256))
        self.gas_limit = gas_limit
        self.origin = (origin if origin is not None
                       else symbol_factory.BitVecSym(f"{self.id}_origin", 256))
        self.code = code
        self.caller = caller
        self.callee_account = callee_account
        if call_data is None and init_call_data:
            self.call_data: BaseCalldata = SymbolicCalldata(self.id)
        else:
            self.call_data = call_data if isinstance(call_data, BaseCalldata) \
                else ConcreteCalldata(self.id, call_data or [])
        self.call_value = (call_value if call_value is not None
                           else symbol_factory.BitVecSym(f"{self.id}_callvalue", 256))
        self.static = static
        self.return_data: Optional[object] = None

    def initial_global_state_from_environment(self, environment: Environment,
                                              active_function: str) -> GlobalState:
        global_state = GlobalState(self.world_state, environment, None,
                                   MachineState(gas_limit=self.gas_limit or 8000000))
        global_state.environment.active_function_name = active_function
        # every started tx joins the world state's witness sequence (reference
        # transaction_models.py:127; shared list would leak across forks, so rebind)
        self.world_state.transaction_sequence = (
            list(self.world_state.transaction_sequence) + [self])

        sender = environment.sender
        receiver = environment.active_account.address
        value = (environment.callvalue
                 if isinstance(environment.callvalue, BitVec)
                 else symbol_factory.BitVecVal(environment.callvalue, 256))

        # value transfer with balance-sufficiency constraint (reference :127-147)
        global_state.world_state.constraints.append(
            UGE(global_state.world_state.balances[sender], value))
        global_state.world_state.balances[receiver] = (
            global_state.world_state.balances[receiver] + value)
        global_state.world_state.balances[sender] = (
            global_state.world_state.balances[sender] - value)
        return global_state

    def initial_global_state(self) -> GlobalState:
        raise NotImplementedError

    def end(self, global_state: GlobalState, return_data=None,
            revert: bool = False) -> None:
        self.return_data = return_data
        raise TransactionEndSignal(global_state, revert)

    def __str__(self) -> str:
        return (f"{self.__class__.__name__} {self.id} from "
                f"{self.caller} to {self.callee_account}")


class MessageCallTransaction(BaseTransaction):
    """Transaction executing runtime code of an existing account."""

    def initial_global_state(self) -> GlobalState:
        environment = Environment(
            active_account=self.callee_account,
            sender=self.caller,
            calldata=self.call_data,
            gasprice=self.gas_price,
            callvalue=self.call_value,
            origin=self.origin,
            basefee=self.base_fee,
            code=self.code or self.callee_account.code,
            static=self.static,
        )
        return super().initial_global_state_from_environment(
            environment, active_function="fallback")


class ContractCreationTransaction(BaseTransaction):
    """Transaction deploying new contract code (executes init code)."""

    def __init__(self, world_state: WorldState, caller=None, call_data=None,
                 identifier=None, gas_price=None, gas_limit=None, origin=None,
                 code=None, call_value=None, contract_name=None,
                 contract_address=None, base_fee=None):
        self.prev_world_state = copy_module.deepcopy(world_state)
        contract_address = (contract_address
                            if isinstance(contract_address, int) else None)
        callee_account = world_state.create_account(
            0, concrete_storage=True, creator=(caller.raw.value
                                               if caller is not None and caller.raw.is_const
                                               else None),
            address=contract_address)
        callee_account.contract_name = contract_name or callee_account.contract_name
        super().__init__(world_state=world_state, callee_account=callee_account,
                         caller=caller, call_data=call_data, identifier=identifier,
                         gas_price=gas_price, gas_limit=gas_limit, origin=origin,
                         code=code, call_value=call_value, init_call_data=False,
                         base_fee=base_fee)

    def initial_global_state(self) -> GlobalState:
        environment = Environment(
            active_account=self.callee_account,
            sender=self.caller,
            calldata=self.call_data,
            gasprice=self.gas_price,
            callvalue=self.call_value,
            origin=self.origin,
            basefee=self.base_fee,
            code=self.code,  # init code
        )
        return super().initial_global_state_from_environment(
            environment, active_function="constructor")

    def end(self, global_state: GlobalState, return_data=None,
            revert: bool = False):
        from ...frontends.disassembler import Disassembly

        if return_data is None or not return_data.return_data:
            self.return_data = None
            raise TransactionEndSignal(global_state, revert)
        # SYMBOLIC bytes in the returned runtime (immutables initialized
        # from constructor arguments) deploy as symbolic PUSH immediates:
        # the code skeleton disassembles from a zero-patched image and any
        # PUSH whose immediate window covers a symbolic position carries
        # the original byte expressions (the reference keeps the whole
        # bytecode as an expression tuple, transaction_models.py:73-75 +
        # asm.disassemble; this is the same capability scoped to push
        # arguments, where immutables land)
        raw = []
        symbolic_positions = {}
        for position, item in enumerate(return_data.return_data):
            if isinstance(item, int):
                raw.append(item)
            elif isinstance(item, BitVec) and item.raw.is_const:
                raw.append(item.value)
            else:
                raw.append(0)
                symbolic_positions[position] = item
        disassembly = Disassembly(bytes(raw).hex())
        if symbolic_positions:
            unpatched = self._patch_symbolic_immediates(
                disassembly, raw, symbolic_positions)
            if unpatched:
                # a symbolic byte at an OPCODE position would deploy a
                # different instruction stream than any real deployment —
                # refuse, as the pre-round-5 code did for any symbolic byte
                self.return_data = None
                raise TransactionEndSignal(global_state, revert)
        global_state.environment.active_account.code = disassembly
        self.return_data = ReturnAddress(global_state.environment.active_account.address)
        assert global_state.environment.active_account.code.instruction_list != []
        raise TransactionEndSignal(global_state, revert)

    @staticmethod
    def _patch_symbolic_immediates(disassembly, raw, symbolic_positions):
        """Returns the set of symbolic positions NOT covered by any PUSH
        immediate window (i.e. symbolic opcodes) — the caller refuses the
        deployment when it is non-empty."""
        from ...smt import Concat, symbol_factory

        covered = set()
        for instruction in disassembly.instruction_list:
            op_code = instruction.op_code
            if not op_code.startswith("PUSH") or op_code == "PUSH0":
                continue
            width = int(op_code[4:])
            start = instruction.address + 1
            window = range(start, start + width)
            if not any(p in symbolic_positions for p in window):
                continue
            parts = []
            for p in window:
                expression = symbolic_positions.get(p)
                if expression is None:
                    byte = raw[p] if p < len(raw) else 0
                    expression = symbol_factory.BitVecVal(byte, 8)
                else:
                    covered.add(p)
                parts.append(expression)
            instruction.argument = (Concat(*parts) if len(parts) > 1
                                    else parts[0])
        return set(symbolic_positions) - covered


class ReturnAddress:
    """Return payload of a creation tx: the deployed address."""

    def __init__(self, address):
        self.address = address
