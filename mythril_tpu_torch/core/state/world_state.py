"""World state sigma (API parity: mythril/laser/ethereum/state/world_state.py:19):
accounts, SMT balances array, path constraints, transaction sequence, annotations,
on-chain fault-in via accounts_exist_or_load.

The port's copy of mythril_tpu/core/state/world_state.py."""

from __future__ import annotations

import copy as copy_module
from typing import Dict, List, Optional, Union

from ...smt import Array, BitVec, symbol_factory
from ...utils.helpers import generate_contract_address
from .account import Account
from .annotation import StateAnnotation
from .constraints import Constraints
from .transient_storage import TransientStorage


class WorldState:
    next_transaction_id = 0

    def __init__(self, transaction_sequence=None, annotations: Optional[List[StateAnnotation]] = None,
                 constraints: Optional[Constraints] = None):
        self._accounts: Dict[int, Account] = {}
        self.balances = Array("balance", 256, 256)
        self.starting_balances = copy_module.deepcopy(self.balances)
        self.constraints = constraints or Constraints()
        self.transaction_sequence = transaction_sequence or []
        self._annotations = annotations or []
        self.transient_storage = TransientStorage()
        self.node = None  # statespace node that produced this world state

    @property
    def accounts(self) -> Dict[int, Account]:
        return self._accounts

    def create_account(self, balance=0, address: Optional[int] = None, concrete_storage=False,
                       dynamic_loader=None, creator: Optional[int] = None,
                       code=None, nonce: int = 0) -> Account:
        if address is None:
            if creator is not None:
                address = generate_contract_address(creator,
                                                    self.accounts[creator].nonce
                                                    if creator in self.accounts else 0)
            else:
                address = self._generate_new_address()
        new_account = Account(address=address, balances=self.balances,
                              concrete_storage=concrete_storage,
                              dynamic_loader=dynamic_loader, code=code, nonce=nonce)
        if balance is not None:
            new_account.set_balance(symbol_factory.BitVecVal(balance, 256)
                                    if isinstance(balance, int) else balance)
        self.put_account(new_account)
        return new_account

    def _generate_new_address(self) -> int:
        base = 0x0ACE000000000000000000000000000000000000
        candidate = base + len(self._accounts)
        while candidate in self._accounts:
            candidate += 1
        return candidate

    def put_account(self, account: Account) -> None:
        assert account.address.raw.is_const
        self._accounts[account.address.raw.value] = account
        account._balances = self.balances

    def accounts_exist_or_load(self, address: Union[str, int, BitVec],
                               dynamic_loader=None) -> Account:
        if isinstance(address, str):
            address = int(address, 16)
        if isinstance(address, BitVec):
            if address.raw.is_const:
                address = address.raw.value
            else:
                return self.create_account(address=None)
        if address in self._accounts:
            return self._accounts[address]
        # fault in from chain if a loader is present
        code = None
        balance = 0
        if dynamic_loader is not None:
            try:
                code_result = dynamic_loader.dynld("0x{:040x}".format(address))
                if code_result is not None:
                    code = code_result
            except Exception:
                pass
            try:
                balance = int(dynamic_loader.read_balance("0x{:040x}".format(address)), 16)
            except Exception:
                balance = 0
        account = self.create_account(balance=balance, address=address,
                                      dynamic_loader=dynamic_loader, code=code)
        return account

    def __getitem__(self, item: BitVec) -> Account:
        return self._accounts[item.raw.value if isinstance(item, BitVec) else item]

    # -- annotations ---------------------------------------------------------------
    @property
    def annotations(self) -> List[StateAnnotation]:
        return self._annotations

    def annotate(self, annotation: StateAnnotation) -> None:
        self._annotations.append(annotation)

    def get_annotations(self, annotation_type: type):
        return filter(lambda a: isinstance(a, annotation_type), self._annotations)

    # -- copying -------------------------------------------------------------------
    def __copy__(self) -> "WorldState":
        new_annotations = [copy_module.copy(a) for a in self._annotations]
        new_world_state = WorldState(
            transaction_sequence=list(self.transaction_sequence),
            annotations=new_annotations)
        new_world_state.balances = copy_module.deepcopy(self.balances)
        new_world_state.starting_balances = copy_module.deepcopy(self.starting_balances)
        for address, account in self._accounts.items():
            cloned = copy_module.copy(account)
            cloned._balances = new_world_state.balances
            new_world_state._accounts[address] = cloned
        new_world_state.constraints = self.constraints.copy()
        new_world_state.transient_storage = copy_module.deepcopy(self.transient_storage)
        new_world_state.node = self.node
        return new_world_state

    def __deepcopy__(self, memo) -> "WorldState":
        return self.__copy__()
