"""Accounts and storage (API parity: mythril/laser/ethereum/state/account.py —
Storage:18 with concrete-K vs symbolic-Array backing + on-chain lazy fault-in :43-76,
Account:106).

The port's copy of mythril_tpu/core/state/account.py."""

from __future__ import annotations

from typing import Any, Dict, Optional, Set, Union

from ...smt import Array, BitVec, K, simplify, symbol_factory
from ...frontends.disassembler import Disassembly


class Storage:
    """Contract storage: a symbolic Array base (or zero-K for fresh contracts) plus
    tracked key sets; concrete on-chain values fault in through the DynLoader."""

    def __init__(self, concrete: bool = False, address: Optional[BitVec] = None,
                 dynamic_loader=None, copy_call=False):
        if copy_call:
            return
        self.concrete = concrete
        if concrete:
            self._standard_storage = K(256, 256, 0)
        else:
            suffix = address.raw.value if address is not None and address.raw.is_const else id(self)
            self._standard_storage = Array(f"Storage[{suffix}]", 256, 256)
        self.address = address
        self.dynld = dynamic_loader
        self.storage_keys_loaded: Set[int] = set()
        self.keys_set: Set = set()  # written keys (dependency pruner reads this)
        self.keys_get: Set = set()  # read keys
        self.printable_storage: Dict = {}

    def __getitem__(self, item: BitVec) -> BitVec:
        item = simplify(item)
        if (self.address is not None and self.address.raw.is_const
                and self.address.raw.value != 0 and item.raw.is_const
                and self.dynld is not None
                and item.raw.value not in self.storage_keys_loaded):
            try:
                value = int(self.dynld.read_storage(
                    contract_address="0x{:040x}".format(self.address.raw.value),
                    index=item.raw.value), 16)
                self._standard_storage[item] = symbol_factory.BitVecVal(value, 256)
                self.storage_keys_loaded.add(item.raw.value)
            except ValueError:
                pass
        self.keys_get.add(item)
        return simplify(self._standard_storage[item])

    def __setitem__(self, key: BitVec, value: Any) -> None:
        key = simplify(key)
        if isinstance(value, int):
            value = symbol_factory.BitVecVal(value, 256)
        self.keys_set.add(key)
        self.printable_storage[key] = value
        self._standard_storage[key] = value
        if key.raw.is_const:
            self.storage_keys_loaded.add(key.raw.value)

    def __deepcopy__(self, memo):
        clone = Storage(copy_call=True)
        clone.concrete = self.concrete
        clone.address = self.address
        clone.dynld = self.dynld
        # Array wrapper is mutable (raw swaps on store): clone the wrapper
        base = self._standard_storage
        clone._standard_storage = type(base).__new__(type(base))
        from ...smt.expression import Expression

        Expression.__init__(clone._standard_storage, base.raw, base.annotations)
        clone.storage_keys_loaded = set(self.storage_keys_loaded)
        clone.keys_set = set(self.keys_set)
        clone.keys_get = set(self.keys_get)
        clone.printable_storage = dict(self.printable_storage)
        return clone

    def __copy__(self):
        return self.__deepcopy__({})

    def __str__(self) -> str:
        return str(self.printable_storage)


class Account:
    def __init__(self, address: Union[BitVec, str, int], code: Optional[Disassembly] = None,
                 contract_name: Optional[str] = None, balances: Optional[Array] = None,
                 concrete_storage: bool = False, dynamic_loader=None, nonce: int = 0):
        if isinstance(address, str):
            address = symbol_factory.BitVecVal(int(address, 16), 256)
        elif isinstance(address, int):
            address = symbol_factory.BitVecVal(address, 256)
        self.address = address
        self.code = code or Disassembly("")
        self.contract_name = contract_name or "Unknown"
        self.nonce = nonce
        self.deleted = False
        self.storage = Storage(concrete_storage, address=address,
                               dynamic_loader=dynamic_loader)
        self._balances = balances

    def balance(self):
        # a method, not an instance lambda: accounts must pickle for host
        # checkpoints (callers treat .balance as a callable, reference
        # account.py keeps the same shape)
        return (self._balances[self.address]
                if self._balances is not None else None)

    def serialised_code(self) -> str:
        return self.code.bytecode

    def set_balance(self, balance: Union[int, BitVec]) -> None:
        if isinstance(balance, int):
            balance = symbol_factory.BitVecVal(balance, 256)
        assert self._balances is not None
        self._balances[self.address] = balance

    def add_balance(self, balance: Union[int, BitVec]) -> None:
        assert self._balances is not None
        self._balances[self.address] = self._balances[self.address] + balance

    @property
    def as_dict(self) -> Dict:
        return {
            "nonce": self.nonce,
            "code": self.code.bytecode,
            "balance": str(self.balance()) if self._balances is not None else "0",
            "storage": str(self.storage),
        }

    def __copy__(self, memo=None):
        import copy as copy_module

        new_account = Account(address=self.address, code=self.code,
                              contract_name=self.contract_name,
                              balances=self._balances, nonce=self.nonce)
        new_account.storage = copy_module.deepcopy(self.storage)
        new_account.code = self.code
        new_account.deleted = self.deleted
        return new_account

    __deepcopy__ = __copy__

    def __str__(self):
        return str(self.as_dict)
