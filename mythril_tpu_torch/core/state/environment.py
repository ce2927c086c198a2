"""Execution environment for one message call (API parity:
mythril/laser/ethereum/state/environment.py:12).

The port's copy of mythril_tpu/core/state/environment.py."""

from __future__ import annotations

from typing import Optional, Union

from ...smt import BitVec, symbol_factory
from .account import Account
from .calldata import BaseCalldata


class Environment:
    def __init__(self, active_account: Account, sender: BitVec, calldata: BaseCalldata,
                 gasprice: BitVec, callvalue: BitVec, origin: BitVec,
                 basefee: BitVec, chainid: Optional[BitVec] = None,
                 code=None, static: bool = False):
        self.active_account = active_account
        self.address = active_account.address
        self.code = active_account.code if code is None else code
        self.sender = sender
        self.calldata = calldata
        self.gasprice = gasprice
        self.origin = origin
        self.callvalue = callvalue
        self.basefee = basefee
        self.chainid = chainid if chainid is not None else symbol_factory.BitVecVal(1, 256)
        self.static = static
        self.block_number: Optional[BitVec] = None

    @property
    def as_dict(self) -> dict:
        return {
            "active_account": str(self.active_account.address),
            "sender": str(self.sender),
            "callvalue": str(self.callvalue),
            "gasprice": str(self.gasprice),
            "static": self.static,
        }

    def __str__(self):
        return str(self.as_dict)
