"""DynLoader: on-chain world-state fault-in (capability parity:
mythril/support/loader.py:15 — lru-cached read_storage / read_balance / dynld
that disassembles on-chain code). Consumed by core/call.py:57-66 and
core/state/account.py:38-44.

The port's copy of mythril_tpu/support/loader.py."""

from __future__ import annotations

import functools
import logging
from typing import Optional

from ..frontends.disassembler import Disassembly

log = logging.getLogger(__name__)


class DynLoader:
    def __init__(self, eth, active: bool = True):
        """eth: an EthJsonRpc-compatible client (ethereum/rpc.py)."""
        self.eth = eth
        self.active = active

    @functools.lru_cache(maxsize=2 ** 10)
    def read_storage(self, contract_address: str, index: int) -> str:
        if not self.active:
            raise ValueError("loader is disabled")
        if self.eth is None:
            raise ValueError("no RPC client configured")
        return self.eth.eth_getStorageAt(contract_address, index)

    @functools.lru_cache(maxsize=2 ** 10)
    def read_balance(self, address: str) -> int:
        if not self.active:
            raise ValueError("loader is disabled")
        if self.eth is None:
            raise ValueError("no RPC client configured")
        return self.eth.eth_getBalance(address)

    @functools.lru_cache(maxsize=2 ** 6)
    def dynld(self, dependency_address: str) -> Optional[Disassembly]:
        """Fetch and disassemble on-chain code at `dependency_address`."""
        if not self.active:
            return None
        if self.eth is None:
            raise ValueError("no RPC client configured")
        log.debug("fetching on-chain code for %s", dependency_address)
        code = self.eth.eth_getCode(dependency_address)
        if code in (None, "", "0x", "0x0"):
            return None
        return Disassembly(code[2:] if code.startswith("0x") else code)
