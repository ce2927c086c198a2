"""MythrilDisassembler: code loading front door (capability parity:
mythril/mythril/mythril_disassembler.py:43 — load_from_bytecode:103,
load_from_address:134, load_from_solidity:258, load_from_foundry:171,
read-storage helper:345, function-hash helpers).

The port's copy of mythril_tpu/mythril/mythril_disassembler.py."""

from __future__ import annotations

import logging
import re
from typing import List, Optional, Tuple

from ..frontends.evmcontract import EVMContract
from ..frontends.solidity import (SolidityContract, get_contracts_from_file,
                                  get_contracts_from_foundry)
from ..support.loader import DynLoader
from ..utils.helpers import sha3

log = logging.getLogger(__name__)


class MythrilDisassembler:
    def __init__(self, eth=None, solc_version: Optional[str] = None,
                 solc_settings_json: Optional[str] = None,
                 enable_online_lookup: bool = False):
        self.eth = eth
        self.solc_binary = solc_version or "solc"
        self.solc_settings_json = solc_settings_json
        self.enable_online_lookup = enable_online_lookup
        self.contracts: List[EVMContract] = []

    # -- loading ----------------------------------------------------------------------
    @staticmethod
    def _normalize_hex(code: str) -> str:
        code = code.strip()
        if code.startswith("0x"):
            code = code[2:]
        if not re.fullmatch(r"[0-9a-fA-F]*", code):
            raise ValueError("bytecode is not hexadecimal")
        return code

    def load_from_bytecode(self, code: str, bin_runtime: bool = False,
                           address: Optional[str] = None) -> Tuple[str, EVMContract]:
        code = self._normalize_hex(code)
        if bin_runtime:
            contract = EVMContract(
                code=code, name="MAIN",
                enable_online_lookup=self.enable_online_lookup)
        else:
            contract = EVMContract(
                creation_code=code, name="MAIN",
                enable_online_lookup=self.enable_online_lookup)
        self.contracts.append(contract)
        return address or "0x" + "0" * 40, contract

    def load_from_address(self, address: str) -> Tuple[str, EVMContract]:
        if self.eth is None:
            raise ValueError("no RPC client: pass --rpc or configure one")
        code = self.eth.eth_getCode(address)
        if code in (None, "", "0x", "0x0"):
            raise ValueError(f"no contract code at {address}")
        contract = EVMContract(code=code[2:], name=address,
                               enable_online_lookup=self.enable_online_lookup)
        self.contracts.append(contract)
        return address, contract

    def load_from_solidity(self, solidity_files: List[str]
                           ) -> Tuple[str, List[SolidityContract]]:
        contracts: List[SolidityContract] = []
        for file in solidity_files:
            name = None
            if ":" in file and not file.startswith("0x"):
                file, name = file.rsplit(":", 1)
            contracts.extend(get_contracts_from_file(
                file, solc_binary=self.solc_binary,
                solc_settings_json=self.solc_settings_json, name=name))
        self.contracts.extend(contracts)
        return "0x" + "0" * 40, contracts

    def load_from_foundry(self, project_root: str
                          ) -> Tuple[str, List[SolidityContract]]:
        contracts = list(get_contracts_from_foundry(project_root))
        self.contracts.extend(contracts)
        return "0x" + "0" * 40, contracts

    # -- helpers ----------------------------------------------------------------------
    @staticmethod
    def hash_for_function_signature(signature: str) -> str:
        return "0x" + sha3(signature).hex()[:8]

    def get_state_variable_from_storage(self, address: str,
                                        params: Optional[List[str]] = None
                                        ) -> str:
        """read-storage helper (reference mythril_disassembler.py:345):
        params = [position], [position, length] or ["mapping", position, key...]."""
        params = params or ["0"]
        if self.eth is None:
            raise ValueError("no RPC client: pass --rpc or configure one")
        loader = DynLoader(self.eth)
        outtxt = []
        if params[0] == "mapping":
            if len(params) < 3:
                raise ValueError("mapping requires a position and keys")
            position = int(params[1])
            for key in params[2:]:
                slot = int.from_bytes(
                    sha3(int(key).to_bytes(32, "big")
                         + position.to_bytes(32, "big")), "big")
                value = loader.read_storage(address, slot)
                outtxt.append(f"mapping({key}): {value}")
        else:
            position = int(params[0])
            length = int(params[1]) if len(params) > 1 else 1
            for i in range(position, position + length):
                value = loader.read_storage(address, i)
                outtxt.append(f"{i}: {value}")
        return "\n".join(outtxt)
