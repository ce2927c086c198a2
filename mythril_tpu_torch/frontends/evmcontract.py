"""EVMContract: bytecode container (capability parity:
mythril/ethereum/evmcontract.py:14 — creation + runtime code, disassembly
properties, `matches_expression` code search).

The port's own copy of the JAX package's module; its `sha3` is the JAX
package's helper over the port's pure-Python Keccak."""

from __future__ import annotations

import re

from ..utils.keccak import keccak256_py
from .disassembler import Disassembly


def sha3(data: bytes | str) -> bytes:
    if isinstance(data, str):
        data = data.encode()
    return keccak256_py(data)


def _sha3_hex(data) -> str:
    if isinstance(data, str):
        data = bytes.fromhex(data[2:] if data.startswith("0x") else data or "")
    return sha3(data).hex()


class EVMContract:
    def __init__(self, code: str = "", creation_code: str = "",
                 name: str = "Unknown", enable_online_lookup: bool = False):
        self.creation_code = creation_code or ""
        self.name = name
        self.code = code or ""
        self.enable_online_lookup = enable_online_lookup

    @property
    def bytecode_hash(self) -> str:
        return "0x" + _sha3_hex(self.code)

    @property
    def creation_bytecode_hash(self) -> str:
        return "0x" + _sha3_hex(self.creation_code)

    @property
    def disassembly(self) -> Disassembly:
        # cached: per-contract static analyses (cfa, taint summary) memoize
        # on the Disassembly instance, and the serve daemon pre-seeds
        # persisted summaries onto it before the engine runs
        if getattr(self, "_disassembly", None) is None:
            self._disassembly = Disassembly(self.code)
        return self._disassembly

    @property
    def creation_disassembly(self) -> Disassembly:
        return Disassembly(self.creation_code)

    def as_dict(self) -> dict:
        return {"name": self.name, "code": self.code,
                "creation_code": self.creation_code}

    def get_easm(self) -> str:
        return self.disassembly.get_easm()

    def get_creation_easm(self) -> str:
        return self.creation_disassembly.get_easm()

    def matches_expression(self, expression: str) -> bool:
        """Code-search mini-language (reference evmcontract.py:51):
        `code#PUSH1#` opcode-sequence match and `func#transfer(address)#`
        function-selector match, combinable with `and` / `or`."""
        easm_code = None
        tokens = re.split(r"\s+(and|or)\s+", expression, flags=re.IGNORECASE)
        results = []
        for token in tokens:
            if token.lower() in ("and", "or"):
                results.append(token.lower())
                continue
            code_match = re.match(r"^code#([a-zA-Z0-9\s,\[\]]+)#$", token)
            if code_match:
                if easm_code is None:
                    easm_code = self.get_easm()
                pattern = code_match.group(1).replace(",", "\\n")
                results.append(bool(re.search(pattern, easm_code)))
                continue
            func_match = re.match(r"^func#(.+)#$", token)
            if func_match:
                selector = "0x" + sha3(func_match.group(1)).hex()[:8]
                results.append(selector in self.disassembly.func_hashes)
                continue
            raise ValueError(f"invalid expression term: {token}")
        # left-to-right evaluation
        value = results[0]
        for i in range(1, len(results), 2):
            if results[i] == "and":
                value = value and results[i + 1]
            else:
                value = value or results[i + 1]
        return bool(value)
