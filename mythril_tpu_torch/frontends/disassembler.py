"""EVM bytecode disassembler.

Capability parity: mythril/disassembler/asm.py (EvmInstruction, disassemble,
find_op_code_sequence) and mythril/disassembler/disassembly.py (Disassembly with
function-selector table recovery from the PUSHn;EQ dispatch pattern,
disassembly.py:42-54). Implementation is fresh: a single linear scan that also
precomputes the JUMPDEST set and the dense arrays the TPU lockstep interpreter consumes.

The port's own copy of the JAX package's module, over the port's opcode table.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Generator, List, Optional

from ..ops.opcodes import OPCODES, ADDRESS, opcode_name, push_width


@dataclass
class EvmInstruction:
    """One decoded instruction: absolute byte address, mnemonic, optional immediate."""

    address: int
    op_code: str
    argument: Optional[str] = None  # '0x..' hex immediate for PUSHn

    def to_dict(self) -> dict:
        result = {"address": self.address, "opcode": self.op_code}
        if self.argument is not None:
            result["argument"] = self.argument
        return result


import re as _re

# solc unlinked-library placeholders, both styles, are exactly 40 chars and must be
# zero-FILLED (not stripped) so byte offsets stay aligned:
#   0.5+:  __$<34 hex>$__      pre-0.5: __<36 chars of name/padding>__
_PLACEHOLDER_RE = _re.compile(r"__\$.{34}\$__|__.{36}__")


def _normalize(code: str | bytes) -> bytes:
    if isinstance(code, (bytes, bytearray)):
        return bytes(code)
    code = code.strip()
    if code.startswith("0x"):
        code = code[2:]
    if "_" in code:
        code = _PLACEHOLDER_RE.sub("0" * 40, code)
        code = code.replace("_", "0")  # stray underscores, length-preserving
    if len(code) % 2:
        code = code[:-1]  # tolerate trailing half-byte as the reference tooling does
    try:
        return bytes.fromhex(code)
    except ValueError:
        cleaned = "".join(ch for ch in code if ch in "0123456789abcdefABCDEF")
        return bytes.fromhex(cleaned if len(cleaned) % 2 == 0 else cleaned[:-1])


def disassemble(bytecode: str | bytes) -> List[EvmInstruction]:
    """Linear-sweep disassembly; PUSH immediates that overrun the code are truncated."""
    code = _normalize(bytecode)
    instructions: List[EvmInstruction] = []
    pc = 0
    length = len(code)
    while pc < length:
        byte = code[pc]
        name = opcode_name(byte)
        width = push_width(name) if name.startswith("PUSH") else 0
        if width:
            immediate = code[pc + 1:pc + 1 + width]
            instructions.append(EvmInstruction(pc, name, "0x" + immediate.hex()))
            pc += 1 + width
        else:
            instructions.append(EvmInstruction(pc, name))
            pc += 1
    return instructions


def find_op_code_sequence(pattern: List[List[str]],
                          instruction_list: List[EvmInstruction]) -> Generator[int, None, None]:
    """Yield indices where `pattern` matches; each pattern element is a list of
    acceptable mnemonics for that position (reference: disassembler/asm.py:66)."""
    for start in range(len(instruction_list) - len(pattern) + 1):
        if all(instruction_list[start + offset].op_code in alternatives
               for offset, alternatives in enumerate(pattern)):
            yield start


@dataclass
class Disassembly:
    """Decoded contract bytecode plus recovered metadata.

    Attributes mirror the reference surface (disassembler/disassembly.py:9): raw
    bytecode, instruction list, `func_hashes` / `function_name_to_address` /
    `address_to_function_name` recovered from the dispatcher pattern
    ``PUSH4 <selector>; EQ; PUSH2 <target>; JUMPI`` (and its DUP1/SWAP variants).
    """

    bytecode: str
    enable_online_lookup: Optional[bool] = None
    instruction_list: List[EvmInstruction] = field(default_factory=list)
    func_hashes: List[str] = field(default_factory=list)
    function_name_to_address: Dict[str, int] = field(default_factory=dict)
    address_to_function_name: Dict[int, str] = field(default_factory=dict)
    function_name_to_hash: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self):
        code = _normalize(self.bytecode)
        self.raw_code: bytes = code
        self.bytecode = code.hex()
        self.instruction_list = disassemble(code)
        self._address_to_index = {ins.address: idx
                                  for idx, ins in enumerate(self.instruction_list)}
        self.valid_jump_destinations = {ins.address for ins in self.instruction_list
                                        if ins.op_code == "JUMPDEST"}
        self._recover_selector_table()

    # -- function selector recovery ------------------------------------------------
    # (pattern, selector_offset, inverted): selector pushes are PUSH1..PUSH4 (the solc
    # optimizer shortens selectors with leading zero bytes). When the comparison is
    # negated with ISZERO, JUMPI jumps on selector MISmatch, so the function entry is
    # the fall-through after JUMPI.
    _SELECTOR_PUSH = ["PUSH1", "PUSH2", "PUSH3", "PUSH4"]
    _TARGET_PUSH = ["PUSH1", "PUSH2", "PUSH3", "PUSH4"]
    _DISPATCH_PATTERNS = [
        ([_SELECTOR_PUSH, ["EQ"], _TARGET_PUSH, ["JUMPI"]], 0, False),
        ([["DUP1"], _SELECTOR_PUSH, ["EQ"], _TARGET_PUSH, ["JUMPI"]], 1, False),
        ([_SELECTOR_PUSH, ["EQ"], ["ISZERO"], _TARGET_PUSH, ["JUMPI"]], 0, True),
    ]

    def _recover_selector_table(self) -> None:
        from ..support.signatures import SignatureDB

        sig_db = SignatureDB(enable_online_lookup=self.enable_online_lookup)
        for pattern, selector_offset, inverted in self._DISPATCH_PATTERNS:
            for index in find_op_code_sequence(pattern, self.instruction_list):
                selector_push = self.instruction_list[index + selector_offset]
                selector = selector_push.argument
                if selector is None:
                    continue
                selector = "0x" + selector[2:].rjust(8, "0")
                if inverted:
                    after = index + len(pattern)
                    if after >= len(self.instruction_list):
                        continue
                    target = self.instruction_list[after].address
                else:
                    target_push = self.instruction_list[index + len(pattern) - 2]
                    try:
                        target = int(target_push.argument, 16)
                    except (TypeError, ValueError):
                        continue
                if selector in self.func_hashes:
                    continue
                self.func_hashes.append(selector)
                names = sig_db.get(selector)
                name = names[0] if names else f"_function_{selector}"
                self.function_name_to_address[name] = target
                self.address_to_function_name[target] = name
                self.function_name_to_hash[name] = selector

    # -- queries -------------------------------------------------------------------
    def get_instruction(self, address: int) -> Optional[EvmInstruction]:
        idx = self._address_to_index.get(address)
        return self.instruction_list[idx] if idx is not None else None

    def index_of_address(self, address: int) -> Optional[int]:
        return self._address_to_index.get(address)

    def get_function_info(self, index: int):
        """(function_name, selector) for a PUSH4 dispatcher entry at instruction index."""
        instruction = self.instruction_list[index]
        selector = "0x" + (instruction.argument or "0x")[2:].rjust(8, "0")
        if selector not in self.func_hashes:
            return None, selector
        for name, addr in self.function_name_to_address.items():
            entry = self.instruction_list[index + 2] if index + 2 < len(self.instruction_list) else None
            if entry is not None and entry.argument and int(entry.argument, 16) == addr:
                return name, selector
        return f"_function_{selector}", selector

    def get_easm(self) -> str:
        lines = []
        for ins in self.instruction_list:
            arg = f" {ins.argument}" if ins.argument else ""
            lines.append(f"{ins.address} {ins.op_code}{arg}")
        return "\n".join(lines) + "\n"

    def __str__(self) -> str:
        return self.get_easm()
