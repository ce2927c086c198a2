"""A small EVM assembler.

The build environment has no solc, so test and benchmark contracts are authored in EVM
assembly. This has no reference counterpart (the reference ships pre-compiled .sol.o
fixtures); it exists so the repo's fixtures are self-contained.

Syntax (one instruction per line, ';' comments):
    start:                 ; label definition
    PUSH1 0x60             ; explicit push
    PUSH 1234              ; auto-sized push (decimal or 0x hex)
    PUSH @start            ; label reference (assembled as PUSH2, patched)
    JUMPI

High-level helpers build solidity-ABI-style contracts: `dispatcher()` produces the
standard 4-byte selector jump table so the engine's selector recovery and per-function
symbolic transactions work exactly as they do on solc output.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

from ..ops.opcodes import OPCODES, ADDRESS
from ..utils.keccak import keccak256_py as keccak256


class AsmError(Exception):
    pass


def _encode_push(value: int, width: int | None = None) -> bytes:
    if value < 0:
        raise AsmError(f"push value must be non-negative: {value}")
    if value == 0 and width is None:
        width = 1  # PUSH1 0x00 (portable to pre-Shanghai; PUSH0 only when explicit)
    if width is None:
        width = max(1, (value.bit_length() + 7) // 8)
    if width > 32:
        raise AsmError(f"push value too wide: {value}")
    if value >= 1 << (8 * width):
        raise AsmError(f"value {value:#x} does not fit PUSH{width}")
    return bytes([0x5F + width]) + value.to_bytes(width, "big")


class Assembler:
    """Two-pass assembler with label patching (labels always use PUSH2)."""

    def __init__(self):
        self._chunks: List[bytes | Tuple[str, str]] = []  # bytes or ("label_ref", name)

    # -- programmatic API ----------------------------------------------------------
    def op(self, name: str) -> "Assembler":
        name = name.upper()
        if name not in OPCODES:
            raise AsmError(f"unknown opcode {name}")
        self._chunks.append(bytes([OPCODES[name][ADDRESS]]))
        return self

    def push(self, value: int, width: int | None = None) -> "Assembler":
        self._chunks.append(_encode_push(value, width))
        return self

    def push_label(self, label: str) -> "Assembler":
        self._chunks.append(("label_ref", label))
        return self

    def label(self, name: str) -> "Assembler":
        self._chunks.append(("label_def", name))
        return self

    def raw(self, data: bytes) -> "Assembler":
        self._chunks.append(bytes(data))
        return self

    # -- assembly ------------------------------------------------------------------
    def assemble(self) -> bytes:
        # pass 1: compute label addresses (label refs are fixed-width PUSH2)
        pc = 0
        labels: Dict[str, int] = {}
        for chunk in self._chunks:
            if isinstance(chunk, tuple):
                kind, name = chunk
                if kind == "label_def":
                    labels[name] = pc
                else:
                    pc += 3  # PUSH2 xx xx
            else:
                pc += len(chunk)
        # pass 2: emit
        out = bytearray()
        for chunk in self._chunks:
            if isinstance(chunk, tuple):
                kind, name = chunk
                if kind == "label_def":
                    continue
                if name not in labels:
                    raise AsmError(f"undefined label {name}")
                out += bytes([0x61]) + labels[name].to_bytes(2, "big")
            else:
                out += chunk
        return bytes(out)


_TOKEN_RE = re.compile(r"^(?P<label>\w+):$")


def assemble(source: str) -> bytes:
    """Assemble textual EVM assembly (see module docstring for syntax)."""
    asm = Assembler()
    for raw_line in source.splitlines():
        line = raw_line.split(";")[0].strip()
        if not line:
            continue
        label_match = _TOKEN_RE.match(line)
        if label_match:
            asm.label(label_match.group("label"))
            continue
        parts = line.split()
        mnemonic = parts[0].upper()
        if mnemonic.startswith("PUSH") and mnemonic != "PUSH0":
            if len(parts) < 2:
                raise AsmError(f"{mnemonic} needs an operand: {raw_line.strip()!r}")
            operand = parts[1]
            if operand.startswith("@"):
                asm.push_label(operand[1:])
            else:
                value = int(operand, 16) if operand.lower().startswith("0x") else int(operand)
                width = None if mnemonic == "PUSH" else int(mnemonic[4:])
                asm.push(value, width)
        elif mnemonic == "RAWHEX":
            asm.raw(bytes.fromhex(parts[1].removeprefix("0x")))
        else:
            asm.op(mnemonic)
    return asm.assemble()


def selector(signature: str) -> int:
    """4-byte function selector of a canonical signature like 'withdraw(uint256)'."""
    return int.from_bytes(keccak256(signature.encode())[:4], "big")


def dispatcher(functions: Dict[str, str], fallback: str = "STOP") -> str:
    """Build a full contract source with a solc-style selector dispatcher.

    `functions` maps canonical signatures to assembly bodies (each body should end in
    STOP/RETURN/REVERT). Produces the classic prelude:
    calldataload(0) >> 224, then PUSH4/EQ/JUMPI chains.
    """
    lines = [
        "PUSH1 0x00",
        "CALLDATALOAD",
        "PUSH1 0xe0",
        "SHR",
    ]
    names = list(functions)
    for sig in names:
        lines += [
            "DUP1",
            f"PUSH4 0x{selector(sig):08x}",
            "EQ",
            f"PUSH @fn_{selector(sig):08x}",
            "JUMPI",
        ]
    lines += [fallback]
    for sig in names:
        lines += [f"fn_{selector(sig):08x}:", "JUMPDEST", "POP"]
        lines += [functions[sig].strip()]
    return "\n".join(lines)


def creation_wrapper(runtime: bytes, constructor: str = "") -> bytes:
    """Wrap runtime code in standard init code (CODECOPY + RETURN), with an optional
    constructor body that runs first."""
    prefix = assemble(constructor) if constructor else b""
    # layout: [constructor][PUSH2 len][PUSH2 offset][PUSH1 0][CODECOPY][PUSH2 len][PUSH1 0][RETURN][runtime]
    # offset = len(prefix) + len(fixed tail)
    tail_len = 3 + 3 + 2 + 1 + 3 + 2 + 1  # computed below, fixed widths
    offset = len(prefix) + tail_len
    tail = bytearray()
    tail += bytes([0x61]) + len(runtime).to_bytes(2, "big")   # PUSH2 len
    tail += bytes([0x61]) + offset.to_bytes(2, "big")          # PUSH2 offset
    tail += bytes([0x60, 0x00])                                 # PUSH1 0
    tail += bytes([0x39])                                       # CODECOPY
    tail += bytes([0x61]) + len(runtime).to_bytes(2, "big")    # PUSH2 len
    tail += bytes([0x60, 0x00])                                 # PUSH1 0
    tail += bytes([0xF3])                                       # RETURN
    assert len(tail) == tail_len
    return bytes(prefix) + bytes(tail) + runtime
