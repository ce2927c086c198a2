"""EVM opcode metadata through the Cancun fork.

Capability parity with the reference's opcode table (mythril/support/opcodes.py:16):
each mnemonic maps to its byte value, stack effect (pops, pushes) and a (min, max) gas
estimate used for the gas-range accounting in reports. Values follow the Yellow Paper /
EIP gas schedules (Berlin cold/warm access costs give the min/max spread for state-
touching ops; memory-expansion and per-byte components are accounted dynamically by the
interpreter, not in this static table).

The port's own copy of the JAX package's opcode table: it is densified into the
arrays consumed by mythril_tpu_torch.parallel.lockstep and baked into the CUDA
step kernel's tables at build time.
"""

from __future__ import annotations

from typing import Dict, Tuple

ADDRESS = "address"
STACK = "stack"
GAS = "gas"

_G_ZERO = (0, 0)
_G_BASE = (2, 2)
_G_VERYLOW = (3, 3)
_G_LOW = (5, 5)
_G_MID = (8, 8)
_G_HIGH = (10, 10)
_G_JUMPDEST = (1, 1)

# name: (byte, pops, pushes, gas_min, gas_max)
_RAW: Dict[str, Tuple[int, int, int, int, int]] = {
    "STOP": (0x00, 0, 0, 0, 0),
    "ADD": (0x01, 2, 1, 3, 3),
    "MUL": (0x02, 2, 1, 5, 5),
    "SUB": (0x03, 2, 1, 3, 3),
    "DIV": (0x04, 2, 1, 5, 5),
    "SDIV": (0x05, 2, 1, 5, 5),
    "MOD": (0x06, 2, 1, 5, 5),
    "SMOD": (0x07, 2, 1, 5, 5),
    "ADDMOD": (0x08, 3, 1, 8, 8),
    "MULMOD": (0x09, 3, 1, 8, 8),
    "EXP": (0x0A, 2, 1, 10, 10 + 50 * 32),  # 10 + 50/exponent byte
    "SIGNEXTEND": (0x0B, 2, 1, 5, 5),
    "LT": (0x10, 2, 1, 3, 3),
    "GT": (0x11, 2, 1, 3, 3),
    "SLT": (0x12, 2, 1, 3, 3),
    "SGT": (0x13, 2, 1, 3, 3),
    "EQ": (0x14, 2, 1, 3, 3),
    "ISZERO": (0x15, 1, 1, 3, 3),
    "AND": (0x16, 2, 1, 3, 3),
    "OR": (0x17, 2, 1, 3, 3),
    "XOR": (0x18, 2, 1, 3, 3),
    "NOT": (0x19, 1, 1, 3, 3),
    "BYTE": (0x1A, 2, 1, 3, 3),
    "SHL": (0x1B, 2, 1, 3, 3),
    "SHR": (0x1C, 2, 1, 3, 3),
    "SAR": (0x1D, 2, 1, 3, 3),
    "SHA3": (0x20, 2, 1, 30, 30 + 6 * 8),  # 30 + 6/word; max assumes modest input
    "ADDRESS": (0x30, 0, 1, 2, 2),
    "BALANCE": (0x31, 1, 1, 100, 2600),  # warm / cold (EIP-2929)
    "ORIGIN": (0x32, 0, 1, 2, 2),
    "CALLER": (0x33, 0, 1, 2, 2),
    "CALLVALUE": (0x34, 0, 1, 2, 2),
    "CALLDATALOAD": (0x35, 1, 1, 3, 3),
    "CALLDATASIZE": (0x36, 0, 1, 2, 2),
    "CALLDATACOPY": (0x37, 3, 0, 3, 3 + 3 * 768),
    "CODESIZE": (0x38, 0, 1, 2, 2),
    "CODECOPY": (0x39, 3, 0, 3, 3 + 3 * 768),
    "GASPRICE": (0x3A, 0, 1, 2, 2),
    "EXTCODESIZE": (0x3B, 1, 1, 100, 2600),
    "EXTCODECOPY": (0x3C, 4, 0, 100, 2600 + 3 * 768),
    "RETURNDATASIZE": (0x3D, 0, 1, 2, 2),
    "RETURNDATACOPY": (0x3E, 3, 0, 3, 3 + 3 * 768),
    "EXTCODEHASH": (0x3F, 1, 1, 100, 2600),
    "BLOCKHASH": (0x40, 1, 1, 20, 20),
    "COINBASE": (0x41, 0, 1, 2, 2),
    "TIMESTAMP": (0x42, 0, 1, 2, 2),
    "NUMBER": (0x43, 0, 1, 2, 2),
    "PREVRANDAO": (0x44, 0, 1, 2, 2),  # ex-DIFFICULTY (EIP-4399)
    "GASLIMIT": (0x45, 0, 1, 2, 2),
    "CHAINID": (0x46, 0, 1, 2, 2),
    "SELFBALANCE": (0x47, 0, 1, 5, 5),
    "BASEFEE": (0x48, 0, 1, 2, 2),
    "BLOBHASH": (0x49, 1, 1, 3, 3),
    "BLOBBASEFEE": (0x4A, 0, 1, 2, 2),
    "POP": (0x50, 1, 0, 2, 2),
    "MLOAD": (0x51, 1, 1, 3, 96),
    "MSTORE": (0x52, 2, 0, 3, 98),
    "MSTORE8": (0x53, 2, 0, 3, 98),
    "SLOAD": (0x54, 1, 1, 100, 2100),  # warm / cold
    "SSTORE": (0x55, 2, 0, 100, 22100),  # warm-dirty / cold-fresh-set
    "JUMP": (0x56, 1, 0, 8, 8),
    "JUMPI": (0x57, 2, 0, 10, 10),
    "PC": (0x58, 0, 1, 2, 2),
    "MSIZE": (0x59, 0, 1, 2, 2),
    "GAS": (0x5A, 0, 1, 2, 2),
    "JUMPDEST": (0x5B, 0, 0, 1, 1),
    "TLOAD": (0x5C, 1, 1, 100, 100),  # EIP-1153
    "TSTORE": (0x5D, 2, 0, 100, 100),
    "MCOPY": (0x5E, 3, 0, 3, 3 + 3 * 768),  # EIP-5656
    "PUSH0": (0x5F, 0, 1, 2, 2),  # EIP-3855
    "LOG0": (0xA0, 2, 0, 375, 375 + 8 * 32),
    "LOG1": (0xA1, 3, 0, 750, 750 + 8 * 32),
    "LOG2": (0xA2, 4, 0, 1125, 1125 + 8 * 32),
    "LOG3": (0xA3, 5, 0, 1500, 1500 + 8 * 32),
    "LOG4": (0xA4, 6, 0, 1875, 1875 + 8 * 32),
    "CREATE": (0xF0, 3, 1, 32000, 32000),
    "CALL": (0xF1, 7, 1, 100, 2600 + 9000 + 25000),
    "CALLCODE": (0xF2, 7, 1, 100, 2600 + 9000),
    "RETURN": (0xF3, 2, 0, 0, 0),
    "DELEGATECALL": (0xF4, 6, 1, 100, 2600),
    "CREATE2": (0xF5, 4, 1, 32000, 32000 + 6 * 768),
    "STATICCALL": (0xFA, 6, 1, 100, 2600),
    "REVERT": (0xFD, 2, 0, 0, 0),
    "INVALID": (0xFE, 0, 0, 0, 0),
    "SELFDESTRUCT": (0xFF, 1, 0, 5000, 30000),
}

for _i in range(1, 33):  # PUSH1..PUSH32
    _RAW[f"PUSH{_i}"] = (0x5F + _i, 0, 1, 3, 3)
for _i in range(1, 17):  # DUP1..DUP16
    _RAW[f"DUP{_i}"] = (0x7F + _i, _i, _i + 1, 3, 3)
for _i in range(1, 17):  # SWAP1..SWAP16
    _RAW[f"SWAP{_i}"] = (0x8F + _i, _i + 1, _i + 1, 3, 3)

#: mnemonic -> {"address": byte, "stack": (pops, pushes), "gas": (min, max)}
OPCODES: Dict[str, dict] = {
    name: {ADDRESS: vals[0], STACK: (vals[1], vals[2]), GAS: (vals[3], vals[4])}
    for name, vals in _RAW.items()
}

_BY_NUMBER: Dict[int, str] = {meta[ADDRESS]: name for name, meta in OPCODES.items()}
# Historical alias: pre-Merge tooling calls 0x44 DIFFICULTY.
OPCODES["DIFFICULTY"] = OPCODES["PREVRANDAO"]


def opcode_by_number(byte_value: int) -> str | None:
    """Mnemonic for an opcode byte, or None for unassigned bytes."""
    return _BY_NUMBER.get(byte_value)


def opcode_name(byte_value: int) -> str:
    """Mnemonic, or 'UNKNOWN_0xXX' for unassigned bytes (disassembly display)."""
    return _BY_NUMBER.get(byte_value, f"UNKNOWN_0x{byte_value:02x}")


def push_width(name: str) -> int:
    """Immediate width in bytes for PUSHn (0 for PUSH0 and non-push opcodes)."""
    if name.startswith("PUSH") and name != "PUSH0":
        return int(name[4:])
    return 0
