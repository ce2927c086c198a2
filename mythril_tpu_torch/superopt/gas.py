"""Static per-opcode gas schedule for the superoptimizer's cost model.

This is the *ranking* table: a candidate rewrite is accepted when its
proven-equivalent body costs strictly less static gas than the original
(weighted by absint loop trip bounds where proven). It deliberately
prices every opcode at its **minimum** schedule cost — the warm-access /
zero-expansion floor — because a rewrite is only ever credited for the
gas component that is *certain*: dynamic components (memory expansion,
cold-access surcharges, per-byte copy costs, EXP exponent bytes) are
identical between a block and its transformer-equal rewrite whenever
they are identical in the floor, and crediting them would overstate
savings.

Kept in byte-for-byte parity with ``ops/opcodes.py`` — every mnemonic in
``OPCODES`` must appear here with exactly ``GAS[0]`` — enforced twice:
the tpu-lint rule R10 (tools/lint/rules/gas_parity.py) and
tests/test_superopt.py, so an EVM fork bump that edits the interpreter's
schedule cannot silently drift this cost model.

Stdlib-only, no in-package imports: the lint rule loads this module
standalone (importlib file-path load, the R4 pattern) without pulling
the mythril_tpu package tree.

The port's copy of mythril_tpu/superopt/gas.py; tests/test_torch_superopt.py
holds its table to the reference's and to the port's ops/opcodes.py.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

#: mnemonic -> static (minimum-schedule) gas cost
STATIC_GAS: Dict[str, int] = {
    "STOP": 0,
    "ADD": 3,
    "MUL": 5,
    "SUB": 3,
    "DIV": 5,
    "SDIV": 5,
    "MOD": 5,
    "SMOD": 5,
    "ADDMOD": 8,
    "MULMOD": 8,
    "EXP": 10,
    "SIGNEXTEND": 5,
    "LT": 3,
    "GT": 3,
    "SLT": 3,
    "SGT": 3,
    "EQ": 3,
    "ISZERO": 3,
    "AND": 3,
    "OR": 3,
    "XOR": 3,
    "NOT": 3,
    "BYTE": 3,
    "SHL": 3,
    "SHR": 3,
    "SAR": 3,
    "SHA3": 30,
    "ADDRESS": 2,
    "BALANCE": 100,
    "ORIGIN": 2,
    "CALLER": 2,
    "CALLVALUE": 2,
    "CALLDATALOAD": 3,
    "CALLDATASIZE": 2,
    "CALLDATACOPY": 3,
    "CODESIZE": 2,
    "CODECOPY": 3,
    "GASPRICE": 2,
    "EXTCODESIZE": 100,
    "EXTCODECOPY": 100,
    "RETURNDATASIZE": 2,
    "RETURNDATACOPY": 3,
    "EXTCODEHASH": 100,
    "BLOCKHASH": 20,
    "COINBASE": 2,
    "TIMESTAMP": 2,
    "NUMBER": 2,
    "PREVRANDAO": 2,
    "GASLIMIT": 2,
    "CHAINID": 2,
    "SELFBALANCE": 5,
    "BASEFEE": 2,
    "BLOBHASH": 3,
    "BLOBBASEFEE": 2,
    "POP": 2,
    "MLOAD": 3,
    "MSTORE": 3,
    "MSTORE8": 3,
    "SLOAD": 100,
    "SSTORE": 100,
    "JUMP": 8,
    "JUMPI": 10,
    "PC": 2,
    "MSIZE": 2,
    "GAS": 2,
    "JUMPDEST": 1,
    "TLOAD": 100,
    "TSTORE": 100,
    "MCOPY": 3,
    "PUSH0": 2,
    "LOG0": 375,
    "LOG1": 750,
    "LOG2": 1125,
    "LOG3": 1500,
    "LOG4": 1875,
    "CREATE": 32000,
    "CALL": 100,
    "CALLCODE": 100,
    "RETURN": 0,
    "DELEGATECALL": 100,
    "CREATE2": 32000,
    "STATICCALL": 100,
    "REVERT": 0,
    "INVALID": 0,
    "SELFDESTRUCT": 5000,
}

for _i in range(1, 33):  # PUSH1..PUSH32: G_verylow
    STATIC_GAS[f"PUSH{_i}"] = 3
for _i in range(1, 17):  # DUP1..DUP16 / SWAP1..SWAP16: G_verylow
    STATIC_GAS[f"DUP{_i}"] = 3
    STATIC_GAS[f"SWAP{_i}"] = 3
# pre-Merge alias, same cell as PREVRANDAO (mirrors ops/opcodes.py)
STATIC_GAS["DIFFICULTY"] = STATIC_GAS["PREVRANDAO"]


def static_gas(name: str) -> int:
    """Static gas for one mnemonic; raises KeyError on unknown names so
    a table gap fails loudly instead of pricing an opcode at zero."""
    return STATIC_GAS[name]


def sequence_gas(names: Iterable[str]) -> int:
    """Summed static gas of an opcode sequence (a block body)."""
    return sum(STATIC_GAS[name] for name in names)


def parity_errors(opcodes: Dict[str, dict], gas_key: str,
                  table: Dict[str, int] = None) -> Tuple[str, ...]:
    """Every parity violation between a gas table (this module's
    ``STATIC_GAS`` by default; the R10 lint rule also points it at
    fixture tables) and an ``ops/opcodes.py``-shaped ``OPCODES`` dict
    (mnemonic -> meta with a ``(min, max)`` gas tuple under `gas_key`).
    Shared by the R10 lint rule and the unit test so both enforce the
    identical contract: equal name sets, and
    ``table[name] == OPCODES[name][gas][0]`` for every name."""
    table = STATIC_GAS if table is None else table
    errors = []
    for name in sorted(set(opcodes) - set(table)):
        errors.append(f"missing from STATIC_GAS: {name}")
    for name in sorted(set(table) - set(opcodes)):
        errors.append(f"not an opcode: {name}")
    for name in sorted(set(opcodes) & set(table)):
        expected = opcodes[name][gas_key][0]
        if table[name] != expected:
            errors.append(f"{name}: STATIC_GAS says {table[name]}, "
                          f"opcode schedule says {expected}")
    return tuple(errors)
