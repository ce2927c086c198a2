"""Keccak-256 implemented from the Keccak specification.

The reference leans on a native keccak (eth-hash / pysha3, C) for concrete hashing of
SHA3 inputs (reference: mythril/laser/ethereum/function_managers/keccak_function_manager.py:57).
Neither is available here and hashlib's sha3_256 uses the NIST padding (0x06), not the
original Keccak padding (0x01) that Ethereum uses, so this is a from-scratch
implementation of Keccak-f[1600] with multi-rate padding.

This is the port's own copy of the pure-Python digest: the host oracle for the
device keccak (mythril_tpu_torch/parallel/keccak.py and kernels/keccak.cuh).
"""

from __future__ import annotations

_MASK64 = (1 << 64) - 1

# Rotation offsets r[x][y] from the Keccak reference, flattened to the lane order used
# in `_keccak_f` below (index = x + 5*y).
_ROT = [
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
]

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]


def _rotl(value: int, shift: int) -> int:
    shift %= 64
    return ((value << shift) | (value >> (64 - shift))) & _MASK64


def _keccak_f(state: list) -> None:
    """In-place Keccak-f[1600] permutation over 25 64-bit lanes (index = x + 5*y)."""
    for rc in _RC:
        # theta
        c = [state[x] ^ state[x + 5] ^ state[x + 10] ^ state[x + 15] ^ state[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(0, 25, 5):
                state[x + y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                # B[y, 2x+3y] = rot(A[x, y], r[x, y])
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(state[x + 5 * y], _ROT[x + 5 * y])
        # chi
        for x in range(5):
            for y in range(0, 25, 5):
                state[x + y] = b[x + y] ^ ((~b[(x + 1) % 5 + y]) & b[(x + 2) % 5 + y])
        # iota
        state[0] ^= rc


def keccak256_py(data: bytes) -> bytes:
    """Keccak-256 digest (pure Python)."""
    rate = 136  # (1600 - 2*256) / 8
    state = [0] * 25

    # Multi-rate padding 0x01 .. 0x80 (Ethereum's original Keccak, not NIST SHA3).
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 else b"\x81"

    for block_start in range(0, len(padded), rate):
        block = padded[block_start:block_start + rate]
        for i in range(rate // 8):
            state[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        _keccak_f(state)

    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out[:32]


def keccak256(data: bytes) -> bytes:
    """Keccak-256 digest: the JAX package's `keccak256` without its native
    library, which gives the same digest."""
    return keccak256_py(data)


def keccak256_int(data: bytes) -> int:
    return int.from_bytes(keccak256_py(data), "big")
