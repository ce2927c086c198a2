"""Precompiled contracts 1-10 (capability parity: mythril/laser/ethereum/natives.py —
ecrecover:76, sha256:103, ripemd160:116, identity:131, mod_exp:140, ec_add:172,
ec_mul:189, ec_pair:204, blake2b_fcompress:239).

Concrete-only host-side implementations; symbolic input raises
NativeContractException and the caller falls back to symbolic return data, exactly as
the reference does. No native wheels here: secp256k1 and alt_bn128 are implemented
from their curve definitions (utils/secp256k1.py, _bn128 below); blake2 F comes from
the RFC 7693 core.

The port's copy of mythril_tpu/core/natives.py."""

from __future__ import annotations

import hashlib
from typing import List, Union

from ..exceptions import MythrilTpuBaseException
from ..smt import BitVec
from ..utils.helpers import zpad
from ..utils.secp256k1 import ecrecover_to_address
from .state.calldata import BaseCalldata, ConcreteCalldata


class NativeContractException(MythrilTpuBaseException):
    """Raised when a precompile gets symbolic input (caller returns symbolic data)."""


def _to_concrete_bytes(data: Union[bytes, BaseCalldata, List]) -> bytes:
    if isinstance(data, bytes):
        return data
    if isinstance(data, ConcreteCalldata):
        return bytes(data.concrete(None))
    if isinstance(data, BaseCalldata):
        raise NativeContractException("symbolic calldata into precompile")
    out = bytearray()
    for item in data:
        if isinstance(item, int):
            out.append(item)
        elif isinstance(item, BitVec) and item.raw.is_const:
            out.append(item.value)
        else:
            raise NativeContractException("symbolic byte into precompile")
    return bytes(out)


def ecrecover(data: Union[bytes, BaseCalldata]) -> List[int]:
    payload = zpad(_to_concrete_bytes(data), 128)
    message_hash = payload[0:32]
    v = int.from_bytes(payload[32:64], "big")
    r = int.from_bytes(payload[64:96], "big")
    s = int.from_bytes(payload[96:128], "big")
    try:
        address = ecrecover_to_address(message_hash, v, r, s)
    except Exception:
        return []
    if address is None:
        return []
    return list(address.to_bytes(32, "big"))


def sha256(data) -> List[int]:
    return list(hashlib.sha256(_to_concrete_bytes(data)).digest())


def ripemd160(data) -> List[int]:
    digest = hashlib.new("ripemd160", _to_concrete_bytes(data)).digest()
    return list(zpad(b"", 12) + digest)


def identity(data) -> List[int]:
    return list(_to_concrete_bytes(data))


def mod_exp(data) -> List[int]:
    payload = _to_concrete_bytes(data)
    base_length = int.from_bytes(zpad(payload[0:32], 32)[:32], "big")
    exponent_length = int.from_bytes(zpad(payload[32:64], 32)[:32], "big")
    modulus_length = int.from_bytes(zpad(payload[64:96], 32)[:32], "big")
    body = zpad(payload[96:], base_length + exponent_length + modulus_length)
    base = int.from_bytes(body[0:base_length], "big")
    exponent = int.from_bytes(body[base_length:base_length + exponent_length], "big")
    modulus = int.from_bytes(
        body[base_length + exponent_length:
             base_length + exponent_length + modulus_length], "big")
    if modulus == 0:
        return [0] * modulus_length
    return list(pow(base, exponent, modulus).to_bytes(modulus_length, "big"))


# -- alt_bn128 ---------------------------------------------------------------------

_BN_P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
_BN_N = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def _bn_inv(a: int) -> int:
    return pow(a, _BN_P - 2, _BN_P)


def _bn_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    if p[0] == q[0] and (p[1] + q[1]) % _BN_P == 0:
        return None
    if p == q:
        lam = 3 * p[0] * p[0] * _bn_inv(2 * p[1]) % _BN_P
    else:
        lam = (q[1] - p[1]) * _bn_inv(q[0] - p[0]) % _BN_P
    x = (lam * lam - p[0] - q[0]) % _BN_P
    return (x, (lam * (p[0] - x) - p[1]) % _BN_P)


def _bn_mul(p, scalar: int):
    result = None
    addend = p
    while scalar:
        if scalar & 1:
            result = _bn_add(result, addend)
        addend = _bn_add(addend, addend)
        scalar >>= 1
    return result


def _bn_validate(x: int, y: int):
    if x >= _BN_P or y >= _BN_P:
        raise ValueError("bn128 coordinate out of field")
    if x == 0 and y == 0:
        return None
    if (y * y - x * x * x - 3) % _BN_P != 0:
        raise ValueError("point not on bn128 curve")
    return (x, y)


def ec_add(data) -> List[int]:
    payload = zpad(_to_concrete_bytes(data), 128)
    try:
        p = _bn_validate(int.from_bytes(payload[0:32], "big"),
                         int.from_bytes(payload[32:64], "big"))
        q = _bn_validate(int.from_bytes(payload[64:96], "big"),
                         int.from_bytes(payload[96:128], "big"))
    except ValueError:
        return []
    result = _bn_add(p, q)
    if result is None:
        return [0] * 64
    return list(result[0].to_bytes(32, "big") + result[1].to_bytes(32, "big"))


def ec_mul(data) -> List[int]:
    payload = zpad(_to_concrete_bytes(data), 96)
    try:
        p = _bn_validate(int.from_bytes(payload[0:32], "big"),
                         int.from_bytes(payload[32:64], "big"))
    except ValueError:
        return []
    scalar = int.from_bytes(payload[64:96], "big")
    result = _bn_mul(p, scalar % _BN_N) if p is not None else None
    if result is None:
        return [0] * 64
    return list(result[0].to_bytes(32, "big") + result[1].to_bytes(32, "big"))


def ec_pair(data) -> List[int]:
    """alt_bn128 pairing check. The full optimal-ate pairing is not implemented in
    round 1; only the structurally-trivial empty input (vacuously true) is answered
    concretely, everything else falls back to symbolic return data."""
    payload = _to_concrete_bytes(data)
    if len(payload) == 0:
        return list((1).to_bytes(32, "big"))
    if len(payload) % 192 != 0:
        return []
    raise NativeContractException("bn128 pairing not concretely modeled")


# -- blake2f (EIP-152) -------------------------------------------------------------

_BLAKE2B_IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]
_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]
_M64 = (1 << 64) - 1


def _rotr64(x: int, n: int) -> int:
    return ((x >> n) | (x << (64 - n))) & _M64


def _blake2b_g(v, a, b, c, d, x, y):
    v[a] = (v[a] + v[b] + x) & _M64
    v[d] = _rotr64(v[d] ^ v[a], 32)
    v[c] = (v[c] + v[d]) & _M64
    v[b] = _rotr64(v[b] ^ v[c], 24)
    v[a] = (v[a] + v[b] + y) & _M64
    v[d] = _rotr64(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & _M64
    v[b] = _rotr64(v[b] ^ v[c], 63)


def blake2b_fcompress(data) -> List[int]:
    payload = _to_concrete_bytes(data)
    if len(payload) != 213:
        return []
    rounds = int.from_bytes(payload[0:4], "big")
    h = [int.from_bytes(payload[4 + 8 * i:12 + 8 * i], "little") for i in range(8)]
    m = [int.from_bytes(payload[68 + 8 * i:76 + 8 * i], "little") for i in range(16)]
    t0 = int.from_bytes(payload[196:204], "little")
    t1 = int.from_bytes(payload[204:212], "little")
    final = payload[212]
    if final not in (0, 1):
        return []
    v = h[:] + _BLAKE2B_IV[:]
    v[12] ^= t0
    v[13] ^= t1
    if final:
        v[14] ^= _M64
    for round_index in range(rounds):
        s = _SIGMA[round_index % 10]
        _blake2b_g(v, 0, 4, 8, 12, m[s[0]], m[s[1]])
        _blake2b_g(v, 1, 5, 9, 13, m[s[2]], m[s[3]])
        _blake2b_g(v, 2, 6, 10, 14, m[s[4]], m[s[5]])
        _blake2b_g(v, 3, 7, 11, 15, m[s[6]], m[s[7]])
        _blake2b_g(v, 0, 5, 10, 15, m[s[8]], m[s[9]])
        _blake2b_g(v, 1, 6, 11, 12, m[s[10]], m[s[11]])
        _blake2b_g(v, 2, 7, 8, 13, m[s[12]], m[s[13]])
        _blake2b_g(v, 3, 4, 9, 14, m[s[14]], m[s[15]])
    out = bytearray()
    for i in range(8):
        out += ((h[i] ^ v[i] ^ v[i + 8]) & _M64).to_bytes(8, "little")
    return list(out)


def point_evaluation(data) -> List[int]:
    """KZG point evaluation (EIP-4844, address 0x0a): not concretely modeled."""
    raise NativeContractException("kzg point evaluation not concretely modeled")


PRECOMPILE_COUNT = 10

native_contracts = {
    1: ecrecover, 2: sha256, 3: ripemd160, 4: identity, 5: mod_exp,
    6: ec_add, 7: ec_mul, 8: ec_pair, 9: blake2b_fcompress, 10: point_evaluation,
}


def native_contract(address: int, data) -> List[int]:
    """Dispatch by precompile address (1-based); raises NativeContractException for
    symbolic input or unmodeled semantics."""
    return native_contracts[address](data)
