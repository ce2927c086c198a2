"""secp256k1 public-key recovery, from the curve definition (for the ecrecover
precompile). The reference uses coincurve (libsecp256k1, C); this environment has no
such wheel, and ecrecover runs host-side on concrete data only, so a direct
pure-Python implementation suffices.

The port's copy of mythril_tpu/utils/secp256k1.py."""

from __future__ import annotations

from typing import Optional, Tuple

P = 2 ** 256 - 2 ** 32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
Gx = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
Gy = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
A, B = 0, 7

Point = Optional[Tuple[int, int]]  # None = point at infinity


def _inv(a: int, m: int) -> int:
    return pow(a, m - 2, m)


def _add(p: Point, q: Point) -> Point:
    if p is None:
        return q
    if q is None:
        return p
    if p[0] == q[0] and (p[1] + q[1]) % P == 0:
        return None
    if p == q:
        lam = (3 * p[0] * p[0]) * _inv(2 * p[1], P) % P
    else:
        lam = (q[1] - p[1]) * _inv(q[0] - p[0], P) % P
    x = (lam * lam - p[0] - q[0]) % P
    y = (lam * (p[0] - x) - p[1]) % P
    return (x, y)


def _mul(p: Point, scalar: int) -> Point:
    result: Point = None
    addend = p
    while scalar:
        if scalar & 1:
            result = _add(result, addend)
        addend = _add(addend, addend)
        scalar >>= 1
    return result


def ecrecover(message_hash: bytes, v: int, r: int, s: int) -> Optional[bytes]:
    """Recover the uncompressed public key (64 bytes) or None if invalid."""
    if v not in (27, 28):
        return None
    if not (1 <= r < N and 1 <= s < N):
        return None
    recovery_id = v - 27
    x = r  # (x > N case would add N; Ethereum's precompile only tries j=0)
    if x >= P:
        return None
    y_squared = (pow(x, 3, P) + B) % P
    y = pow(y_squared, (P + 3) // 4, P)
    if (y * y) % P != y_squared:
        return None
    if y % 2 != recovery_id:
        y = P - y
    point_r: Point = (x, y)
    e = int.from_bytes(message_hash, "big") % N
    r_inverse = _inv(r, N)
    # Q = r^-1 (s*R - e*G)
    public = _add(_mul(point_r, (s * r_inverse) % N),
                  _mul((Gx, Gy), (-e * r_inverse) % N))
    if public is None:
        return None
    return public[0].to_bytes(32, "big") + public[1].to_bytes(32, "big")


def ecrecover_to_address(message_hash: bytes, v: int, r: int, s: int) -> Optional[int]:
    from .keccak import keccak256

    public = ecrecover(message_hash, v, r, s)
    if public is None:
        return None
    return int.from_bytes(keccak256(public)[12:], "big")
