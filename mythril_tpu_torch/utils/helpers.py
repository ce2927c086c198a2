"""Small shared helpers (capability parity: mythril/support/support_utils.py helpers and
the ~10 py-evm constants/utilities the reference imports — SURVEY.md §2.7).

The port's copy of mythril_tpu/utils/helpers.py."""

from __future__ import annotations

from .keccak import keccak256

TT256 = 2 ** 256
TT256M1 = 2 ** 256 - 1
TT255 = 2 ** 255


def ceil32(x: int) -> int:
    return -(-x // 32) * 32


def to_signed(value: int) -> int:
    """Interpret a 256-bit unsigned value as two's-complement signed."""
    return value - TT256 if value >= TT255 else value


def to_unsigned(value: int) -> int:
    return value + TT256 if value < 0 else value


def zpad(data: bytes, length: int) -> bytes:
    """Right-pad with zero bytes to `length` (EVM memory/calldata convention)."""
    return data + b"\x00" * max(0, length - len(data))


def big_endian_to_int(data: bytes) -> int:
    return int.from_bytes(data, "big")


def int_to_big_endian(value: int, length: int = 32) -> bytes:
    return value.to_bytes(length, "big")


def rlp_encode(item) -> bytes:
    """Minimal RLP encoder — enough for contract-address derivation."""
    if isinstance(item, int):
        if item == 0:
            item = b""
        else:
            item = item.to_bytes((item.bit_length() + 7) // 8, "big")
    if isinstance(item, (bytes, bytearray)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _rlp_length(len(item), 0x80) + item
    if isinstance(item, (list, tuple)):
        payload = b"".join(rlp_encode(sub) for sub in item)
        return _rlp_length(len(payload), 0xC0) + payload
    raise TypeError(f"cannot RLP-encode {type(item)}")


def _rlp_length(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([length + offset])
    length_bytes = length.to_bytes((length.bit_length() + 7) // 8, "big")
    return bytes([len(length_bytes) + offset + 55]) + length_bytes


def generate_contract_address(sender: int, nonce: int) -> int:
    """CREATE address = keccak(rlp([sender, nonce]))[12:] (Yellow Paper eq. 85)."""
    sender_bytes = sender.to_bytes(20, "big")
    return int.from_bytes(keccak256(rlp_encode([sender_bytes, nonce]))[12:], "big")


def generate_salted_address(sender: int, salt: int, init_code: bytes) -> int:
    """CREATE2 address = keccak(0xff ++ sender ++ salt ++ keccak(init_code))[12:]."""
    preimage = (b"\xff" + sender.to_bytes(20, "big") + salt.to_bytes(32, "big")
                + keccak256(init_code))
    return int.from_bytes(keccak256(preimage)[12:], "big")


def get_code_hash(code: str | bytes) -> str:
    """keccak hash of runtime bytecode, '0x'-prefixed hex (issue-cache key)."""
    if isinstance(code, str):
        code = bytes.fromhex(code[2:] if code.startswith("0x") else code)
    return "0x" + keccak256(code).hex()


def sha3(data: bytes | str) -> bytes:
    if isinstance(data, str):
        data = data.encode()
    return keccak256(data)
