"""The port's 256-bit word twin (mythril_tpu_torch.parallel.words) against
the JAX `words` module and exact Python integers, on the same adversarial
and random operands. Every comparison is exact."""

import random

import jax
import numpy as np
import pytest
import torch

import mythril_tpu.parallel  # noqa: F401  (x64 on)
from mythril_tpu.parallel import words as jw
from mythril_tpu_torch.parallel import words as tw

M = 1 << 256
MASK = M - 1
INT_MIN = 1 << 255

INTERESTING = [0, 1, 2, 3, 31, 32, 255, 256, 257, 0xFFFF, 0x10000,
               MASK, MASK - 1, INT_MIN, INT_MIN - 1, 1 << 128, (1 << 128) - 1]
_rng = random.Random(4321)
RANDOMS = [_rng.getrandbits(_rng.choice([8, 64, 130, 256])) for _ in range(24)]
VALUES = INTERESTING + RANDOMS
PAIRS = [(a, b) for a in INTERESTING for b in INTERESTING] \
    + [(a, b) for a, b in zip(RANDOMS, reversed(RANDOMS))] \
    + [(INT_MIN, MASK), (5, 0), (MASK, 0), (7, 300), (INT_MIN, 1000)]
A_INTS = [p[0] for p in PAIRS]
B_INTS = [p[1] for p in PAIRS]
N_INTS = [VALUES[(i * 7) % len(VALUES)] for i in range(len(PAIRS))]


def _limbs(values):
    return np.stack([tw.from_int(v) for v in values])


A, B, N = (_limbs(v) for v in (A_INTS, B_INTS, N_INTS))


def _signed(x):
    return x - M if x >> 255 else x


def _sdiv(x, y):
    if y == 0:
        return 0
    q = abs(_signed(x)) // abs(_signed(y))
    return -q if (_signed(x) < 0) != (_signed(y) < 0) else q


def _smod(x, y):
    if y == 0:
        return 0
    r = abs(_signed(x)) % abs(_signed(y))
    return -r if _signed(x) < 0 else r


def _signextend(size, value):
    if size >= 31:
        return value
    bit = size * 8 + 7
    if value >> bit & 1:
        return value | (MASK ^ ((1 << bit) - 1))
    return value & ((1 << bit) - 1)


BINARY = {
    "add": (lambda x, y: x + y),
    "sub": (lambda x, y: x - y),
    "mul": (lambda x, y: x * y),
    "lt": (lambda x, y: int(x < y)),
    "gt": (lambda x, y: int(x > y)),
    "slt": (lambda x, y: int(_signed(x) < _signed(y))),
    "sgt": (lambda x, y: int(_signed(x) > _signed(y))),
    "eq": (lambda x, y: int(x == y)),
    "band": (lambda x, y: x & y),
    "bor": (lambda x, y: x | y),
    "bxor": (lambda x, y: x ^ y),
    "shl": (lambda s, v: (v << s) if s < 256 else 0),
    "shr": (lambda s, v: (v >> s) if s < 256 else 0),
    "sar": (lambda s, v: (_signed(v) >> min(s, 256))),
    "byte_op": (lambda i, v: (v >> (8 * (31 - i))) & 0xFF if i < 32 else 0),
    "signextend": _signextend,
    "sdiv": _sdiv,
    "smod": _smod,
    "exp": (lambda x, y: pow(x, y, M)),
}
BOOL_OPS = {"lt", "gt", "slt", "sgt", "eq"}


def _port(fn, *args):
    return fn(*[torch.from_numpy(a.astype(np.int64)) for a in args])


def _compare(name, got, ref, expected):
    got_ints = tw.to_ints(tw.bool_to_word(got) if got.dtype == torch.bool
                          else got)
    ref_ints = jw.to_ints(np.asarray(jw.bool_to_word(ref))
                          if np.asarray(ref).dtype == bool else ref)
    for i, (x, y) in enumerate(zip(A_INTS, B_INTS)):
        want = expected[i] & MASK
        assert ref_ints[i] == want, f"JAX {name}({x:#x}, {y:#x})"
        assert got_ints[i] == want, \
            f"port {name}({x:#x}, {y:#x}): {got_ints[i]:#x} != {want:#x}"


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_op(name):
    got = _port(getattr(tw, name), A, B)
    ref = getattr(jw, name)(jw.U32(A), jw.U32(B))
    expected = [BINARY[name](x, y) for x, y in zip(A_INTS, B_INTS)]
    _compare(name, got, ref, expected)


def test_divmod():
    q, r = _port(tw.divmod_, A, B)
    jq, jr = jw.divmod_(jw.U32(A), jw.U32(B))
    _compare("div", q, jq, [x // y if y else 0 for x, y in zip(A_INTS, B_INTS)])
    _compare("mod", r, jr, [x % y if y else 0 for x, y in zip(A_INTS, B_INTS)])


@pytest.mark.parametrize("name", ["addmod", "mulmod"])
def test_ternary_mod(name):
    got = _port(getattr(tw, name), A, B, N)
    ref = getattr(jw, name)(jw.U32(A), jw.U32(B), jw.U32(N))
    combine = (lambda x, y: x + y) if name == "addmod" else (lambda x, y: x * y)
    expected = [combine(x, y) % n if n else 0
                for x, y, n in zip(A_INTS, B_INTS, N_INTS)]
    _compare(name, got, ref, expected)


@pytest.mark.parametrize("name", ["neg", "bnot", "is_zero"])
def test_unary_op(name):
    got = _port(getattr(tw, name), A)
    ref = getattr(jw, name)(jw.U32(A))
    fn = {"neg": lambda x: -x, "bnot": lambda x: ~x,
          "is_zero": lambda x: int(x == 0)}[name]
    _compare(name, got, ref, [fn(x) for x in A_INTS])


def test_mul_wide_and_byte_packing():
    got = _port(tw.mul_wide, A, B)
    ref = np.asarray(jw.mul_wide(jw.U32(A), jw.U32(B)))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    packed = tw.to_bytes(torch.from_numpy(A.astype(np.int64)))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jw.to_bytes(jw.U32(A))))
    np.testing.assert_array_equal(tw.from_bytes(packed).numpy(), A)


def test_host_converters_match():
    for value in VALUES + [-1, M + 5]:
        np.testing.assert_array_equal(tw.from_int(value), jw.from_int(value))
    assert list(tw.to_ints(A)) == list(jw.to_ints(A)) == A_INTS
