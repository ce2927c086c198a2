"""256-bit EVM words as 16 little-endian 16-bit limbs: the plain PyTorch twin.

Port of mythril_tpu/parallel/words.py. The limb layout is the JAX package's
(`u32[..., 16]`, limb i holds bits 16i..16i+15) at every boundary; the port
keeps limb tensors as int32 (same bytes: every limb is < 2^16) and these
functions compute on int64 limbs, where no partial product can overflow.

This module is the plain version of the `__device__` word arithmetic in
`kernels/words.cuh`, which the CUDA step kernel inlines: the CPU tests hold
it against the JAX `words` module and Python ints, and `chip_smoke.py`
holds the CUDA step against the step built from these functions.

EVM semantics (not SMT-LIB): DIV/MOD/SDIV/SMOD by zero give 0, SDIV of
INT_MIN by -1 wraps to INT_MIN (yellow paper appendix H).

Every function takes and returns int64 limb tensors (values in [0, 2^16)),
broadcasting over leading batch axes; comparisons return bool tensors.
"""

from __future__ import annotations

import numpy as np
import torch

NLIMBS = 16
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
WORD_BITS = NLIMBS * LIMB_BITS  # 256

I64 = torch.int64


# -- host converters -----------------------------------------------------------------

def from_int(value: int, batch_shape=()) -> np.ndarray:
    """Python int -> uint32 limb array broadcast to batch_shape + (NLIMBS,)."""
    value &= (1 << WORD_BITS) - 1
    limbs = np.array([(value >> (LIMB_BITS * i)) & LIMB_MASK
                      for i in range(NLIMBS)], dtype=np.uint32)
    return np.broadcast_to(limbs, tuple(batch_shape) + (NLIMBS,))


def to_ints(words) -> np.ndarray:
    """Limb tensor or array -> object ndarray of Python ints."""
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().to(I64).numpy()
    arr = np.asarray(words).astype(np.int64) & LIMB_MASK
    flat = arr.reshape(-1, arr.shape[-1])
    out = np.empty(flat.shape[0], dtype=object)
    for row in range(flat.shape[0]):
        value = 0
        for i in range(flat.shape[1]):
            value |= int(flat[row, i]) << (LIMB_BITS * i)
        out[row] = value
    return out.reshape(arr.shape[:-1])


def limbs(t: torch.Tensor) -> torch.Tensor:
    """Stored limbs (int32, or uint32 bytes viewed as int32) -> int64 limbs."""
    return t.to(I64) & LIMB_MASK


def zero(batch_shape=(), device=None) -> torch.Tensor:
    return torch.zeros(tuple(batch_shape) + (NLIMBS,), dtype=I64, device=device)


def _unit(n: int, device) -> torch.Tensor:
    out = torch.zeros(n, dtype=I64, device=device)
    out[0] = 1
    return out


# -- carry plumbing ------------------------------------------------------------------

def _normalize(raw: torch.Tensor) -> torch.Tensor:
    """Canonical limbs of `raw` (each limb < 2^40) modulo 2^(16 * n_limbs).

    Three parallel carry rounds bring every limb to at most 2^16; the last
    0/1 carries then ripple through runs of 0xFFFF limbs, which a cummax over
    the positions of the limbs that stop a ripple resolves without a loop."""
    for _ in range(3):
        carry = raw >> LIMB_BITS
        raw = raw & LIMB_MASK
        raw = torch.cat([raw[..., :1], raw[..., 1:] + carry[..., :-1]], dim=-1)
    n = raw.shape[-1]
    idx = torch.arange(n, device=raw.device).expand(raw.shape)
    stop = torch.where(raw != LIMB_MASK, idx, -1)
    last_stop = torch.cummax(stop, dim=-1).values
    # carry into limb i comes from the last stopping limb below i
    below = torch.cat([torch.full_like(last_stop[..., :1], -1),
                       last_stop[..., :-1]], dim=-1)
    gen = torch.gather(raw, -1, below.clamp(min=0)) > LIMB_MASK
    carry_in = ((below >= 0) & gen).to(I64)
    return (raw + carry_in) & LIMB_MASK


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _normalize(a + b)


def neg(a: torch.Tensor) -> torch.Tensor:
    return _normalize((a ^ LIMB_MASK) + _unit(a.shape[-1], a.device))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _normalize(a + (b ^ LIMB_MASK) + _unit(a.shape[-1], a.device))


# -- multiplication ------------------------------------------------------------------

_COLS_CACHE = {}


def _col_index(device) -> torch.Tensor:
    key = str(device)
    if key not in _COLS_CACHE:
        i = torch.arange(NLIMBS)
        _COLS_CACHE[key] = (i[:, None] + i[None, :]).reshape(-1).to(device)
    return _COLS_CACHE[key]


def _columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """32 column sums of the schoolbook product (each < 16 * 2^32)."""
    a, b = torch.broadcast_tensors(a, b)
    prods = (a[..., :, None] * b[..., None, :]).reshape(
        a.shape[:-1] + (NLIMBS * NLIMBS,))
    cols = torch.zeros(a.shape[:-1] + (2 * NLIMBS,), dtype=I64,
                       device=a.device)
    return cols.index_add_(-1, _col_index(a.device), prods)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Low 256 bits of a*b."""
    return _normalize(_columns(a, b)[..., :NLIMBS])


def mul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full 512-bit product as 32 limbs (for MULMOD)."""
    return _normalize(_columns(a, b))


# -- comparisons ---------------------------------------------------------------------

def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(a == b, dim=-1)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(a == 0, dim=-1)


def lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b (any equal limb counts): decided at the highest limb
    where the two differ."""
    a, b = torch.broadcast_tensors(a, b)
    idx = torch.arange(a.shape[-1], device=a.device).expand(a.shape)
    top = torch.where(a != b, idx, -1).amax(dim=-1, keepdim=True)
    at = top.clamp(min=0)
    less = torch.gather(a, -1, at) < torch.gather(b, -1, at)
    return ((top >= 0) & less)[..., 0]


def gt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return lt(b, a)


def sign_bit(a: torch.Tensor) -> torch.Tensor:
    return (a[..., NLIMBS - 1] >> (LIMB_BITS - 1)) & 1


def slt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    sa, sb = sign_bit(a), sign_bit(b)
    return torch.where(sa != sb, sa == 1, lt(a, b))


def sgt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return slt(b, a)


def low_word(x: torch.Tensor) -> torch.Tensor:
    """Word whose limb 0 is x (< 2^16) and whose other limbs are 0."""
    out = torch.zeros(x.shape + (NLIMBS,), dtype=I64, device=x.device)
    out[..., 0] = x.to(I64)
    return out


def bool_to_word(flag: torch.Tensor) -> torch.Tensor:
    return low_word(flag)


# -- bitwise -------------------------------------------------------------------------

def band(a, b):
    return a & b


def bor(a, b):
    return a | b


def bxor(a, b):
    return a ^ b


def bnot(a):
    return a ^ LIMB_MASK


# -- shifts --------------------------------------------------------------------------

def _small(word: torch.Tensor, limit: int):
    """(low limb as int64, oversized flag: any high limb set or low > limit)."""
    low = word[..., 0]
    return low, torch.any(word[..., 1:] != 0, dim=-1) | (low > limit)


def _shift_amount(shift_word: torch.Tensor) -> torch.Tensor:
    """Per-lane shift amount clamped to [0, 256]."""
    low, oversized = _small(shift_word, WORD_BITS)
    return torch.where(oversized, WORD_BITS, low)


def _take(value: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """value[..., src] with out-of-range sources reading 0."""
    ok = (src >= 0) & (src < NLIMBS)
    got = torch.gather(value, -1, src.clamp(0, NLIMBS - 1))
    return torch.where(ok, got, 0)


def shl(shift_word: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    amount = _shift_amount(shift_word)
    idx = torch.arange(NLIMBS, device=value.device)
    src = idx - (amount // LIMB_BITS)[..., None]
    bs = (amount % LIMB_BITS)[..., None]
    base = _take(value, src)
    below = _take(value, src - 1)
    out = torch.where(bs == 0, base,
                      ((base << bs) | (below >> (LIMB_BITS - bs))) & LIMB_MASK)
    return torch.where(amount[..., None] >= WORD_BITS, 0, out & LIMB_MASK)


def shr(shift_word: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    amount = _shift_amount(shift_word)
    idx = torch.arange(NLIMBS, device=value.device)
    src = idx + (amount // LIMB_BITS)[..., None]
    bs = (amount % LIMB_BITS)[..., None]
    base = _take(value, src)
    above = _take(value, src + 1)
    out = torch.where(bs == 0, base,
                      ((base >> bs) | (above << (LIMB_BITS - bs))) & LIMB_MASK)
    return torch.where(amount[..., None] >= WORD_BITS, 0, out)


def _high_bits_mask(amount: torch.Tensor) -> torch.Tensor:
    """Word whose top `amount` bits are 1 (amount in [0, 256])."""
    start_bit = WORD_BITS - amount
    limb_base = torch.arange(NLIMBS, device=amount.device) * LIMB_BITS
    rel = (start_bit[..., None] - limb_base).clamp(0, LIMB_BITS)
    return ((LIMB_MASK >> rel) << rel) & LIMB_MASK


def sar(shift_word: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    amount = _shift_amount(shift_word)
    negative = (sign_bit(value) == 1)[..., None]
    logical = shr(shift_word, value)
    out = torch.where(negative, logical | _high_bits_mask(amount), logical)
    fill = torch.where(negative, LIMB_MASK, 0).expand(value.shape)
    return torch.where(amount[..., None] >= WORD_BITS, fill, out)


# -- byte / signextend ---------------------------------------------------------------

def byte_op(index_word: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """EVM BYTE: big-endian byte `index` of value (0 = most significant)."""
    index, oversized = _small(index_word, 31)
    byte_from_lsb = 31 - index.clamp(0, 31)
    limb_val = torch.gather(value, -1, (byte_from_lsb // 2)[..., None])[..., 0]
    byte_val = torch.where(byte_from_lsb % 2 == 1, limb_val >> 8,
                           limb_val & 0xFF)
    return low_word(torch.where(oversized, 0, byte_val))


def signextend(size_word: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """EVM SIGNEXTEND: sign-extend from byte position `size` (0 = LSB)."""
    size, oversized = _small(size_word, 30)
    sign_bit_index = size * 8 + 7
    limb = (sign_bit_index // LIMB_BITS).clamp(0, NLIMBS - 1)
    bit = sign_bit_index % LIMB_BITS
    limb_val = torch.gather(value, -1, limb[..., None])[..., 0]
    negative = ((limb_val >> bit) & 1) == 1
    ext_mask = _high_bits_mask(WORD_BITS - 1 - sign_bit_index)
    extended = torch.where(negative[..., None], value | ext_mask,
                           value & bnot(ext_mask))
    return torch.where(oversized[..., None], value, extended)


# -- division ------------------------------------------------------------------------

def _sub_ge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b for canonical a >= b (borrows ripple like _normalize's carries)."""
    d = a - b
    n = d.shape[-1]
    idx = torch.arange(n, device=d.device).expand(d.shape)
    last_stop = torch.cummax(torch.where(d != 0, idx, -1), dim=-1).values
    below = torch.cat([torch.full_like(last_stop[..., :1], -1),
                       last_stop[..., :-1]], dim=-1)
    borrow = ((below >= 0)
              & (torch.gather(d, -1, below.clamp(min=0)) < 0)).to(I64)
    return (d - borrow) & LIMB_MASK


def _divmod_bits(a: torch.Tensor, b: torch.Tensor, n_bits: int):
    """Binary restoring division of an n_bits-wide dividend `a` by a 256-bit
    divisor `b`: (quotient mod 2^256, remainder). A zero divisor gives an
    all-ones quotient and remainder `a mod 2^256`; callers mask it."""
    shape = a.shape[:-1]
    b = b.expand(shape + (NLIMBS,))
    b17 = torch.cat([b, torch.zeros(shape + (1,), dtype=I64,
                                    device=b.device)], dim=-1)
    rem = torch.zeros(shape + (NLIMBS + 1,), dtype=I64, device=a.device)
    qbits = []
    for i in range(n_bits):
        bit_index = n_bits - 1 - i
        next_bit = (a[..., bit_index // LIMB_BITS] >> (bit_index % LIMB_BITS)) & 1
        # rem = (rem << 1) | next_bit, within 17 limbs (rem < 2b <= 2^257)
        up = rem >> (LIMB_BITS - 1)
        rem = (rem << 1) & LIMB_MASK
        rem = torch.cat([rem[..., :1] + next_bit[..., None],
                         rem[..., 1:] + up[..., :-1]], dim=-1)
        ge = ~lt(rem, b17)
        rem = torch.where(ge[..., None], _sub_ge(rem, b17), rem)
        if bit_index < WORD_BITS:
            qbits.append(ge)
    # qbits run from quotient bit 255 down to bit 0 (higher bits of a wide
    # dividend's quotient are dropped, as mod 2^256 asks)
    bits = torch.stack(qbits[::-1], dim=-1).to(I64)
    weights = 1 << torch.arange(LIMB_BITS, device=a.device)
    quotient = (bits.reshape(shape + (NLIMBS, LIMB_BITS)) * weights).sum(-1)
    return quotient, rem[..., :NLIMBS]


def divmod_(a: torch.Tensor, b: torch.Tensor):
    """EVM DIV/MOD: (a // b, a % b), both 0 when b == 0."""
    q, r = _divmod_bits(a, b, WORD_BITS)
    bz = is_zero(b)[..., None]
    return torch.where(bz, 0, q), torch.where(bz, 0, r)


def sdiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    sa, sb = sign_bit(a) == 1, sign_bit(b) == 1
    abs_a = torch.where(sa[..., None], neg(a), a)
    abs_b = torch.where(sb[..., None], neg(b), b)
    q, _ = _divmod_bits(abs_a, abs_b, WORD_BITS)
    q = torch.where((sa ^ sb)[..., None], neg(q), q)
    return torch.where(is_zero(b)[..., None], 0, q)


def smod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    sa, sb = sign_bit(a) == 1, sign_bit(b) == 1
    abs_a = torch.where(sa[..., None], neg(a), a)
    abs_b = torch.where(sb[..., None], neg(b), b)
    _, r = _divmod_bits(abs_a, abs_b, WORD_BITS)
    r = torch.where(sa[..., None], neg(r), r)
    return torch.where(is_zero(b)[..., None], 0, r)


def addmod(a: torch.Tensor, b: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """(a + b) % n over the true 257-bit sum."""
    a, b, n = torch.broadcast_tensors(a, b, n)
    raw = torch.cat([a + b, torch.zeros_like(a[..., :1])], dim=-1)
    _, r = _divmod_bits(_normalize(raw), n, WORD_BITS + 1)
    return torch.where(is_zero(n)[..., None], 0, r)


def mulmod(a: torch.Tensor, b: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """(a * b) % n over the true 512-bit product."""
    a, b, n = torch.broadcast_tensors(a, b, n)
    _, r = _divmod_bits(mul_wide(a, b), n, 2 * WORD_BITS)
    return torch.where(is_zero(n)[..., None], 0, r)


def exp(base: torch.Tensor, exponent: torch.Tensor) -> torch.Tensor:
    """base ** exponent mod 2^256 by square-and-multiply. The loop stops after
    the highest exponent bit set in any lane: later rounds cannot change the
    result."""
    base, exponent = torch.broadcast_tensors(base, exponent)
    acc = torch.zeros_like(base)
    acc[..., 0] = 1
    nz = exponent != 0
    if not bool(nz.any()):
        return acc
    top_limb = int(torch.where(nz, torch.arange(NLIMBS, device=base.device),
                               -1).max())
    n_bits = LIMB_BITS * top_limb + int(exponent[..., top_limb].max()).bit_length()
    pw = base
    for i in range(n_bits):
        take = ((exponent[..., i // LIMB_BITS] >> (i % LIMB_BITS)) & 1) == 1
        acc = torch.where(take[..., None], mul(acc, pw), acc)
        if i + 1 < n_bits:
            pw = mul(pw, pw)
    return acc


# -- byte packing --------------------------------------------------------------------

def to_bytes(words: torch.Tensor) -> torch.Tensor:
    """Limbs [..., 16] -> big-endian bytes [..., 32] (uint8)."""
    hi = (words >> 8) & 0xFF
    lo = words & 0xFF
    le = torch.stack([lo, hi], dim=-1).reshape(words.shape[:-1] + (32,))
    return le.flip(-1).to(torch.uint8)


def from_bytes(data: torch.Tensor) -> torch.Tensor:
    """Big-endian bytes [..., 32] -> int64 limbs [..., 16]."""
    le = data.flip(-1).to(I64)
    return le[..., 0::2] | (le[..., 1::2] << 8)
