// 256-bit EVM word arithmetic as __device__ functions (port of
// mythril_tpu/parallel/words.py:31-400, inlined into kernel K2).
//
// Inside a thread a word is 8 little-endian 32-bit limbs (`W`) with native
// carries through 64-bit products; at every memory boundary it is the JAX
// package's layout, 16 little-endian 16-bit limbs held as uint32 (stored in
// int32 tensors). The semantics are the EVM's: DIV/MOD/SDIV/SMOD and
// ADDMOD/MULMOD by zero give 0, SDIV(INT_MIN, -1) = INT_MIN, shifts of 256
// or more give 0 (or all ones for a negative SAR), BYTE and SIGNEXTEND with
// an out-of-range index leave 0 and the value. Bound: operations (division
// is a 256- or 512-step restoring loop, EXP a square-and-multiply up to the
// exponent's top bit), all in registers and local memory.
#pragma once

#include "common.cuh"

struct W {
    uint32_t l[8];
};

__device__ __forceinline__ W w_zero() {
    W r;
    for (int i = 0; i < 8; ++i) r.l[i] = 0;
    return r;
}

__device__ __forceinline__ W w_u64(uint64_t x) {
    W r = w_zero();
    r.l[0] = static_cast<uint32_t>(x);
    r.l[1] = static_cast<uint32_t>(x >> 32);
    return r;
}

// 16 stored 16-bit limbs -> W
__device__ __forceinline__ W w_load16(const int32_t* p) {
    W r;
    for (int i = 0; i < 8; ++i)
        r.l[i] = (static_cast<uint32_t>(p[2 * i]) & 0xFFFFu)
                 | ((static_cast<uint32_t>(p[2 * i + 1]) & 0xFFFFu) << 16);
    return r;
}

// W -> 16 limbs of 16 bits
__device__ __forceinline__ void w_to16(const W& w, uint32_t* out) {
    for (int i = 0; i < 8; ++i) {
        out[2 * i] = w.l[i] & 0xFFFFu;
        out[2 * i + 1] = w.l[i] >> 16;
    }
}

__device__ __forceinline__ bool w_is_zero(const W& a) {
    uint32_t acc = 0;
    for (int i = 0; i < 8; ++i) acc |= a.l[i];
    return acc == 0;
}

__device__ __forceinline__ bool w_eq(const W& a, const W& b) {
    uint32_t acc = 0;
    for (int i = 0; i < 8; ++i) acc |= a.l[i] ^ b.l[i];
    return acc == 0;
}

__device__ __forceinline__ bool w_lt(const W& a, const W& b) {
    for (int i = 7; i >= 0; --i)
        if (a.l[i] != b.l[i]) return a.l[i] < b.l[i];
    return false;
}

__device__ __forceinline__ bool w_neg_sign(const W& a) {
    return (a.l[7] >> 31) != 0;
}

__device__ __forceinline__ bool w_slt(const W& a, const W& b) {
    bool sa = w_neg_sign(a), sb = w_neg_sign(b);
    return sa != sb ? sa : w_lt(a, b);
}

// value of a word if it is <= limit, else limit + 1 (amounts and indices)
__device__ __forceinline__ uint32_t w_small(const W& a, uint32_t limit) {
    for (int i = 1; i < 8; ++i)
        if (a.l[i]) return limit + 1;
    return a.l[0] > limit ? limit + 1 : a.l[0];
}

// low 32 bits and whether no bit >= 2^32 is set (lockstep._word_to_i64)
__device__ __forceinline__ long long w_low32(const W& a, bool* fits) {
    bool f = true;
    for (int i = 1; i < 8; ++i) f = f && a.l[i] == 0;
    *fits = f;
    return static_cast<long long>(a.l[0]);
}

__device__ __forceinline__ W w_add(const W& a, const W& b) {
    W r;
    uint64_t carry = 0;
    for (int i = 0; i < 8; ++i) {
        uint64_t t = static_cast<uint64_t>(a.l[i]) + b.l[i] + carry;
        r.l[i] = static_cast<uint32_t>(t);
        carry = t >> 32;
    }
    return r;
}

__device__ __forceinline__ W w_sub(const W& a, const W& b) {
    W r;
    uint64_t borrow = 0;
    for (int i = 0; i < 8; ++i) {
        uint64_t t = static_cast<uint64_t>(a.l[i]) - b.l[i] - borrow;
        r.l[i] = static_cast<uint32_t>(t);
        borrow = (t >> 63) & 1;
    }
    return r;
}

__device__ __forceinline__ W w_neg(const W& a) { return w_sub(w_zero(), a); }

__device__ __forceinline__ W w_not(const W& a) {
    W r;
    for (int i = 0; i < 8; ++i) r.l[i] = ~a.l[i];
    return r;
}

__device__ __forceinline__ W w_mul(const W& a, const W& b) {
    uint32_t r[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 8; ++i) {
        uint64_t carry = 0;
        for (int j = 0; i + j < 8; ++j) {
            uint64_t t = static_cast<uint64_t>(a.l[i]) * b.l[j] + r[i + j]
                         + carry;
            r[i + j] = static_cast<uint32_t>(t);
            carry = t >> 32;
        }
    }
    W out;
    for (int i = 0; i < 8; ++i) out.l[i] = r[i];
    return out;
}

// full 512-bit product, 16 little-endian 32-bit limbs
__device__ __forceinline__ void w_mul_wide(const W& a, const W& b,
                                           uint32_t* r) {
    for (int i = 0; i < 16; ++i) r[i] = 0;
    for (int i = 0; i < 8; ++i) {
        uint64_t carry = 0;
        for (int j = 0; j < 8; ++j) {
            uint64_t t = static_cast<uint64_t>(a.l[i]) * b.l[j] + r[i + j]
                         + carry;
            r[i + j] = static_cast<uint32_t>(t);
            carry = t >> 32;
        }
        r[i + 8] = static_cast<uint32_t>(carry);
    }
}

__device__ __forceinline__ W w_shl(uint32_t amount, const W& v) {
    W r = w_zero();
    if (amount >= 256) return r;
    int limbs = amount / 32, bits = amount % 32;
    for (int i = 7; i >= limbs; --i) {
        uint32_t hi = v.l[i - limbs] << bits;
        uint32_t lo = (bits && i - limbs - 1 >= 0)
                          ? v.l[i - limbs - 1] >> (32 - bits) : 0;
        r.l[i] = hi | lo;
    }
    return r;
}

__device__ __forceinline__ W w_shr(uint32_t amount, const W& v) {
    W r = w_zero();
    if (amount >= 256) return r;
    int limbs = amount / 32, bits = amount % 32;
    for (int i = 0; i + limbs < 8; ++i) {
        uint32_t lo = v.l[i + limbs] >> bits;
        uint32_t hi = (bits && i + limbs + 1 < 8)
                          ? v.l[i + limbs + 1] << (32 - bits) : 0;
        r.l[i] = lo | hi;
    }
    return r;
}

__device__ __forceinline__ W w_sar(uint32_t amount, const W& v) {
    bool negative = w_neg_sign(v);
    if (amount >= 256) {
        W r;
        for (int i = 0; i < 8; ++i) r.l[i] = negative ? 0xFFFFFFFFu : 0;
        return r;
    }
    W r = w_shr(amount, v);
    if (negative && amount) {
        // fill the top `amount` bits
        W ones;
        for (int i = 0; i < 8; ++i) ones.l[i] = 0xFFFFFFFFu;
        W fill = w_shl(256 - amount, ones);
        for (int i = 0; i < 8; ++i) r.l[i] |= fill.l[i];
    }
    return r;
}

// EVM BYTE: big-endian byte `index` of value (0 = most significant)
__device__ __forceinline__ W w_byte(const W& index, const W& v) {
    uint32_t i = w_small(index, 31);
    if (i > 31) return w_zero();
    uint32_t from_lsb = 31 - i;
    return w_u64((v.l[from_lsb / 4] >> (8 * (from_lsb % 4))) & 0xFFu);
}

// EVM SIGNEXTEND: extend from the sign bit of byte `size` (0 = LSB)
__device__ __forceinline__ W w_signextend(const W& size, const W& v) {
    uint32_t s = w_small(size, 30);
    if (s > 30) return v;
    uint32_t bit = s * 8 + 7;
    bool negative = (v.l[bit / 32] >> (bit % 32)) & 1;
    W r;
    for (int i = 0; i < 8; ++i) {
        uint32_t lo_bit = 32 * i;  // first bit of limb i
        uint32_t keep;             // mask of the bits at or below `bit`
        if (bit >= lo_bit + 31) keep = 0xFFFFFFFFu;
        else if (bit < lo_bit) keep = 0;
        else keep = (2u << (bit - lo_bit)) - 1;
        r.l[i] = negative ? (v.l[i] | ~keep) : (v.l[i] & keep);
    }
    return r;
}

// Restoring division of an n-limb (32-bit) dividend by a nonzero 256-bit
// divisor: quotient mod 2^256 and remainder. Leading zero bits of the
// dividend are skipped (they leave both results unchanged).
__device__ __forceinline__ void w_divmod_n(const uint32_t* num, int n,
                                           const W& d, W* q, W* r) {
    uint32_t rem[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    W quo = w_zero();
    int top = 32 * n - 1;
    while (top >= 0 && !((num[top / 32] >> (top % 32)) & 1)) --top;
    for (int bit = top; bit >= 0; --bit) {
        // rem = rem << 1 | next bit (rem < 2d < 2^257 fits 9 limbs)
        for (int i = 8; i > 0; --i) rem[i] = (rem[i] << 1) | (rem[i - 1] >> 31);
        rem[0] = (rem[0] << 1) | ((num[bit / 32] >> (bit % 32)) & 1);
        bool ge = rem[8] != 0;
        if (!ge) {
            ge = true;
            for (int i = 7; i >= 0; --i)
                if (rem[i] != d.l[i]) { ge = rem[i] > d.l[i]; break; }
        }
        if (ge) {
            uint64_t borrow = 0;
            for (int i = 0; i < 9; ++i) {
                uint64_t t = static_cast<uint64_t>(rem[i])
                             - (i < 8 ? d.l[i] : 0) - borrow;
                rem[i] = static_cast<uint32_t>(t);
                borrow = (t >> 63) & 1;
            }
            if (bit < 256) quo.l[bit / 32] |= 1u << (bit % 32);
        }
    }
    *q = quo;
    for (int i = 0; i < 8; ++i) r->l[i] = rem[i];
}

__device__ __forceinline__ void w_divmod(const W& a, const W& b, W* q, W* r) {
    if (w_is_zero(b)) { *q = w_zero(); *r = w_zero(); return; }
    w_divmod_n(a.l, 8, b, q, r);
}

// DIV / SDIV / MOD / SMOD with the EVM's zero-divisor and sign rules
__device__ __forceinline__ W w_div_family(int op, const W& a, const W& b) {
    if (w_is_zero(b)) return w_zero();
    bool signed_op = op == OP_SDIV || op == OP_SMOD;
    bool sa = w_neg_sign(a), sb = w_neg_sign(b);
    W na = (signed_op && sa) ? w_neg(a) : a;
    W nb = (signed_op && sb) ? w_neg(b) : b;
    W q, r;
    w_divmod_n(na.l, 8, nb, &q, &r);
    switch (op) {
        case OP_DIV: return q;
        case OP_MOD: return r;
        case OP_SDIV: return (sa != sb) ? w_neg(q) : q;
        default: return sa ? w_neg(r) : r;
    }
}

__device__ __forceinline__ W w_addmod(const W& a, const W& b, const W& n) {
    if (w_is_zero(n)) return w_zero();
    uint32_t sum[9];
    uint64_t carry = 0;
    for (int i = 0; i < 8; ++i) {
        uint64_t t = static_cast<uint64_t>(a.l[i]) + b.l[i] + carry;
        sum[i] = static_cast<uint32_t>(t);
        carry = t >> 32;
    }
    sum[8] = static_cast<uint32_t>(carry);
    W q, r;
    w_divmod_n(sum, 9, n, &q, &r);
    return r;
}

__device__ __forceinline__ W w_mulmod(const W& a, const W& b, const W& n) {
    if (w_is_zero(n)) return w_zero();
    uint32_t prod[16];
    w_mul_wide(a, b, prod);
    W q, r;
    w_divmod_n(prod, 16, n, &q, &r);
    return r;
}

__device__ __forceinline__ W w_exp(const W& base, const W& exponent) {
    W acc = w_u64(1), pw = base;
    int top = 255;
    while (top >= 0 && !((exponent.l[top / 32] >> (top % 32)) & 1)) --top;
    for (int i = 0; i <= top; ++i) {
        if ((exponent.l[i / 32] >> (i % 32)) & 1) acc = w_mul(acc, pw);
        if (i < top) pw = w_mul(pw, pw);
    }
    return acc;
}

// 32 big-endian bytes <-> W
__device__ __forceinline__ W w_from_be(const uint8_t* bytes) {
    W r = w_zero();
    for (int k = 0; k < 32; ++k) {
        int from_lsb = 31 - k;
        r.l[from_lsb / 4] |= static_cast<uint32_t>(bytes[k])
                             << (8 * (from_lsb % 4));
    }
    return r;
}

// 32 big-endian bytes -> 16 stored 16-bit limbs (words.from_bytes,
// words.py:395)
__device__ __forceinline__ void limbs16_from_be(const uint8_t* bytes,
                                                int32_t* out) {
    for (int i = 0; i < 16; ++i)
        out[i] = bytes[31 - 2 * i] | (bytes[30 - 2 * i] << 8);
}

// big-endian byte k of 16 stored 16-bit limbs (words.to_bytes)
__device__ __forceinline__ uint8_t limbs16_be_byte(const uint32_t* limbs,
                                                   int k) {
    int from_lsb = 31 - k;
    uint32_t limb = limbs[from_lsb / 2];
    return static_cast<uint8_t>((from_lsb & 1) ? (limb >> 8) : limb);
}
