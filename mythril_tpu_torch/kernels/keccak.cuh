// Keccak-256 as __device__ code (port of mythril_tpu/parallel/keccak.py:126-192;
// used by both forms of kernel K1, keccak.cu).
//
// A warp hashes up to 32 messages, one a thread (`hash_warp`): it stages
// up to four rate blocks of each at a time into shared memory
// (`stage_zero`, then `stage_copy`: coalesced 16-byte loads of the row
// where the row and its width are 16-byte aligned, bytes otherwise; bytes
// outside the row's valid range read 0), and each thread absorbs its own
// from there (`absorb`). The
// padding (0x01 after the message, 0x80 on the last byte of the last block,
// keccak.py:147-157) is made arithmetically, and only the message's own
// blocks are absorbed (the JAX version masks the rest). The sponge state is
// 25 native 64-bit lanes in registers: every loop over lanes is unrolled,
// so that no lane index, rotation or pi destination is computed at run
// time. Bound: operations (24 rounds per 136-byte block).
#pragma once

#include "common.cuh"

namespace keccak {

enum { RATE = 136, RATE_WORDS = 17, STATE_WORDS = 25 };

__constant__ uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

// the rho rotation of lane x + 5y
__host__ __device__ constexpr int rho(int i) {
    return i == 1 ? 1 : i == 2 ? 62 : i == 3 ? 28 : i == 4 ? 27 : i == 5 ? 36
         : i == 6 ? 44 : i == 7 ? 6 : i == 8 ? 55 : i == 9 ? 20 : i == 10 ? 3
         : i == 11 ? 10 : i == 12 ? 43 : i == 13 ? 25 : i == 14 ? 39
         : i == 15 ? 41 : i == 16 ? 45 : i == 17 ? 15 : i == 18 ? 21
         : i == 19 ? 8 : i == 20 ? 18 : i == 21 ? 2 : i == 22 ? 61
         : i == 23 ? 56 : i == 24 ? 14 : 0;
}

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int n) {
    return n ? (x << n) | (x >> (64 - n)) : x;
}

// keccak-f[1600] over lanes s[x + 5y]
__device__ __forceinline__ void keccak_f(uint64_t (&s)[STATE_WORDS]) {
    for (int round = 0; round < 24; ++round) {
        uint64_t c[5], b[STATE_WORDS];
        MTPU_UNROLL
        for (int x = 0; x < 5; ++x)
            c[x] = s[x] ^ s[x + 5] ^ s[x + 10] ^ s[x + 15] ^ s[x + 20];
        MTPU_UNROLL
        for (int x = 0; x < 5; ++x) {
            const uint64_t d = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
            MTPU_UNROLL
            for (int y = 0; y < 25; y += 5) s[x + y] ^= d;
        }
        MTPU_UNROLL
        for (int x = 0; x < 5; ++x) {
            MTPU_UNROLL
            for (int y = 0; y < 5; ++y)
                b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(s[x + 5 * y], rho(x + 5 * y));
        }
        MTPU_UNROLL
        for (int y = 0; y < 25; y += 5) {
            MTPU_UNROLL
            for (int x = 0; x < 5; ++x)
                s[x + y] = b[x + y] ^ (~b[(x + 1) % 5 + y] & b[(x + 2) % 5 + y]);
        }
        s[0] ^= RC[round];
    }
}

// blocks absorbed for a message of `len` bytes (none for a negative one,
// as keccak.py's floor division gives)
__host__ __device__ __forceinline__ long long blocks(long long len) {
    return len < 0 ? 0 : len / RATE + 1;
}

// A message: byte j < len is row[off + j] where 0 <= off + j < lim (lim at
// most the row's width `ncols`), else 0 (memory past msize,
// lockstep._mem_read).
struct Message {
    const uint8_t* row;
    long long ncols, off, lim, len;
};

// threads t of nt zero `bytes` (a multiple of 16) of a 16-byte aligned
// buffer
__device__ __forceinline__ void stage_zero(uint8_t* buf, int bytes, int t, int nt) {
    for (int i = t; i < bytes / 16; i += nt) reinterpret_cast<Vec16*>(buf)[i] = Vec16{0, 0, 0, 0};
}

// threads t of nt copy the message's bytes j in [first, first + n) that
// read a row byte to buf[j - first]; the others keep the zeros stage_zero
// wrote
__device__ __forceinline__ void stage_copy(uint8_t* buf, const Message& m, long long first,
                                           long long n, int t, int nt) {
    const long long end = first + n < m.len ? first + n : m.len;
    const long long lo = m.off + first > 0 ? m.off + first : 0;
    const long long hi = m.off + end < m.lim ? m.off + end : m.lim;
    const long long shift = m.off + first;  // buf[abs - shift] takes row[abs]
    if (((reinterpret_cast<uintptr_t>(m.row) | static_cast<uintptr_t>(m.ncols)) & 15) == 0) {
        // 16-byte chunks of the row; hi <= ncols, so every chunk lies in it
        for (long long c = (lo & ~15LL) + 16LL * t; c < hi; c += 16LL * nt) {
            const Vec16 v = *reinterpret_cast<const Vec16*>(m.row + c);
            const uint32_t w[4] = {v.x, v.y, v.z, v.w};
            MTPU_UNROLL
            for (int k = 0; k < 16; ++k)
                if (c + k >= lo && c + k < hi)
                    buf[c + k - shift] = static_cast<uint8_t>(w[k / 4] >> (8 * (k % 4)));
        }
    } else {
        for (long long at = lo + t; at < hi; at += nt) buf[at - shift] = m.row[at];
    }
}

// absorb the message's blocks [b0, b1), staged at buf (block b at
// buf + (b - b0) * RATE, 8-byte aligned), with its padding
__device__ __forceinline__ void absorb(uint64_t (&s)[STATE_WORDS], const uint8_t* buf,
                                       long long b0, long long b1, long long len) {
    const long long last = blocks(len) - 1;
    for (long long b = b0; b < b1; ++b) {
        const uint64_t* words = reinterpret_cast<const uint64_t*>(buf + (b - b0) * RATE);
        MTPU_UNROLL
        for (int w = 0; w < RATE_WORDS; ++w) {
            uint64_t x = words[w];
            const long long at = len - (b * RATE + 8 * w);  // the 0x01 byte's place in x
            if (at >= 0 && at < 8) x ^= 1ULL << (8 * at);
            if (w == RATE_WORDS - 1 && b == last) x ^= 0x80ULL << 56;
            s[w] ^= x;
        }
        keccak_f(s);
    }
}

// the digest: the first 32 bytes of the state, little-endian
__device__ __forceinline__ void write_digest(const uint64_t (&s)[STATE_WORDS], uint8_t* out) {
    if ((reinterpret_cast<uintptr_t>(out) & 7) == 0) {
        MTPU_UNROLL
        for (int w = 0; w < 4; ++w) reinterpret_cast<uint64_t*>(out)[w] = s[w];
        return;
    }
    MTPU_UNROLL
    for (int k = 0; k < 32; ++k) out[k] = static_cast<uint8_t>(s[k / 8] >> (8 * (k % 8)));
}

// A message a warp may hash: `hashed` false for none (a masked row, or a
// thread past the warp's messages), which gives a zero digest.
struct Job {
    bool hashed;
    Message m;
};

enum { WINDOW_BLOCKS = 4, WINDOW_BYTES = WINDOW_BLOCKS * RATE, WARP = 32 };

// A warp hashes `per` messages (1 to 32), job(k) the k-th, one a thread:
// windows of up to WINDOW_BLOCKS rate blocks of every message are staged
// in turn by every thread through buf (per * WINDOW_BYTES, 16-byte
// aligned), then thread k absorbs message k's and permutes, so that `per`
// permutations run side by side. A thread whose `out` is not null writes
// its message's digest there. Every thread of the warp calls it.
template <class J>
__device__ __forceinline__ void hash_warp(int per, J job, uint8_t* buf, uint8_t* out) {
    const int t = threadIdx.x % WARP;
    const Job mine = t < per ? job(t) : Job{};
    const long long own = mine.hashed ? blocks(mine.m.len) : 0;
    long long most = own;  // the warp's most blocks
    for (int offset = WARP / 2; offset > 0; offset >>= 1) {
        const long long other = __shfl_xor_sync(0xffffffffu, most, offset);
        most = other > most ? other : most;
    }
    uint64_t s[STATE_WORDS] = {};
    for (long long b0 = 0; b0 < most; b0 += WINDOW_BLOCKS) {
        stage_zero(buf, per * WINDOW_BYTES, t, WARP);
        __syncwarp();
        for (int k = 0; k < per; ++k) {
            const Job other = job(k);
            if (other.hashed && b0 < blocks(other.m.len))
                stage_copy(buf + k * WINDOW_BYTES, other.m, b0 * RATE, WINDOW_BYTES, t, WARP);
        }
        __syncwarp();
        if (b0 < own)
            absorb(s, buf + t * WINDOW_BYTES, b0,
                   b0 + WINDOW_BLOCKS < own ? b0 + WINDOW_BLOCKS : own, mine.m.len);
        __syncwarp();
    }
    if (out) write_digest(s, out);
}

}  // namespace keccak
