// Keccak-256 of one message per thread, as a __device__ function (port of
// mythril_tpu/parallel/keccak.py:126-192; used by kernel K1).
//
// The sponge state is 25 native 64-bit lanes in registers. Padding is made
// per message arithmetically exactly as keccak.py:147-157 does it (0x01
// after the message, 0x80 on the last byte of the last block), and only
// the message's own blocks are absorbed (the JAX version masks the rest).
// Bound: operations (24 rounds per 136-byte block).
#pragma once

#include "common.cuh"

__constant__ uint64_t KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int n) {
    return n ? (x << n) | (x >> (64 - n)) : x;
}

// keccak-f[1600] over lanes s[x + 5*y]
__device__ __forceinline__ void keccak_f(uint64_t* s) {
    const int rot[25] = {0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43,
                         25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14};
    for (int round = 0; round < 24; ++round) {
        uint64_t c[5], b[25];
        for (int x = 0; x < 5; ++x)
            c[x] = s[x] ^ s[x + 5] ^ s[x + 10] ^ s[x + 15] ^ s[x + 20];
        for (int x = 0; x < 5; ++x) {
            uint64_t d = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
            for (int y = 0; y < 25; y += 5) s[x + y] ^= d;
        }
        for (int x = 0; x < 5; ++x)
            for (int y = 0; y < 5; ++y)
                b[y + 5 * ((2 * x + 3 * y) % 5)] =
                    rotl64(s[x + 5 * y], rot[x + 5 * y]);
        for (int y = 0; y < 25; y += 5)
            for (int x = 0; x < 5; ++x)
                s[x + y] = b[x + y] ^ (~b[(x + 1) % 5 + y] & b[(x + 2) % 5 + y]);
        s[0] ^= KECCAK_RC[round];
    }
}

// Digest of `len` bytes read as row[offset + j]; bytes whose index falls
// outside [0, limit) read 0 (memory beyond msize, lockstep._mem_read).
__device__ __forceinline__ void keccak256_dev(const uint8_t* row,
                                              long long offset,
                                              long long limit, int len,
                                              uint8_t* out) {
    const int rate = 136;
    const int padded = ((len + 1 + rate - 1) / rate) * rate;
    uint64_t s[25];
    for (int i = 0; i < 25; ++i) s[i] = 0;
    for (int block = 0; block < padded / rate; ++block) {
        for (int w = 0; w < rate / 8; ++w) {
            uint64_t lane = 0;
            for (int k = 0; k < 8; ++k) {
                int j = block * rate + w * 8 + k;
                uint32_t byte = 0;
                if (j < len) {
                    long long idx = offset + j;
                    byte = (idx >= 0 && idx < limit) ? row[idx] : 0;
                } else if (j == len) {
                    byte = 0x01;
                }
                if (j == padded - 1) byte |= 0x80;
                lane |= static_cast<uint64_t>(byte) << (8 * k);
            }
            s[w] ^= lane;
        }
        keccak_f(s);
    }
    for (int w = 0; w < 4; ++w)
        for (int k = 0; k < 8; ++k)
            out[8 * w + k] = static_cast<uint8_t>(s[w] >> (8 * k));
}
