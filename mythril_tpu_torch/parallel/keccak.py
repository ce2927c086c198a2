"""Batched keccak-256: the plain PyTorch twin and the entry to kernel K1.

Port of mythril_tpu/parallel/keccak.py:137 (`keccak256` over `keccak_f`).
Each lane carries its own byte length; the padding (0x01 ... 0x80) is made
arithmetically per lane and block `b` is absorbed only where
`b < nblocks(lane)`, exactly as keccak.py:147-183 does.

On a CUDA tensor `keccak256` launches the hand-written kernel
(`kernels/keccak.cu`, one thread per message, native 64-bit lanes); on a CPU
tensor it runs `keccak256_reference`, which holds the state as int64 lanes
(torch has no uint64 arithmetic: right shifts are masked)."""

from __future__ import annotations

import torch

RATE = 136  # keccak-256 rate in bytes
LANES = RATE // 8  # 17 input lanes per block

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rotation offsets r[x][y] at index x + 5*y
_ROT = [0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39,
        41, 45, 15, 21, 8, 18, 2, 61, 56, 14]
# rho+pi: lane `src` moves to _PI_DST[src]
_PI_DST = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_DST[_x + 5 * _y] = _y + 5 * ((2 * _x + 3 * _y) % 5)


def _signed(v: int) -> int:
    return v - (1 << 64) if v >> 63 else v


class _Tables:
    def __init__(self, device):
        def t(values):
            return torch.tensor(values, dtype=torch.int64, device=device)

        self.rc = [_signed(c) for c in _ROUND_CONSTANTS]
        src_of = [0] * 25
        for src, dst in enumerate(_PI_DST):
            src_of[dst] = src
        self.pi_src = t(src_of)
        self.pi_rot = t([_ROT[s] for s in src_of])
        x = torch.arange(25, device=device) % 5
        row = torch.arange(25, device=device) - x
        self.chi1 = row + (x + 1) % 5
        self.chi2 = row + (x + 2) % 5
        self.col = x


_TABLES = {}


def _tables(device) -> _Tables:
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = _Tables(device)
    return _TABLES[key]


def _rotl(x: torch.Tensor, n) -> torch.Tensor:
    """64-bit rotate left of int64 lanes by n in [0, 64)."""
    n = torch.as_tensor(n, dtype=torch.int64, device=x.device)
    low_mask = (torch.ones_like(n) << n) - 1
    rot = (x << n) | ((x >> ((64 - n) % 64)) & low_mask)
    return torch.where(n == 0, x, rot)


def keccak_f(state: torch.Tensor) -> torch.Tensor:
    """keccak-f[1600] over int64 lanes [..., 25] (index x + 5*y)."""
    tab = _tables(state.device)
    for rc in tab.rc:
        c = state[..., 0:5] ^ state[..., 5:10] ^ state[..., 10:15] \
            ^ state[..., 15:20] ^ state[..., 20:25]
        d = c[..., [4, 0, 1, 2, 3]] ^ _rotl(c[..., [1, 2, 3, 4, 0]], 1)
        state = state ^ d[..., tab.col]
        b = _rotl(state[..., tab.pi_src], tab.pi_rot)
        state = b ^ (~b[..., tab.chi1] & b[..., tab.chi2])
        state = torch.cat([state[..., :1] ^ rc, state[..., 1:]], dim=-1)
    return state


def keccak256_reference(data: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Plain batched keccak-256.

    data:   uint8[..., max_len] messages (bytes past `length` ignored)
    length: int32[...] per-lane length, 0 <= length <= max_len
    returns uint8[..., 32] digests."""
    batch_shape = data.shape[:-1]
    max_len = data.shape[-1]
    n_blocks = (max_len + 1 + RATE - 1) // RATE
    padded_size = n_blocks * RATE
    dev = data.device
    length = length.to(torch.int64)

    j = torch.arange(padded_size, device=dev)
    padded_len = ((length + 1 + RATE - 1) // RATE) * RATE
    base = torch.zeros(batch_shape + (padded_size,), dtype=torch.int64,
                       device=dev)
    base[..., :max_len] = data.to(torch.int64)
    base = torch.where(j < length[..., None], base, 0)
    base = torch.where(j == length[..., None], 0x01, base)
    base = torch.where(j == padded_len[..., None] - 1, base | 0x80, base)

    blocks = base.reshape(batch_shape + (n_blocks, LANES, 8))
    shifts = 8 * torch.arange(8, device=dev)
    block_lanes = (blocks << shifts).sum(-1)  # disjoint bits: sum == or
    lane_blocks = padded_len // RATE

    state = torch.zeros(batch_shape + (25,), dtype=torch.int64, device=dev)
    pad = torch.zeros(batch_shape + (25 - LANES,), dtype=torch.int64,
                      device=dev)
    for b in range(n_blocks):
        absorbed = keccak_f(state ^ torch.cat([block_lanes[..., b, :], pad],
                                              dim=-1))
        state = torch.where((b < lane_blocks)[..., None], absorbed, state)

    out = (state[..., 0:4, None] >> shifts) & 0xFF
    return out.reshape(batch_shape + (32,)).to(torch.uint8)


def keccak256(data: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Batched keccak-256: kernel K1 on CUDA tensors, the twin on the CPU."""
    if data.is_cuda:
        from ..kernels import ops

        return ops.keccak256(data, length)
    return keccak256_reference(data, length)
