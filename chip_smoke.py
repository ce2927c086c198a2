#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (mythril_tpu_torch) on one card.

    python3 chip_smoke.py        # from the root of a checkout; one CUDA card

It builds the eight hand-written kernels from the checkout's sources, holds
each against its plain PyTorch version on the card, then drives the port's
main device path, the frontier's drain loop (`DeviceFrontier.run` around
`symstep.run_chunk`), at the frontier's default geometry on a 2^12-path
contract until the tree is drained. Every phase prints one JSON line; any
mismatch raises, and the run exits non-zero. Phases:

  1. the card's name and power limit (nvidia-smi);
  2. K1 keccak vs `keccak256_reference`: 4096 random messages of 0..512
     bytes, and the SHA3 shape of the main path (128 rows of a 4096-byte
     memory, ranges clipped at msize);
  3. K2 evm_step vs `step_reference`: bench.py's concrete loop at 512 lanes
     for 256 steps and a program reaching every expensive family at 128
     lanes, every leaf compared after each chunk of 32 steps;
  4. K3 arena_alloc vs its twins: a random want-mask sequence up to and
     past capacity;
  5. K4 with K1-K3 vs the twins on contracts that walk the symbolic planes
     (memory round trips, symbolic SSTORE, a cold SLOAD pause, a concrete
     SHA3, escapes on dirty memory) for 2 chunks at the default geometry;
  6. the slice: `assemble(dispatcher({"stress()": branchy(12)}))` at 128
     lanes, chunk 64, `build_batch` defaults, 64 conds, the default arena,
     3072 stack and 1024 escape rows, one RUNNING lane with symbolic env.
     The first 8 chunks run twice, through the kernels and through the plain
     twins on the card, and every leaf is compared. The escape buffer is
     drained (K6 `reset_esc`) after each chunk; the totals must equal the
     JAX reference's (computed once with mythril_tpu on the CPU);
  7. frontier_programs: K5-K8 vs their twins on the same contract two
     chunks in (1024 escape rows, 680+ of them live): the summary, the
     drain's maxima and pack at its real index and quantized widths, the
     escape reset, a gather and a scatter of 32 lanes, and the arena delta
     of the first drain; each timed beside its twin and, where one exists,
     the PyTorch call that computes the same function;
  8. frontier: `DeviceFrontier(128).run` on the same contract at the
     default budgets until the tree drains (K1-K6 and K8 on the main path);
     its counters and the sha256 digests of its deferred row blocks and of
     its arena mirror must equal the JAX `_Frontier`'s;
  9. frontier_spill: 16 lanes, 32 stack rows, branchy(10): the deadlock
     spill and the host reseed (K7) run on the card, checked the same way;
 10. the kernels line: each kernel's launches on the driver phases (8 and
     9), its time, its plain version's time, the least time the card could
     take and the library call's time.

The last line is {"ok": true, "device": {...}}. Without a CUDA device the
script exits 2 and prints no result."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from mythril_tpu_torch.frontends.asm import assemble, dispatcher
from mythril_tpu_torch.kernels import build, ops
from mythril_tpu_torch.parallel import arena as A
from mythril_tpu_torch.parallel import batch as B
from mythril_tpu_torch.parallel import (convert, frontier, keccak, lockstep,
                                        symstep)

# ---- the frontier's default geometry (mythril_tpu/parallel/frontier.py) ---------
LANES = 128          # DEFAULT_LANES (MYTHRIL_TPU_LANES)
CHUNK = 64           # CHUNK
MAX_CONDS = 64       # MAX_CONDS
STACK_ROWS = 24 * LANES   # _new_sched: min(1<<17, 24 * lanes, budget)
ESC_ROWS = 8 * LANES      # _new_sched: min(1<<16, 8 * lanes, budget)
N_BRANCHES = 12
COMPARE_CHUNKS = 8
TIMING_CHUNK = 2      # the per-kernel timing replays this chunk
MAX_CHUNKS = 200

#: the JAX reference drain of the same contract at the same geometry
#: (mythril_tpu.parallel.symstep.run_chunk on the CPU, escape count zeroed
#: after each chunk): one escape per path (2^12) plus the dispatcher's
#: fallback STOP
EXPECTED = {"escapes": 4097, "forks": 4096, "pushes": 3968, "pops": 3968,
            "executed": 36868, "arena_n": 12291, "n_const": 4097}

#: the JAX reference of the drain loop at the frontier's default budgets and
#: of the reduced-pool run: `mythril_tpu.parallel.frontier._Frontier(
#: laser_evm=None, n_lanes=...)` on the CPU with `telemetry_enabled` and
#: `state_merge` set False on the instance (and `stack_bytes` = 32 rows x
#: 39306 bytes for the spill run), `run(state, planes)` on the lanes
#: `DeviceFrontier.seed` makes from one seed (code, {}, False, 10**7, 0).
#: Chunks, drains and frozen lanes are counted by wrapping
#: `symstep.run_chunk`, `_fetch_escapes` and `_defer_lanes`; the digests are
#: `frontier.deferred_digest(_Frontier.deferred)` and
#: `frontier.mirror_digest(_Frontier.harena)`.
#: tests/test_torch_frontier.py recomputes both with JAX and checks them.
EXPECTED_FRONTIER = {
    "chunks": 8, "drains": 4, "drained_rows": 3713, "frozen_rows": 384,
    "spilled": 0, "reseeded": 0, "lane_steps": 36868, "forks": 4096,
    "stack_pushes": 3583, "stack_pops": 3583, "deferred_blocks": 7,
    "deferred_rows": 4097, "mirror_n": 12291, "mirror_n_const": 4097,
    "deferred_sha256":
        "44841bb4765ba59781afd31e1292960e791e41ade47e821f4dca49926b9f394d",
    "mirror_sha256":
        "5483260d1d0e0a6acb12f7b4bfacd9f86122f53a4627d0b21e4bc850b9f68da4"}
SPILL_LANES = 16
SPILL_STACK_ROWS = 32
#: branchy(8) never deadlocks at these pools (the JAX run spills nothing);
#: branchy(10) does
SPILL_BRANCHES = 10
EXPECTED_SPILL = {
    "chunks": 9, "drains": 6, "drained_rows": 649, "frozen_rows": 34,
    "spilled": 8, "reseeded": 8, "lane_steps": 5692, "forks": 682,
    "stack_pushes": 338, "stack_pops": 338, "deferred_blocks": 9,
    "deferred_rows": 683, "mirror_n": 2049, "mirror_n_const": 683,
    "deferred_sha256":
        "0c25dae9844a0f01a578c3796f24b5e37fc84bcb8ab24d4b2ff81e0f5d2c87b2",
    "mirror_sha256":
        "215f5550dfb3a0f8dc7073eccfe283295fcb225bf151e1ad5d84a00c0df9e2b2"}

# ---- the card's published peaks (H100 SXM data sheet, dense, 700 W) -------------
PEAK_BYTES_PER_S = 3.35e12
#: 32-bit integer work is bounded by the CUDA cores' float32 rate, the
#: highest scalar rate in the data sheet (an optimistic, hence safe, bound)
PEAK_OPS_PER_S = 67e12

#: bench.py's concrete loop (counter += 1 stored to memory until 3,000,000)
BENCH_LOOP = bytes.fromhex(
    "6000" "5b" "6001" "01" "80" "6000" "52"
    "80" "63002dc6c0" "11" "6002" "57" "00")
BENCH_GEOMETRY = dict(stack_slots=16, memory_bytes=64, calldata_bytes=32,
                      retdata_bytes=32, storage_slots=4, tstore_slots=2)

#: every expensive family and memory/storage path: x, y, n from calldata
#: words 0..2 and the SHA3 length from word 3
MIXED_SOURCE = """
PUSH1 0x00
CALLDATALOAD
PUSH1 0x20
CALLDATALOAD
DUP2
DUP2
DIV
PUSH1 0x00
SSTORE
DUP2
DUP2
SDIV
PUSH1 0x01
SSTORE
DUP2
DUP2
MOD
PUSH1 0x02
SSTORE
DUP2
DUP2
SMOD
PUSH1 0x03
SSTORE
PUSH1 0x40
CALLDATALOAD
DUP3
DUP3
ADDMOD
PUSH1 0x04
SSTORE
PUSH1 0x40
CALLDATALOAD
DUP3
DUP3
MULMOD
PUSH1 0x05
SSTORE
DUP2
DUP2
EXP
PUSH1 0x06
SSTORE
DUP2
DUP2
MUL
PUSH1 0x07
SSTORE
DUP2
DUP2
SIGNEXTEND
PUSH1 0x08
TSTORE
DUP2
DUP2
SAR
DUP3
DUP3
BYTE
XOR
DUP3
DUP3
SHL
DUP4
DUP4
SHR
OR
SUB
PUSH1 0x09
SSTORE
PUSH1 0x08
TLOAD
DUP2
SLT
DUP3
DUP3
SGT
ADD
PUSH1 0x0a
SSTORE
DUP2
PUSH1 0x00
MSTORE
DUP1
PUSH1 0x20
MSTORE
PUSH1 0x07
PUSH1 0x5f
MSTORE8
CALLDATASIZE
PUSH1 0x00
PUSH1 0x60
CALLDATACOPY
PUSH1 0x40
PUSH1 0x00
PUSH2 0x0100
MCOPY
PUSH1 0x20
PUSH1 0x10
PUSH2 0x0180
CODECOPY
PUSH1 0x60
CALLDATALOAD
PUSH2 0x01ff
AND
PUSH1 0x00
SHA3
PUSH1 0x0b
SSTORE
PUSH1 0x44
MLOAD
PUSH1 0x0c
SSTORE
GAS
MSIZE
PC
ADD
ADD
PUSH1 0x0d
SSTORE
PUSH1 0x24
PUSH1 0x30
RETURN
"""

#: a dispatcher body that walks the symbolic planes: a clean MSTORE/MLOAD
#: round trip, a symbolic SSTORE read back, an env var, a concrete SHA3 on
#: the device, then forks whose sides escape on a dirty MLOAD, a SHA3 over
#: symbolic bytes and a CALLDATACOPY of symbolic calldata
PLANES_SOURCE = """
PUSH1 0x04
CALLDATALOAD
DUP1
PUSH1 0x00
MSTORE
PUSH1 0x00
MLOAD
PUSH1 0x24
CALLDATALOAD
ADD
DUP1
PUSH1 0x01
SSTORE
PUSH1 0x01
SLOAD
CALLER
XOR
PUSH1 0x2a
PUSH1 0x40
MSTORE
PUSH1 0x20
PUSH1 0x40
SHA3
PUSH1 0x02
SSTORE
DUP1
PUSH1 0x10
GT
PUSH @a
JUMPI
PUSH1 0x07
PUSH1 0x03
MSTORE8
PUSH1 0x00
MLOAD
STOP
a:
JUMPDEST
DUP1
PUSH1 0x03
SWAP1
DUP2
LT
PUSH @b
JUMPI
PUSH1 0x20
PUSH1 0x00
SHA3
STOP
b:
JUMPDEST
PUSH1 0x20
PUSH1 0x00
PUSH1 0x60
CALLDATACOPY
STOP
"""

#: tests/test_analysis.py's KILLBILLY: its SLOAD on a symbolic-base storage
#: pauses the lane for a fault-in (the cold-SLOAD path)
KILLBILLY = {
    "activatekillability()": "PUSH1 0x01\nPUSH1 0x00\nSSTORE\nSTOP",
    "commencekilling()":
        "PUSH1 0x00\nSLOAD\nPUSH1 0x01\nEQ\nPUSH @do_kill\nJUMPI\nSTOP\n"
        "do_kill:\nJUMPDEST\nCALLER\nSELFDESTRUCT",
}

WORD_MASK = (1 << 256) - 1
SPECIAL = [0, 1, 2, 3, 7, 31, 32, 255, 256, 1 << 255, WORD_MASK,
           WORD_MASK - 1, (1 << 255) - 1, 0xDEADBEEF, 1 << 128,
           12345678901234567890]


def mixed_specs(n_lanes: int, seed: int = 7):
    """LaneSpecs running MIXED_SOURCE on adversarial and random operands:
    lane 0 divides INT_MIN by -1, lane 1 divides by zero, and the SHA3
    lengths walk the keccak block boundaries."""
    code = assemble(MIXED_SOURCE)
    rng = np.random.default_rng(seed)

    def word(value):
        return (value & WORD_MASK).to_bytes(32, "big")

    specs = []
    for lane in range(n_lanes):
        x, y, n = (SPECIAL[int(rng.integers(len(SPECIAL)))]
                   if rng.random() < .6
                   else int.from_bytes(rng.bytes(32), "big")
                   for _ in range(3))
        if lane == 0:
            x, y = 1 << 255, WORD_MASK
        if lane == 1:
            y, n = 0, 0
        sha_len = [0, 135, 136, 137, 271, 272, 511][lane % 7]
        specs.append(B.LaneSpec(
            code=code, calldata=word(x) + word(y) + word(n) + word(sha_len),
            gas_limit=10_000_000, caller=0xCAFE + lane,
            timestamp=1_700_000_000, chainid=1, basefee=7))
    return specs


def branchy_contract(n_branches: int) -> str:
    """bench.py's stress body: n sequential branches on distinct calldata
    words whose sides converge, so every combination is a live path."""
    lines = []
    for i in range(n_branches):
        lines += [f"PUSH2 {hex(4 + 32 * i)}", "CALLDATALOAD",
                  f"PUSH4 {hex(0x10000 + i)}", "LT", f"PUSH @l{i}", "JUMPI",
                  f"l{i}:", "JUMPDEST"]
    return "\n".join(lines + ["STOP"])


# ---- helpers ---------------------------------------------------------------------

#: `nvidia-smi --query-gpu=name,power.limit` of the card this run uses
CARD = ""


def emit(record: dict) -> None:
    """One phase line, with the card it ran on."""
    print(json.dumps({**record, "card": CARD}), flush=True)


def assert_same(kernel_tree, plain_tree, what: str) -> None:
    """Every leaf identical (dtype, shape, bytes)."""
    for (name, got), (_, ref) in zip(convert.leaves(convert.to_numpy(kernel_tree)),
                                     convert.leaves(convert.to_numpy(plain_tree))):
        if got.dtype != ref.dtype or got.shape != ref.shape \
                or not np.array_equal(got, ref):
            where = np.argwhere(got != ref)[:4].tolist() \
                if got.shape == ref.shape else "shape"
            raise AssertionError(f"{what}: leaf {name} differs at {where}")


def max_abs_err(got: torch.Tensor, ref: torch.Tensor) -> int:
    return int((got.to(torch.int64) - ref.to(torch.int64)).abs().max()) \
        if got.numel() else 0


def event_ms(fn, reps: int, setup=None) -> float:
    """Mean device time of fn() in ms over `reps` runs, each timed by CUDA
    events around the call alone (setup() runs outside the timed span)."""
    fn_args = setup() if setup else None
    fn(fn_args)  # warm
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        fn_args = setup() if setup else None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(fn_args)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms over `reps` calls: every CUDA function
    it runs, as torch.profiler (CUPTI) records it, without the host's time
    to enqueue them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(None)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(None)
        torch.cuda.synchronize()
    total_us = sum(event.self_device_time_total
                   for event in prof.key_averages()
                   if event.device_type == DeviceType.CUDA)
    if total_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    return total_us / reps / 1e3


def bound_ms(nbytes: float, nops: float):
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    op_ms = nops / PEAK_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=30)
    return proc.stdout.strip().splitlines()[0]


# ---- phase 2: K1 ------------------------------------------------------------------

KECCAK_OPS_PER_BLOCK = 24 * 216 * 2  # ~216 64-bit ops a round, 2 32-bit ops each


def phase_keccak(dev, rng) -> dict:
    n = 4096
    data = torch.from_numpy(rng.integers(0, 256, (n, 512), dtype=np.uint8)).to(dev)
    length = torch.from_numpy(rng.integers(0, 513, n).astype(np.int32)).to(dev)
    got = keccak.keccak256(data, length)
    ref = keccak.keccak256_reference(data, length)
    err_msgs = max_abs_err(got, ref)
    if err_msgs:
        raise AssertionError("K1 disagrees with keccak256_reference")
    msgs_ms = event_ms(lambda _: ops.keccak256(data, length), 20)

    # the main path's call: SHA3 ranges of 128 rows of a 4096-byte memory
    memory = torch.from_numpy(rng.integers(0, 256, (LANES, 4096),
                                           dtype=np.uint8)).to(dev)
    msize = torch.from_numpy(32 * rng.integers(0, 129, LANES)
                             .astype(np.int32)).to(dev)
    offset = torch.from_numpy(rng.integers(0, 4096, LANES)).to(dev)
    mlen = torch.from_numpy(rng.integers(0, 513, LANES).astype(np.int32)).to(dev)
    mask = torch.ones(LANES, dtype=torch.bool, device=dev)
    mask[::5] = False

    def kernel(_):
        return ops.keccak_rows(memory, mlen, offset=offset, limit=msize,
                               mask=mask)

    def plain(_):
        buf = lockstep.mem_read(memory, msize, offset, lockstep.SHA3_MAX)
        out = keccak.keccak256_reference(buf, mlen)
        return torch.where(mask[:, None], out, torch.zeros_like(out))

    err = max_abs_err(kernel(None), plain(None))
    if err:
        raise AssertionError("K1 (memory ranges) disagrees with its plain version")
    lens = mlen[mask].to(torch.int64)
    blocks = int(((lens + 1 + 135) // 136).sum())
    nbytes = int(lens.sum()) + LANES * (8 + 4 + 4 + 1 + 32)
    b_ms, b_by = bound_ms(nbytes, blocks * KECCAK_OPS_PER_BLOCK)
    record = {"phase": "keccak", "messages": n, "max_abs_err": err_msgs,
              "messages_ms": msgs_ms,
              "messages_per_s": n / (msgs_ms / 1e3),
              "main_shape": [LANES, 4096], "main_max_abs_err": err}
    emit(record)
    return {"name": "keccak", "route": "cuda",
            "source": "mythril_tpu_torch/kernels/keccak.cu",
            "replaces": "mythril_tpu/parallel/keccak.py:137",
            "max_abs_err": err, "ms": event_ms(kernel, 50),
            "plain_ms": event_ms(plain, 10), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "held_by": "phase keccak"}


# ---- phase 3: K2 ------------------------------------------------------------------

_DIV_OPS = {0x04, 0x05, 0x06, 0x07}


def step_work(state) -> tuple:
    """(bytes, 32-bit ops) one concrete step needs for these lanes: each
    running lane reads its opcode, three operand words and its scalars and
    writes a result word and its scalars; memory ops move their range; the
    division ladder, EXP and MULMOD cost operations."""
    status = state.status.cpu().numpy()
    pc = state.pc.cpu().numpy().astype(np.int64)
    code = state.code.cpu().numpy()
    code_len = state.code_len.cpu().numpy()
    running = status == B.RUNNING
    op = np.where(pc < code_len,
                  code[np.arange(len(pc)), np.clip(pc, 0, code.shape[1] - 1)], 0)
    nbytes = int((~running).sum()) * 4
    nops = 0
    for o in op[running]:
        nbytes += 1 + 3 * 64 + 64 + 2 * 24
        if o in (0x51, 0x52):
            nbytes += 32
        if o in (0x54, 0x55):
            nbytes += state.storage_keys.shape[1] * 129
        if o in _DIV_OPS or o == 0x08:
            nops += 257 * 40
        if o == 0x09:
            nops += 512 * 40 + 128
        if o == 0x0A:
            nops += 256 * 2 * 128
        if 0x37 <= o <= 0x3E or o == 0x5E:
            nbytes += 2 * 512
    return nbytes, nops


def phase_step(dev) -> dict:
    # bench.py's concrete loop at 512 lanes, 256 steps
    specs = [B.LaneSpec(BENCH_LOOP, gas_limit=2 ** 60) for _ in range(512)]
    state = B.build_batch(specs, device=dev, **BENCH_GEOMETRY)
    plain = convert.clone(state)
    for chunk in range(8):
        for _ in range(32):
            state = lockstep.step(state)
            plain = lockstep.step_reference(plain)
        assert_same(state, plain, f"K2 bench loop chunk {chunk}")

    # the mixed program at 128 lanes, default geometry, until every lane halts
    specs = mixed_specs(LANES)
    state = B.build_batch(specs, device=dev)
    plain = convert.clone(state)
    snapshot = None
    for chunk in range(8):
        for _ in range(32):
            state = lockstep.step(state)
            plain = lockstep.step_reference(plain)
        assert_same(state, plain, f"K2 mixed chunk {chunk}")
        if chunk == 0:
            snapshot = convert.clone(state)
    status = state.status.cpu().numpy()
    if not np.all(status == B.RETURNED):
        raise AssertionError(f"mixed program did not return: {np.bincount(status)}")
    emit({"phase": "evm_step", "bench_loop": [512, 256], "mixed": [LANES, 256],
          "max_abs_err": 0})

    # time one step from the mixed program's first chunk (divisions, EXP,
    # MULMOD and SHA3 still ahead of most lanes)
    nbytes, nops = step_work(snapshot)
    b_ms, b_by = bound_ms(nbytes, nops)
    return {"name": "evm_step", "route": "cuda",
            "source": "mythril_tpu_torch/kernels/evm_step.cu",
            "replaces": "mythril_tpu/parallel/lockstep.py:159",
            "max_abs_err": 0,
            "ms": event_ms(lambda s: ops.evm_step(s), 20,
                           setup=lambda: convert.clone(snapshot)),
            "plain_ms": event_ms(lambda s: lockstep.step_reference(s), 5,
                                 setup=lambda: convert.clone(snapshot)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "held_by": "phase evm_step"}


# ---- phase 4: K3 ------------------------------------------------------------------

def phase_arena(dev, rng) -> dict:
    plain = A.new_arena(2048, 128, device=dev)
    kern = convert.clone(plain)
    overflowed = False
    for round_ in range(48):
        want = torch.from_numpy(rng.random(LANES) < 0.5).to(dev)
        if round_ % 4 == 0:
            words = torch.from_numpy(rng.integers(0, 1 << 16, (LANES, 16))
                                     .astype(np.int32)).to(dev)
            plain, ids_p, ovf_p = A.alloc_consts_reference(plain, want, words)
            kern, ids_k, ovf_k = A.alloc_consts(kern, want, words)
        else:
            n = int(plain.n)
            args = [torch.from_numpy(v.astype(np.int32)).to(dev) for v in (
                rng.choice([0x01, 0x10, 0x14, A.VAR, A.CONST], LANES),
                rng.integers(0, n, LANES), rng.integers(0, n, LANES),
                rng.integers(0, n, LANES), rng.integers(0, 40, LANES),
                rng.integers(0, 1 << 20, LANES))]
            plain, ids_p, ovf_p = A.alloc_rows_reference(plain, want, *args)
            kern, ids_k, ovf_k = A.alloc_rows(kern, want, *args)
        if not (torch.equal(ids_p, ids_k) and torch.equal(ovf_p, ovf_k)):
            raise AssertionError(f"K3 ids differ in round {round_}")
        assert_same(kern, plain, f"K3 round {round_}")
        overflowed |= bool(ovf_p.any())
    if not overflowed:
        raise AssertionError("K3 sequence never reached capacity")
    emit({"phase": "arena_alloc", "rounds": 48, "lanes": LANES,
          "overflowed": overflowed, "max_abs_err": 0})

    # time one node allocation at the main path's shape: default arena
    arena_k = A.new_arena(device=dev)
    arena_p = A.new_arena(device=dev)
    want = torch.from_numpy(rng.random(LANES) < 0.5).to(dev)
    args = [torch.full((LANES,), v, dtype=torch.int32, device=dev)
            for v in (0x01, 1, 2, 0, 0, 7)]
    n_want = int(want.sum())
    # each lane reads want + 6 operands and writes id + overflow; each
    # allocated node writes 7 columns and reads 3 child masks
    nbytes = LANES * (1 + 6 * 4 + 4 + 1) + n_want * (7 * 4 + 3 * 4) + 8
    b_ms, b_by = bound_ms(nbytes, 0)
    return {"name": "arena_alloc", "route": "cuda",
            "source": "mythril_tpu_torch/kernels/arena_alloc.cu",
            "replaces": "mythril_tpu/parallel/arena.py:105",
            "max_abs_err": 0,
            "ms": event_ms(lambda _: A.alloc_rows(arena_k, want, *args), 50),
            "plain_ms": event_ms(
                lambda _: A.alloc_rows_reference(arena_p, want, *args), 20),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "held_by": "phase arena_alloc"}


# ---- phase 5: the slice ----------------------------------------------------------

def seed_frontier(dev, codes, base_sym=()):
    """One RUNNING lane per code with symbolic env, the rest DEAD, as the
    frontier's `seed` does; `base_sym` lanes have a symbolic storage base."""
    specs = [B.LaneSpec(code=code, gas_limit=10_000_000) for code in codes] \
        + [B.LaneSpec(code=b"\x00")] * (LANES - len(codes))
    state = B.build_batch(specs, device=dev)
    state.status.fill_(B.DEAD)
    state.status[:len(codes)] = B.RUNNING
    planes = symstep.SymPlanes.empty(LANES, state.stack.shape[1],
                                     state.memory.shape[1],
                                     state.storage_keys.shape[1], MAX_CONDS,
                                     device=dev)
    planes.ctx_id[:len(codes)] = torch.arange(len(codes), dtype=torch.int32)
    for lane in base_sym:
        planes.storage_base_sym[lane] = True
    arena = A.new_arena(device=dev)
    sched = symstep.new_scheduler(state, planes, STACK_ROWS, ESC_ROWS)
    return [state, planes, arena, sched]


def phase_planes(dev) -> None:
    """K4 (with K1-K3) vs the twins on contracts that walk the symbolic
    planes, a cold SLOAD pause and a concrete SHA3 on the device."""
    codes = [assemble(dispatcher({"planes()": PLANES_SOURCE})),
             assemble(dispatcher(KILLBILLY)),
             assemble(dispatcher({"stress()": branchy_contract(3)}))]
    tree = seed_frontier(dev, codes, base_sym=[1])
    plain = [convert.clone(t) for t in tree]
    escapes = 0
    for chunk in range(2):
        tree = list(symstep.run_chunk(*tree, CHUNK))
        plain = list(symstep.run_chunk_reference(*plain, CHUNK))
        for kind, got, ref in zip(("state", "planes", "arena", "sched"),
                                  tree, plain):
            assert_same(got, ref, f"planes chunk {chunk} {kind}")
        escapes += drain(tree, at_stop=False)[0]
        drain(plain, at_stop=False, reset=frontier.reset_esc_reference)
    paused = int(((tree[0].status == B.FORKING)
                  & (tree[1].fork_cond == 0)).sum())
    if not paused:
        raise AssertionError("the cold SLOAD lane did not pause")
    emit({"phase": "planes", "contracts": ["planes()", "KILLBILLY",
                                           "branchy(3)"],
          "chunks": 2, "escapes": escapes, "cold_sload_paused": paused,
          "forks": int(tree[3].forks), "max_abs_err": 0})


def drain(tree, at_stop: bool = True, reset=frontier.reset_esc) -> tuple:
    """Read and zero the escape count as the frontier's drain does (K6's
    `reset_esc`, or `reset` given); check that buffered rows are escaped
    lanes (at a STOP, with `at_stop`) or spilled siblings, still RUNNING.
    Returns (rows, spilled rows)."""
    sched = tree[3]
    rows = int(sched.esc_count)
    status = sched.esc_state.status[:rows].cpu().numpy()
    pc = sched.esc_state.pc[:rows].cpu().numpy().astype(np.int64)
    code = sched.esc_state.code[:rows].cpu().numpy()
    spilled = int((status == B.RUNNING).sum())
    halted = status == B.ESCAPED
    if spilled + int(halted.sum()) != rows:
        raise AssertionError(f"escape rows with status {np.unique(status)}")
    at = code[np.arange(rows), np.clip(pc, 0, code.shape[1] - 1)]
    if at_stop and np.any(at[halted] != 0x00):
        raise AssertionError("an escaped row is not at a STOP")
    reset(sched)
    return rows, spilled


def live(tree) -> bool:
    status = tree[0].status
    busy = (status == B.RUNNING) | (status == B.FORKING) | (status == B.ESCAPED)
    return bool(busy.any()) or int(tree[3].stack_top) > 0


def phase_slice(dev) -> dict:
    code = assemble(dispatcher({"stress()": branchy_contract(N_BRANCHES)}))
    torch.cuda.reset_peak_memory_stats()
    tree = seed_frontier(dev, [code])
    plain = [convert.clone(t) for t in tree]
    row_bytes = sum(leaf[0].numel() * leaf.element_size()
                    for leaf in list(tree[0]) + list(tree[1]))
    escapes = spilled = chunks = 0
    kernel_s = 0.0
    snapshot = None
    ops.reset_launches()
    while live(tree):
        if chunks == MAX_CHUNKS:
            raise AssertionError("the frontier did not drain")
        if chunks == TIMING_CHUNK:
            snapshot = [convert.clone(t) for t in tree]
        torch.cuda.synchronize()
        start = time.perf_counter()
        tree = list(symstep.run_chunk(*tree, CHUNK))
        torch.cuda.synchronize()
        kernel_s += time.perf_counter() - start
        if chunks < COMPARE_CHUNKS:
            plain = list(symstep.run_chunk_reference(*plain, CHUNK))
            for kind, got, ref in zip(("state", "planes", "arena", "sched"),
                                      tree, plain):
                assert_same(got, ref, f"slice chunk {chunks} {kind}")
            drain(plain, reset=frontier.reset_esc_reference)
        rows, spill = drain(tree)
        escapes += rows
        spilled += spill
        chunks += 1
    launches = dict(ops.LAUNCHES)
    peak_bytes = torch.cuda.max_memory_allocated()
    sched, arena = tree[3], tree[2]
    totals = {"escapes": escapes, "forks": int(sched.forks),
              "pushes": int(sched.pushes), "pops": int(sched.pops),
              "executed": int(sched.executed), "arena_n": int(arena.n),
              "n_const": int(arena.n_const)}
    if totals != EXPECTED:
        raise AssertionError(f"slice totals {totals} != JAX reference {EXPECTED}")
    if any(launches[name] == 0 for name in ("keccak", "evm_step", "arena_alloc",
                                             "sym_step", "pack_rows")):
        raise AssertionError(f"a kernel of the slice never ran: {launches}")
    if snapshot is None:
        raise AssertionError("the frontier drained before the timing snapshot")

    # per-kernel device time on the main path: one chunk from the snapshot
    # with CUDA events around each wrapper (K4 = the step less its K2/K3)
    spans = {"keccak": [], "evm_step": [], "arena_alloc": [], "step": []}
    wrapped = {}

    def timed(name, fn):
        def run(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans[name].append((start, end))
            return out
        return run

    for name in ("keccak_rows", "evm_step", "arena_alloc"):
        wrapped[name] = getattr(ops, name)
        setattr(ops, name, timed("keccak" if name == "keccak_rows" else name,
                                 wrapped[name]))
    timing = [convert.clone(t) for t in snapshot]
    before = {k: int(getattr(timing[3], k)) for k in ("pops", "forks", "executed")}
    frontier.reset_esc_reference(timing[3])
    try:
        for _ in range(CHUNK):
            timing = list(timed("step", ops.sym_step)(*timing))
        torch.cuda.synchronize()
    finally:
        for name, fn in wrapped.items():
            setattr(ops, name, fn)
    total = {k: sum(s.elapsed_time(e) for s, e in v) for k, v in spans.items()}
    per = {k: total[k] / max(len(spans[k]), 1) for k in total}
    k2_only = (total["evm_step"] - total["keccak"]) / len(spans["evm_step"])
    k4_only = (total["step"] - total["evm_step"] - total["arena_alloc"]) / CHUNK
    moved = (int(timing[3].pops) - before["pops"] + int(timing[3].esc_count)
             + int(timing[3].forks) - before["forks"])
    lane_steps = int(timing[3].executed) - before["executed"]
    # K4 moves whole rows (read + write) and touches ~600 bytes of planes
    # and scratch per lane per step; the bound is per step, like `ms`
    b_ms, b_by = bound_ms((2 * moved * row_bytes + CHUNK * LANES * 600)
                          / CHUNK, 0)
    plain_snap = [convert.clone(t) for t in snapshot]
    plain_ms = event_ms(
        lambda t: symstep.sym_step_reference(*t), 4,
        setup=lambda: [convert.clone(t) for t in plain_snap])

    emit({"phase": "slice", "contract": f"dispatcher(branchy({N_BRANCHES}))",
          "lanes": LANES, "chunk": CHUNK, "stack_rows": STACK_ROWS,
          "esc_rows": ESC_ROWS, "row_bytes": row_bytes, "chunks": chunks,
          "compared_chunks": min(chunks, COMPARE_CHUNKS), **totals, "spilled": spilled,
          "expected": EXPECTED, "wall_s": kernel_s,
          "lane_steps_per_s": totals["executed"] / kernel_s,
          "steps_per_s": chunks * CHUNK / kernel_s,
          "launch_ms": {"keccak": per["keccak"], "evm_step": k2_only,
                        "arena_alloc": per["arena_alloc"], "sym_step": k4_only,
                        "whole_step": per["step"]},
          "timed_chunk": {"lane_steps": lane_steps, "rows_moved": moved},
          "peak_device_bytes": peak_bytes,
          "launches": launches})
    record = {"name": "sym_step", "route": "cuda",
              "source": "mythril_tpu_torch/kernels/sym_step.cu",
              "replaces": "mythril_tpu/parallel/symstep.py:347",
              "max_abs_err": 0, "ms": k4_only, "plain_ms": plain_ms,
              "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
              "held_by": "phase slice"}
    return record


# ---- phases 7-9: the frontier's drain loop -------------------------------------------

def frontier_totals(fr) -> dict:
    """The counters and digests a drain-loop run is checked by."""
    return {"chunks": fr.chunks, "drains": fr.drains,
            "drained_rows": fr.drained_rows, "frozen_rows": fr.frozen_rows,
            "spilled": fr.spilled, "reseeded": fr.reseeded,
            "lane_steps": fr.lane_steps, "forks": fr.forks,
            "stack_pushes": fr.stack_pushes, "stack_pops": fr.stack_pops,
            "deferred_blocks": len(fr.deferred),
            "deferred_rows": sum(block[2] for block in fr.deferred),
            "mirror_n": fr.harena.n, "mirror_n_const": fr.harena.n_const,
            "deferred_sha256": frontier.deferred_digest(fr.deferred),
            "mirror_sha256": frontier.mirror_digest(fr.harena)}


def stress_seed(n_branches: int):
    code = assemble(dispatcher({"stress()": branchy_contract(n_branches)}))
    return [(code, {}, False, 10_000_000, 0)]


def check_same(got, ref, what: str) -> None:
    for mine, theirs in zip(got, ref):
        if mine.dtype != theirs.dtype or not torch.equal(mine, theirs):
            raise AssertionError(f"{what} disagrees with its twin")


def phase_frontier_programs(dev) -> list:
    """K5-K8 vs their twins at the main path's shapes, two chunks into the
    slice, each timed beside its twin and its library yardstick."""
    fr = frontier.DeviceFrontier(LANES, device=dev)
    state, planes = fr.seed(stress_seed(N_BRANCHES))
    sched = fr.new_sched(state, planes)
    arena = fr.arena
    for _ in range(2):
        state, planes, arena, sched = symstep.run_chunk(state, planes, arena,
                                                        sched, CHUNK)
    esc_count = int(sched.esc_count)
    if not esc_count:
        raise AssertionError("no escape rows buffered after two chunks")
    records = []

    # K5: the summary
    packed = frontier.summary(state, planes, arena, sched)
    check_same([packed], [frontier.summary_reference(state, planes, arena,
                                                     sched)], "K5")
    live_rows = esc_count
    b_ms, b_by = bound_ms(live_rows * (4 + 4 + 64 + 4) + LANES * 12
                          + (13 + 3 * LANES) * 8 + 6 * 8 + 2 * 4, 0)
    records.append({
        "name": "frontier_summary", "route": "cuda",
        "source": "mythril_tpu_torch/kernels/frontier_summary.cu",
        "replaces": "mythril_tpu/parallel/frontier.py:99", "max_abs_err": 0,
        "ms": event_ms(lambda _: frontier.summary(state, planes, arena,
                                                  sched), 50),
        "device_ms": device_ms(lambda _: frontier.summary(
            state, planes, arena, sched), 20),
        "plain_ms": event_ms(lambda _: frontier.summary_reference(
            state, planes, arena, sched), 20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "library": "none: no single PyTorch call packs the summary",
        "held_by": "phase frontier_programs"})

    # K6: the drain's maxima, pack and reset at its real index and widths
    scalars = packed[:frontier.SUMMARY_SCALARS].cpu().numpy()
    esc_cap = sched.esc_state.status.shape[0]
    bucket = min(B.next_pow2(esc_count), esc_cap)
    index_np = np.zeros(bucket, dtype=np.int32)
    index_np[:min(esc_count, bucket)] = np.arange(min(esc_count, bucket))
    index = torch.from_numpy(index_np).to(dev)
    rows = (sched.esc_state, sched.esc_planes)
    check_same([frontier.row_maxima(*rows, index)],
               [frontier.row_maxima_reference(*rows, index)], "K6 row_maxima")
    widths = frontier.pack_widths(*rows, *(int(v) for v in scalars[8:12]))
    packed_rows = frontier.pack_rows(*rows, index, *widths)
    check_same(packed_rows, frontier.pack_rows_reference(*rows, index,
                                                         *widths), "K6 pack")
    reset_k, reset_p = convert.clone(sched), convert.clone(sched)
    frontier.reset_esc(reset_k)
    frontier.reset_esc_reference(reset_p)
    assert_same(reset_k, reset_p, "K6 reset_esc")
    pack_bytes = sum(t.numel() * t.element_size() for t in packed_rows)
    b_ms, b_by = bound_ms(2 * pack_bytes + bucket * 4, 0)
    maxima_ms = event_ms(lambda _: frontier.row_maxima(*rows, index), 50)
    reset_ms = event_ms(lambda _: frontier.reset_esc(reset_k), 50)
    records.append({
        "name": "pack_rows", "route": "cuda",
        "source": "mythril_tpu_torch/kernels/pack_rows.cu",
        "replaces": "mythril_tpu/parallel/frontier.py:156", "max_abs_err": 0,
        "ms": event_ms(lambda _: frontier.pack_rows(*rows, index, *widths),
                       50),
        "device_ms": device_ms(lambda _: frontier.pack_rows(
            *rows, index, *widths), 20),
        "plain_ms": event_ms(lambda _: frontier.pack_rows_reference(
            *rows, index, *widths), 20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "library": "none: no single PyTorch call packs the row fields",
        "row_maxima_ms": maxima_ms, "reset_esc_ms": reset_ms,
        "row_maxima_device_ms": device_ms(
            lambda _: frontier.row_maxima(*rows, index), 20),
        "held_by": "phase frontier_programs"})

    # K7: a gather and a scatter of 32 lanes
    lanes = torch.arange(32, dtype=torch.int32, device=dev) * 4 % LANES
    gathered = frontier.gather_rows(state, planes, lanes)
    for got, ref in zip(gathered, frontier.gather_rows_reference(
            state, planes, lanes)):
        assert_same(got, ref, "K7 gather")
    targets = (torch.arange(32, dtype=torch.int32, device=dev) * 4 + 1) % LANES
    scat_k = [convert.clone(t) for t in (state, planes)]
    scat_p = [convert.clone(t) for t in (state, planes)]
    frontier.scatter_rows(*scat_k, targets, *gathered)
    frontier.scatter_rows_reference(*scat_p, targets, *gathered)
    assert_same(scat_k[0], scat_p[0], "K7 scatter state")
    assert_same(scat_k[1], scat_p[1], "K7 scatter planes")
    row_bytes = fr.row_bytes
    leaves = list(state) + list(planes)
    lanes64 = lanes.to(torch.int64)

    def library_gather(_):
        return [torch.index_select(leaf, 0, lanes64) for leaf in leaves]

    g_rows = list(gathered[0]) + list(gathered[1])
    dst = [leaf.clone() for leaf in leaves]
    targets64 = targets.to(torch.int64)

    def library_scatter(_):
        for leaf, block in zip(dst, g_rows):
            leaf.index_copy_(0, targets64, block)

    b_ms, b_by = bound_ms(2 * 32 * row_bytes + 32 * 4, 0)
    records.append({
        "name": "gather_rows", "route": "cuda",
        "source": "mythril_tpu_torch/kernels/gather_rows.cu",
        "replaces": "mythril_tpu/parallel/frontier.py:79", "max_abs_err": 0,
        "ms": event_ms(lambda _: frontier.gather_rows(state, planes, lanes),
                       50),
        "device_ms": device_ms(lambda _: frontier.gather_rows(
            state, planes, lanes), 20),
        "plain_ms": event_ms(lambda _: frontier.gather_rows_reference(
            state, planes, lanes), 20),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": event_ms(library_gather, 20),
        "library": "torch.index_select per leaf (46 calls)",
        "scatter_ms": event_ms(lambda _: frontier.scatter_rows(
            *scat_k, targets, *gathered), 50),
        "scatter_device_ms": device_ms(lambda _: frontier.scatter_rows(
            *scat_k, targets, *gathered), 20),
        "library_device_ms": device_ms(library_gather, 20),
        "scatter_plain_ms": event_ms(lambda _: frontier.scatter_rows_reference(
            *scat_p, targets, *gathered), 20),
        "scatter_library_ms": event_ms(library_scatter, 20),
        "held_by": "phase frontier_programs"})

    # K8: the first drain's arena delta (an empty mirror, then [1, arena_n))
    arena_n, arena_nc = int(scalars[6]), int(scalars[7])
    d_bucket = min(max(B.next_pow2(arena_n - 1), 16), arena.capacity)
    d_cbucket = min(max(B.next_pow2(arena_nc), 16), arena.const_vals.shape[0])
    check_same(A.fetch_delta(arena, 1, 0, d_bucket, d_cbucket),
               A.fetch_delta_reference(arena, 1, 0, d_bucket, d_cbucket), "K8")
    cols = [getattr(arena, col) for col in A.ROW_COLS]
    out_rows = torch.empty((6, d_bucket), dtype=torch.int32, device=dev)
    out_consts = torch.empty((d_cbucket, 16), dtype=torch.int32, device=dev)

    def library_delta(_):
        for position, col in enumerate(cols):
            out_rows[position].copy_(col.narrow(0, 1, d_bucket))
        out_consts.copy_(arena.const_vals.narrow(0, 0, d_cbucket))

    b_ms, b_by = bound_ms(2 * (6 * d_bucket * 4 + d_cbucket * 64), 0)
    records.append({
        "name": "arena_delta", "route": "cuda",
        "source": "mythril_tpu_torch/kernels/arena_delta.cu",
        "replaces": "mythril_tpu/parallel/arena.py:185", "max_abs_err": 0,
        "ms": event_ms(lambda _: A.fetch_delta(arena, 1, 0, d_bucket,
                                               d_cbucket), 50),
        "device_ms": device_ms(lambda _: A.fetch_delta(
            arena, 1, 0, d_bucket, d_cbucket), 20),
        "plain_ms": event_ms(lambda _: A.fetch_delta_reference(
            arena, 1, 0, d_bucket, d_cbucket), 20),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": event_ms(library_delta, 20),
        "library": "narrow + copy_ per column (7 calls)",
        "held_by": "phase frontier_programs"})
    emit({"phase": "frontier_programs", "esc_count": esc_count,
          "esc_rows": esc_cap, "drain_bucket": bucket,
          "pack_widths": list(widths), "pack_bytes": pack_bytes,
          "gather_lanes": 32, "delta": [d_bucket, d_cbucket],
          "max_abs_err": 0,
          "ms": {r["name"]: r["ms"] for r in records}})
    return records


def drive_frontier(fr, seeds) -> dict:
    """Seed and run one DeviceFrontier with the launch counts zeroed just
    before and read just after; returns the run's timing record."""
    state, planes = fr.seed(seeds)
    chunk_events = []
    drain_s, setup_s = [0.0], [0.0]
    run_chunk = symstep.run_chunk

    def timed_chunk(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run_chunk(*args)
        end.record()
        chunk_events.append((start, end))
        return out

    def host_timed(fn, total):
        def run(*args, **kwargs):
            start = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                total[0] += time.perf_counter() - start
        return run

    for name in ("_fetch_escapes", "_flush_backlog", "_defer_lanes",
                 "_spill_host", "_reseed_host"):
        setattr(fr, name, host_timed(getattr(fr, name), drain_s))
    fr.new_sched = host_timed(fr.new_sched, setup_s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    symstep.run_chunk = timed_chunk
    ops.reset_launches()
    start = time.perf_counter()
    try:
        fr.run(state, planes)
        torch.cuda.synchronize()
    finally:
        symstep.run_chunk = run_chunk
    wall = time.perf_counter() - start
    launches = dict(ops.LAUNCHES)
    chunk_ms = sum(s.elapsed_time(e) for s, e in chunk_events)
    chunks = max(fr.chunks, 1)
    return {"launches": launches, "wall_s": wall,
            "setup_ms": setup_s[0] * 1e3,
            "chunk_stream_ms": chunk_ms / chunks,
            "host_ms_per_chunk": (wall * 1e3 - chunk_ms) / chunks,
            "drain_host_ms_per_chunk": drain_s[0] * 1e3 / chunks,
            "lane_steps_per_s": fr.lane_steps / wall,
            "peak_device_bytes": torch.cuda.max_memory_allocated()}


#: CUDA function -> the port kernel (wrapper) that launches it
KERNEL_OF = {
    "keccak_rows_kernel": "keccak", "sha_prep_kernel": "evm_step",
    "evm_step_kernel": "evm_step", "arena_alloc_kernel": "arena_alloc",
    "sym_pre_kernel": "sym_step", "sym_mid1_kernel": "sym_step",
    "sym_mid2_kernel": "sym_step", "sym_post_kernel": "sym_step",
    "frontier_summary_kernel": "frontier_summary",
    "row_maxima_kernel": "pack_rows", "pack_rows_kernel": "pack_rows",
    "reset_esc_kernel": "pack_rows", "gather_rows_kernel": "gather_rows",
    "scatter_rows_kernel": "gather_rows",
    "arena_delta_kernel": "arena_delta"}


def profiled_run(fr, seeds) -> dict:
    """Run the drain loop again under torch.profiler (CUPTI): device time
    per port kernel and for everything else on the card (copies, fills,
    PyTorch's own kernels), and the share of the run's wall time the card
    was idle. Profiling slows the host, so the wall here is longer than
    the unprofiled run's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state, planes = fr.seed(seeds)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fr.run(state, planes)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    by_kernel = {name: 0.0 for name in ops.LAUNCHES}
    device_calls = {name: 0 for name in ops.LAUNCHES}
    other_ms = 0.0
    for event in prof.key_averages():
        if event.device_type != DeviceType.CUDA:
            continue
        ms = event.self_device_time_total / 1e3
        owner = next((kernel for function, kernel in KERNEL_OF.items()
                      if event.key.startswith(function)), None)
        if owner is None:
            other_ms += ms
        else:
            by_kernel[owner] += ms
            device_calls[owner] += event.count
    busy_ms = sum(by_kernel.values()) + other_ms
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "kernel_device_ms": by_kernel, "device_calls": device_calls,
            "other_device_ms": other_ms}


def check_totals(totals: dict, expected: dict, what: str) -> None:
    if totals != expected:
        diff = {k: (totals.get(k), v) for k, v in expected.items()
                if totals.get(k) != v}
        raise AssertionError(f"{what} differs from the JAX reference: {diff}")


def phase_frontier(dev) -> tuple:
    # the first run of the process pays one-time costs (pinned host pages,
    # the copy stream, pool allocations); the second is the steady state
    cold = frontier.DeviceFrontier(LANES, device=dev)
    cold_wall = drive_frontier(cold, stress_seed(N_BRANCHES))["wall_s"]
    check_totals(frontier_totals(cold), EXPECTED_FRONTIER, "cold frontier")
    fr = frontier.DeviceFrontier(LANES, device=dev)
    timing = drive_frontier(fr, stress_seed(N_BRANCHES))
    totals = frontier_totals(fr)
    check_totals(totals, EXPECTED_FRONTIER, "frontier")
    replay = frontier.DeviceFrontier(LANES, device=dev)
    profiled = profiled_run(replay, stress_seed(N_BRANCHES))
    check_totals(frontier_totals(replay), EXPECTED_FRONTIER, "profiled frontier")
    emit({"phase": "frontier", "contract": f"dispatcher(branchy({N_BRANCHES}))",
          "lanes": LANES, "chunk": fr.chunk, "row_bytes": fr.row_bytes,
          "drain_batch": fr.drain_batch, "arena_capacity": fr.arena.capacity,
          **totals, **timing, "cold_wall_s": cold_wall,
          "profiled": profiled})
    return timing["launches"], profiled


def phase_frontier_spill(dev) -> dict:
    fr = frontier.DeviceFrontier(SPILL_LANES, device=dev,
                                 stack_bytes=SPILL_STACK_ROWS * 39306)
    timing = drive_frontier(fr, stress_seed(SPILL_BRANCHES))
    if fr.row_bytes != 39306:
        raise AssertionError(f"row bytes {fr.row_bytes} != 39306")
    totals = frontier_totals(fr)
    check_totals(totals, EXPECTED_SPILL, "frontier_spill")
    if not (fr.spilled and fr.reseeded and fr.frozen_rows):
        raise AssertionError("the spill run missed a path")
    emit({"phase": "frontier_spill",
          "contract": f"dispatcher(branchy({SPILL_BRANCHES}))",
          "lanes": SPILL_LANES, "stack_rows": SPILL_STACK_ROWS,
          **totals, **timing})
    return timing["launches"]


def main() -> int:
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    CARD = card_line()
    emit({"phase": "card", "torch": torch.__version__,
          "cuda": torch.version.cuda})
    start = time.perf_counter()
    paths = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - start,
          "libraries": sorted(p.rsplit("/", 1)[-1] for p in paths.values())})
    rng = np.random.default_rng(2024)
    records = [phase_keccak(dev, rng), phase_step(dev), phase_arena(dev, rng)]
    phase_planes(dev)
    records.append(phase_slice(dev))
    records += phase_frontier_programs(dev)
    # the main path: the drain loop at full width, then the spill run
    launches = {name: 0 for name in ops.LAUNCHES}
    frontier_launches, profiled = phase_frontier(dev)
    for counts in (frontier_launches, phase_frontier_spill(dev)):
        for name, count in counts.items():
            launches[name] += count
    idle = sorted(name for name, count in launches.items() if count == 0)
    if idle:
        raise AssertionError(f"kernels the driver phases never ran: {idle}")
    for record in records:
        name = record["name"]
        record["launches"] = launches[name]
        # device time per wrapper call on the full-width drain loop
        record["main_path_device_ms"] = (
            profiled["kernel_device_ms"][name] / frontier_launches[name]
            if frontier_launches[name] else None)
    print(CARD, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
