#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (mythril_tpu_torch) on one card.

    python3 chip_smoke.py        # from the root of a checkout; one CUDA card

It builds the hand-written kernels (K1-K12, eleven sources) from the
checkout's sources, holds each against its plain PyTorch version on the
card, then drives the port's main device path, the frontier's drain loop
(`DeviceFrontier.run` around `symstep.run_chunk`, one CUDA graph a
chunk), at the frontier's default geometry until the tree is drained:
with telemetry and state merging off (phases 8-9), in the default
configuration with both on (phases 12-13), sharded into 4 logical shards
with work stealing (phase 18) and at 2048 lanes (phase 19); then the
device SAT lane (`device_solver.solve_cnf_device` and
`solve_cnf_device_batch` on K11) on captured analysis queries at full
width (phases 21-22). Every phase prints one JSON line; any mismatch
raises, and the run exits non-zero. Each frontier* phase drives its
configuration once more with every summary the loop reads (K5 and its
copy to the host) held word for word to the twin on the same tensors
(`summaries_checked`). Phases:

  1. the card's name and power limit (nvidia-smi);
 1a. static_tables, on the host: the port's static analysis
     (`frontier.static_tables` over staticanalysis/) on branchy(12),
     mem_branchy(8), the fleet pair, the KILLBILLY and BECTOKEN
     dispatchers (tools/measure_headline.py), a loop beside joins and 40
     diamonds past the tag and window caps: the number of tags,
     merge pcs and window rows and a digest of the tables, held to the JAX
     static analysis's (constants here), the cold build (a fresh
     Disassembly: CFA, absint and taint) and the memoized lookup;
  2. K1 keccak (its standalone form) vs `keccak256_reference`: 4096
     random messages of 0..512 bytes, and the SHA3 shape of the main path
     (128 rows of a 4096-byte memory, ranges clipped at msize); at both,
     the wrapper's messages a warp timed in turn with one and 32;
  3. K2 evm_step after K1's step form (a warp a lane each) vs
     `step_reference`: bench.py's concrete loop at 512 lanes for 256 steps
     and a program reaching every expensive family at 128 lanes, every leaf
     compared after each chunk of 32 steps, and its first chunk at 2048
     lanes; the device time a step of K1's step form and of K2 at 128 and
     2048 lanes (on that program, and K1's on bench.py's loop, where no
     lane hashes), each launched once a step and sha_prep never, their
     grids as the launches recorded them and ptxas's registers and spills
     (K1's numbers go to its kernels record);
  4. K3 arena_alloc vs its twins: a random want-mask sequence up to and
     past capacity;
  5. K4 (K3's step allocations folded in) with K1-K2 vs the twins on
     contracts that walk the symbolic planes
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
     escape reset (K6's grids as the launches recorded them, the maxima
     over more than one block, its device time by launch and its plan
     lookup), a gather and a scatter of 32 lanes (and with clamped
     indices and dropped pads; K7's grid of row copy items), the arena delta
     of the first drain (K8 into the pinned staging: the whole refresh
     into an emptied mirror timed from the launch to the mirror landed,
     beside seven narrow + copy_ into pinned memory and the card's
     device-to-pinned copy rate, its bound; one refresh profiled: one
     launch, no memcpy, no device allocation); each timed beside its twin
     and, where one exists, the PyTorch call that computes the same
     function; K5's grid as its
     launch recorded it (more than one block at 1024 escape rows, or the
     phase fails) and its device time by launch (the grid, the one-block
     combine); the drain loop's read of the summary (a pageable .cpu())
     timed in turn with a copy into a pinned buffer waited on by an event;
     the plan lookups of K5 and of the chunk graph (key against last call);
  8. frontier: `DeviceFrontier(128).run` on the same contract at the
     default budgets until the tree drains (K1-K6 and K8 on the main path);
     its counters and the sha256 digests of its deferred row blocks and of
     its arena mirror must equal the JAX `_Frontier`'s (and one K8 plan
     must serve every refresh of its mirror); each chunk's host time split
     by call (the chunk's enqueue, the steal pass, the summary
     with its read, the decode, the drain, the rest; every frontier* phase
     prints the means);
  9. frontier_spill: 16 lanes, 32 stack rows, branchy(10): the deadlock
     spill and the host reseed (K7) run on the card, checked the same way;
     phases 7-9 run with telemetry and merging off, as the JAX references
     they are held to;
 10. telemetry: K4 with the telemetry plane armed (K9: tag pcs, fleet
     slots) vs the twins on the planes contracts for 2 chunks, every leaf
     and counter, and K5's telemetry tail; K9's device cost per step and
     by launch (each of K4's functions, its TEL instantiation against its
     plain one) at 128 lanes and at 2048 (a chunk into 256 branchy(12)
     seeds), eager; ptxas's registers and spills of both instantiations
     side by side; no global atomic in the TEL instantiation of a launch
     over lanes (cuobjdump's SASS); phases 12 and 19 add K9 by launch in
     their graphed drives (against phase 8's and a telemetry-off drive at
     2048 lanes);
 11. merge_kernel: K10 (K3's allocations folded in), one host call a
     pass, vs `merge_pass_reference` on the states the
     default-configuration frontier hands its merge passes: branchy(12)
     (strict rounds) and mem_branchy(8) with its window table (widened
     rounds), on the tables the frontier built for itself (held to the JAX
     static analysis's); every leaf, the arena and the stats; K10's time per strict
     and per widened pass, by launch, and its standalone K3 calls (none);
 12. frontier_default: `DeviceFrontier(128)` on branchy(12) with telemetry
     and merging on, held to the JAX `_Frontier`'s counters, merges,
     digests and final telemetry words, and the tables it built for itself
     to the JAX analysis's (empty: branchy(12) has no joins); its wall time and idle share beside
     phase 8's;
 13. frontier_merge: the same on mem_branchy(8), on the tag and window
     tables the frontier builds for itself, held to those the JAX static
     analysis builds (constants here);
 14. graph_chunk: `run_chunk`'s CUDA graph vs eager `sym_step` calls from
     the same state (branchy(12), 3 chunks): telemetry and merging off, on
     (a merge pass between chunks), and on with 4 shards; every leaf after
     each chunk; a state rebound to copies must recapture;
 15. wide_lanes: K4 and K10 at 2048 lanes vs the twins: one graphed chunk
     from 256 branchy(12) seeds at D = 1 and D = 2, then one merge pass
     (the pairing sort above 1024 lanes); K4's device time a step there;
 16. shard_step: K4 and K5 with a 4-shard scheduler (vector tops,
     segment-local ranks; 768 stack and 256 escape rows a segment) vs the
     twins, the planes contracts and branchy(12) one per lane block,
     telemetry armed, 2 chunks, every leaf and the summary's shard block;
 17. steal_kernel: K12 vs `steal_pass_reference` at the same geometry
     (random pool rows, max_rows 32): a forced imbalance, gaps below the
     threshold, tied loads, receivers with less room than half the gap,
     and the sharded frontier's first pass; every pool leaf and counter;
     one pass under `torch.cuda.set_sync_debug_mode("error")`; its time
     beside the twin, the bound and index_select + index_copy_ per leaf;
     the plan's and the move's grids as the launches recorded them (the
     moves on a (row slot, copy item) grid);
 18. frontier_shard: `DeviceFrontier(128, n_shards=4)` in the default
     configuration with the default steal knobs on branchy(12) from one
     seed (every path starts in shard 0), held to the JAX `_Frontier`'s
     counters, steal counters, digests and telemetry words; wall, idle
     share, K12 launches and K4's device time per step beside phase 12's;
     then a fleet of branchy(12) and mem_branchy(8) owned by shards 0 and
     2 with fleet slots, on the tables the frontier builds for both codes
     (held to the JAX analysis's), held the same way;
 19. frontier_wide: `DeviceFrontier(2048)` in the default configuration on
     branchy(12) until the tree drains, held to the JAX
     `_Frontier(n_lanes=2048)`'s counters, digests and telemetry words,
     and once more profiled (K1's and K2's device time a step);
 20. sat_kernel: K11, one CUDA graph a chunk and eager, vs
     `run_chunk_reference`, every leaf after each chunk, on fixtures
     (opposite-phase races in one tile and across two, the no-flip
     backtrack, 32 forced probes, the batch runner's freeze; at the card's
     variable tile and at 64 vars a block) and at full width (32 probes,
     V1 65,536) on a captured query of each tile bucket (64 and 256): 64
     steps compared, then K11's time per step by launch (device time,
     launches, blocks) beside the twin's and the bound;
 21. sat_lane: captured queries (tests/data/smt2_corpus.tar.gz, two of
     each bucket) through the port's from_smt2 -> lower_constraints ->
     Blaster -> `solve_cnf_device` with its defaults: CNF sizes (and, where
     the CNF does not depend on the process, its digest) and the state
     after the first two chunks held to the JAX lane (or, for a
     process-dependent CNF, to the twin on the card), decided verdicts to
     CDCL, SAT models to every clause and lowered constraint, 1689-24's
     verdict, chunk count and model to the JAX lane's; steps, verdict,
     wall and host ms per chunk; one solve again under the profiler for
     the card's idle share;
 22. sat_batch: `solve_cnf_device_batch` on four captured queries of one
     bucket (a dispatch flush) at chunk 32, held to the JAX batch runner's
     state after the first chunk, verdicts and models as in phase 21;
 23. the kernels line: each kernel's launches on the main-path phases (8, 9,
     12, 13, 18, 19, 21, 22; K3's are its allocations folded into K4's
     steps and K10's passes), its time, its plain version's time, the least
     time the card could take and the library call's time (K11's per
     step).

The last line is {"ok": true, "device": {...}}. Without a CUDA device the
script exits 2 and prints no result."""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import random
import subprocess
import sys
import tarfile
import time

import numpy as np
import torch

from mythril_tpu_torch.frontends.asm import assemble, dispatcher
from mythril_tpu_torch.kernels import build, ops
from mythril_tpu_torch.parallel import arena as A
from mythril_tpu_torch.parallel import batch as B
from mythril_tpu_torch.parallel import (convert, device_solver, frontier,
                                        keccak, lockstep, symstep)
from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.smtlib import from_smt2
from mythril_tpu_torch.smt.solver import preprocess
from mythril_tpu_torch.smt.solver.bitblast import Blaster
from tools.measure_headline import BECTOKEN
from tools.measure_headline import KILLBILLY as HEADLINE_KILLBILLY

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

#: the default configuration (telemetry and merging on) on the same
#: contract, and on dispatcher(mem_branchy(8)) with the static tables below:
#: `_Frontier` as above with `telemetry_enabled` and `state_merge` left on,
#: `_collect_tag_pcs` / `_merge_pc_table` returning what the JAX static
#: analysis builds for the contract; merge passes, ITEs, memory blends and
#: refusals summed over the passes' stats vectors, and the final telemetry
#: words (`_Frontier._tel_prev`). tests/test_torch_frontier.py recomputes
#: both.
EXPECTED_DEFAULT = {
    "chunks": 8, "drains": 4, "drained_rows": 3697, "frozen_rows": 384,
    "spilled": 0, "reseeded": 0, "lane_steps": 36788, "forks": 4088,
    "stack_pushes": 3503, "stack_pops": 3503, "deferred_blocks": 7,
    "deferred_rows": 4081, "mirror_n": 12267, "mirror_n_const": 4089,
    "merge_passes": 1, "merges": 8, "merge_ites": 0, "mem_blends": 0,
    "deferred_sha256":
        "a2dd2a8c592b782ab25ceaeac7da6cdb27bd7478f4bfe83ab52564a48120f2cf",
    "mirror_sha256":
        "c220cf2bd2aedee55047622b72ae7c8a77604775969b07d89e66bcec1ed1365a",
    "blocked_by": {"depth": 60, "mem_sym": 0, "memory": 0,
                   "storage_keys": 0, "tstore": 0},
    "telemetry_words": [
        0, 4089, 0, 4088, 0, 1, 0, 12263, 12265, 1, 0, 0, 0, 4081, 0, 3503, 0,
        0, 0, 3697, 18744, 0, 0, 585, 3503, 0, 0, 4081, 0, 0, 0, 0, 0, 0, 0,
        36788, 512, 640, 1024]}
#: the default configuration at 2048 lanes (phase frontier_wide), past the
#: 1024 lanes K4 and K10 once scanned in one block: `_Frontier(laser_evm=
#: None, n_lanes=2048)` as EXPECTED_DEFAULT, at the default geometry and
#: budgets (49,152 stack and 16,384 escape rows, an 8192-row drain batch)
WIDE_LANES = 2048
EXPECTED_WIDE = {
    "chunks": 2, "drains": 1, "drained_rows": 4097, "frozen_rows": 0,
    "spilled": 0, "reseeded": 0, "lane_steps": 36868, "forks": 4096,
    "stack_pushes": 2048, "stack_pops": 2048, "deferred_blocks": 1,
    "deferred_rows": 4097, "mirror_n": 12291, "mirror_n_const": 4097,
    "merge_passes": 0, "merges": 0, "merge_ites": 0, "mem_blends": 0,
    "deferred_sha256":
        "7d4aa16e85ad19debee485f26744513e1fbfd8d4fbe3328f0e83f3ef04a9e6e6",
    "mirror_sha256":
        "225b6740a3833f06b1f5a2df8fed26b1a5b968de757fa9235226bc6c74861f24",
    "blocked_by": {"depth": 0, "mem_sym": 0, "memory": 0,
                   "storage_keys": 0, "tstore": 0},
    "telemetry_words": [
        0, 4097, 0, 4096, 0, 1, 0, 12287, 12289, 1, 0, 0, 0, 4097, 0, 2048, 0,
        0, 0, 4097, 0, 0, 0, 2048, 2048, 0, 0, 4097, 0, 0, 0, 0, 0, 0, 0,
        36868, 128, 2048, 4097]}
MERGE_BRANCHES = 8
EXPECTED_MERGE = {
    "chunks": 2, "drains": 1, "drained_rows": 129, "frozen_rows": 0,
    "spilled": 0, "reseeded": 0, "lane_steps": 2476, "forks": 144,
    "stack_pushes": 0, "stack_pops": 0, "deferred_blocks": 1,
    "deferred_rows": 129, "mirror_n": 229, "mirror_n_const": 34,
    "merge_passes": 1, "merges": 16, "merge_ites": 32, "mem_blends": 16,
    "deferred_sha256":
        "1cfac54a20031f5641d5430ffee6e25cb5193ee7172818ee94eca1a87bf72520",
    "mirror_sha256":
        "90e9fe1ae3f34e16a298fec845094894580de238a35d8bfc54210dfe20ab9165",
    "blocked_by": {"depth": 8, "mem_sym": 0, "memory": 0,
                   "storage_keys": 0, "tstore": 0},
    "telemetry_words": [
        0, 2, 0, 160, 0, 287, 0, 860, 1037, 1, 0, 0, 0, 129, 0, 0, 0, 0, 0,
        129, 0, 0, 0, 144, 0, 0, 0, 129, 0, 0, 0, 0, 0, 0, 0, 2476, 128, 0,
        129, 2, 4, 8, 16, 32, 32, 64, 128]}

#: the JAX static analysis of dispatcher(mem_branchy(8)): its 8 joins (tag
#: and merge-attribution pcs) and the window table (one 32-byte window per
#: join, a row for every pc of the join block up to its first MSTORE)
MEM_BRANCHY_JOINS = [44, 69, 94, 119, 144, 169, 194, 219]
MEM_BRANCHY_MEM_PCS = [44, 45, 48, 49, 52, 69, 70, 73, 74, 77, 94, 95, 98, 99,
                       102, 119, 120, 123, 124, 127, 144, 145, 148, 149, 152,
                       169, 170, 173, 174, 177, 194, 195, 198, 199, 202, 219,
                       220]


#: the sharded frontier (phases shard_step, steal_kernel, frontier_shard):
#: 4 logical shards of 32 lanes, the default steal knobs (a pass every 4
#: chunks, a load gap of 8 at least)
SHARDS = 4
#: the JAX reference of DeviceFrontier(128, n_shards=4) in the default
#: configuration on dispatcher(branchy(12)) from one seed (shard 0's block):
#: `_Frontier(laser_evm=None, n_lanes=128)` with `n_shards = 4` set on the
#: instance, counted as EXPECTED_DEFAULT, plus its steal passes and the
#: shard block's final steal counters. tests/test_torch_frontier.py
#: recomputes it. The run never drains and ends at the step budget (64
#: chunks): the drain trigger compares the global escape count with the
#: 1024-row drain batch while the escapes fill shard 0's 256-row segment,
#: whose overflow freezes lanes that the host defers a chunk at a time
#: (the JAX frontier does the same).
EXPECTED_SHARD = {
    "chunks": 64, "drains": 0, "drained_rows": 0, "frozen_rows": 2965,
    "spilled": 0, "reseeded": 0, "lane_steps": 34432, "forks": 3844,
    "stack_pushes": 3710, "stack_pops": 3626, "deferred_blocks": 64,
    "deferred_rows": 3845, "mirror_n": 11535, "mirror_n_const": 3845,
    "merge_passes": 0, "merges": 0, "merge_ites": 0, "mem_blends": 0,
    "steal_passes": 16, "steal_rows": 536, "steals_sent": [508, 28, 0, 0],
    "steals_received": [0, 380, 128, 28],
    "deferred_sha256":
        "293e5289e0856ec85479ca919c0a472977687d6b2dd5e43f26654210c5988268",
    "mirror_sha256":
        "b7b3da3f314a2e7ec9fb7ffeb61d13689eb347a50f9b3eb434bcf59ba2419185",
    "blocked_by": {"depth": 0, "mem_sym": 0, "memory": 0,
                   "storage_keys": 0, "tstore": 0},
    "telemetry_words": [
        0, 3845, 0, 3844, 0, 1, 0, 11447, 11533, 1, 0, 0, 0, 3761, 0, 3626, 0, 0,
        0, 796, 163228, 0, 0, 134, 3710, 0, 0, 3761, 0, 0, 0, 0, 0, 0, 0, 34432,
        4096, 271, 796]}
#: the two-member fleet: branchy(12) owned by shard 0 and mem_branchy(8) by
#: shard 2 (`seed_owner_index`), fleet slots [0, 1] named as FLEET_RUN's
#: keys, the tables of the JAX static analysis of both codes
#: (`fleet_tables`), the rest as EXPECTED_SHARD
FLEET_OWNERS = [0, 2]
EXPECTED_FLEET = {
    "chunks": 64, "drains": 0, "drained_rows": 0, "frozen_rows": 3090,
    "spilled": 0, "reseeded": 0, "lane_steps": 36908, "forks": 3988,
    "stack_pushes": 3818, "stack_pops": 3734, "deferred_blocks": 64,
    "deferred_rows": 3974, "mirror_n": 11763, "mirror_n_const": 3879,
    "merge_passes": 3, "merges": 16, "merge_ites": 32, "mem_blends": 16,
    "steal_passes": 16, "steal_rows": 540, "steals_sent": [508, 28, 4, 0],
    "steals_received": [0, 380, 128, 32],
    "deferred_sha256":
        "b4b5a49ff382f294ea2e5344a64e246acd008ee860bdec8605a1553b1b411aec",
    "mirror_sha256":
        "65e6d62c18527f5e1f590aee9df5f36f308124d68063f86626b0b226c872f425",
    "blocked_by": {"depth": 47, "mem_sym": 0, "memory": 0,
                   "storage_keys": 0, "tstore": 0},
    "telemetry_words": [
        0, 3847, 0, 4004, 0, 288, 0, 12307, 12570, 2, 0, 0, 0, 3890, 0, 3734, 0,
        0, 0, 800, 170437, 0, 0, 170, 3818, 0, 0, 3890, 0, 0, 0, 0, 0, 0, 0,
        36908, 4096, 271, 800, 4, 12, 40, 80, 280, 988, 1960, 128, 34432, 2476]}


def mem_branchy_tables() -> dict:
    """DeviceFrontier's table arguments for dispatcher(mem_branchy(8))."""
    names = [f"merge@{pc:#x}" for pc in MEM_BRANCHY_JOINS]
    # diamond i writes bytes [32 i, 32 i + 32); a row's pc lies in the block
    # of the last join at or before it
    windows = [[32 * (sum(join <= pc for join in MEM_BRANCHY_JOINS) - 1)]
               for pc in MEM_BRANCHY_MEM_PCS]
    return {"tag_pcs": list(MEM_BRANCHY_JOINS), "tag_names": names,
            "merge_pcs": list(MEM_BRANCHY_JOINS), "merge_names": list(names),
            "mem_pcs": list(MEM_BRANCHY_MEM_PCS), "mem_words": windows}


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


def mem_branchy_contract(n_branches: int) -> str:
    """bench.py's memory diamonds (bench.py:96): n diamonds whose arms both
    MSTORE a different constant into the same 32-byte slot before they
    reconverge; the pad JUMPDEST keeps the siblings in lockstep."""
    lines = []
    for i in range(n_branches):
        lines += [
            f"PUSH2 {hex(4 + 32 * i)}", "CALLDATALOAD",
            f"PUSH @t{i}", "JUMPI",
            f"PUSH1 {hex(2 * i + 1)}", f"PUSH1 {hex(32 * i)}", "MSTORE",
            f"PUSH @j{i}", "JUMP",
            f"t{i}:", "JUMPDEST",
            f"PUSH1 {hex(2 * i + 2)}", f"PUSH1 {hex(32 * i)}", "MSTORE",
            "JUMPDEST",
            f"j{i}:", "JUMPDEST",
        ]
    lines.append("STOP")
    return "\n".join(lines)


def branchy_contract(n_branches: int) -> str:
    """bench.py's stress body: n sequential branches on distinct calldata
    words whose sides converge, so every combination is a live path."""
    lines = []
    for i in range(n_branches):
        lines += [f"PUSH2 {hex(4 + 32 * i)}", "CALLDATALOAD",
                  f"PUSH4 {hex(0x10000 + i)}", "LT", f"PUSH @l{i}", "JUMPI",
                  f"l{i}:", "JUMPDEST"]
    return "\n".join(lines + ["STOP"])


#: the fleet run's members, in seed and fleet-slot order
FLEET_RUN = {"branchy12": branchy_contract(N_BRANCHES),
             "mem_branchy8": mem_branchy_contract(MERGE_BRANCHES)}


#: a dispatcher with a counting loop beside three memory diamonds: its loop
#: header is tagged before the merge points
LOOPS_AND_JOINS = {
    "count()": "PUSH1 0x00\nhead:\nJUMPDEST\nDUP1\nPUSH1 0x05\nEQ\n"
               "PUSH @exit\nJUMPI\nPUSH1 0x01\nADD\nPUSH @head\nJUMP\n"
               "exit:\nJUMPDEST\nPOP\nSTOP",
    "diamonds()": mem_branchy_contract(3)}


def wide_diamonds(n_branches: int) -> str:
    """mem_branchy(n) with two-byte memory offsets, for n past 8: 40 of them
    fill the 32 tag slots and the 64 window rows."""
    lines = []
    for i in range(n_branches):
        lines += [f"PUSH2 {hex(4 + 32 * (i % 8))}", "CALLDATALOAD",
                  f"PUSH @t{i}", "JUMPI",
                  f"PUSH1 {hex(2 * i + 1)}", f"PUSH2 {hex(32 * i)}", "MSTORE",
                  f"PUSH @j{i}", "JUMP",
                  f"t{i}:", "JUMPDEST",
                  f"PUSH1 {hex(2 * i + 2)}", f"PUSH2 {hex(32 * i)}", "MSTORE",
                  "JUMPDEST", f"j{i}:", "JUMPDEST"]
    return "\n".join(lines + ["STOP"])


def fleet_tables() -> dict:
    """The JAX static analysis's tables for the fleet's two codes: those of
    mem_branchy(8) (branchy(12) has no joins)."""
    return mem_branchy_tables()


#: the JAX static analysis's tables for a code without joins or loops
#: (branchy(12))
NO_TABLES = {"tag_pcs": [], "tag_names": [], "merge_pcs": [],
             "merge_names": [], "mem_pcs": [], "mem_words": []}


def static_codes() -> dict:
    """The static_tables phase's code sets, each in seed order: branchy(12),
    mem_branchy(8), the fleet pair, the headline dispatchers
    (tools/measure_headline.py), a loop beside joins and 40 diamonds past
    the tag and window caps."""
    def stress(body):
        return assemble(dispatcher({"stress()": body}))

    return {"branchy12": [stress(branchy_contract(N_BRANCHES))],
            "mem_branchy8": [stress(mem_branchy_contract(MERGE_BRANCHES))],
            "fleet": [stress(body) for body in FLEET_RUN.values()],
            "killbilly": [assemble(dispatcher(HEADLINE_KILLBILLY))],
            "bectoken": [assemble(dispatcher(BECTOKEN))],
            "loops_and_joins": [assemble(dispatcher(LOOPS_AND_JOINS))],
            "past_the_caps": [stress(wide_diamonds(40))]}


def table_counts(tables: dict) -> dict:
    """The sizes of a set of static tables (`frontier.static_tables`'s keys)
    and the sha256 of every table's shape and values."""
    doc = {key: [list(np.shape(tables[key])),
                 np.asarray(tables[key]).tolist()]
           for key in frontier.TABLE_KEYS}
    return {"tags": len(tables["tag_pcs"]),
            "merge_pcs": len(tables["merge_pcs"]),
            "window_rows": len(tables["mem_pcs"]),
            "sha256": hashlib.sha256(json.dumps(
                doc, sort_keys=True).encode()).hexdigest()}


#: table_counts of the JAX static analysis's tables for each of
#: static_codes() (tests/test_torch_frontier.py recomputes them): the
#: fleet's are mem_branchy(8)'s, branchy(12) and the headline dispatchers
#: have no joins or loops; loops_and_joins tags its loop header before its
#: merge points, past_the_caps fills the 32 tags and the 64 window rows
_EMPTY_SHA256 = \
    "f889d5258842060f7a4a3e4507b0807d8d4d56d4feb9361f539fd32449a7eceb"
_MEM_BRANCHY_SHA256 = \
    "6a9cbbeba5b0d1aba2eb51d221b083cff7e77806674f06e98c2ce3eee216811e"
EXPECTED_STATIC = {
    "branchy12": {"tags": 0, "merge_pcs": 0, "window_rows": 0,
                  "sha256": _EMPTY_SHA256},
    "mem_branchy8": {"tags": 8, "merge_pcs": 8, "window_rows": 37,
                     "sha256": _MEM_BRANCHY_SHA256},
    "fleet": {"tags": 8, "merge_pcs": 8, "window_rows": 37,
              "sha256": _MEM_BRANCHY_SHA256},
    "killbilly": {"tags": 0, "merge_pcs": 0, "window_rows": 0,
                  "sha256": _EMPTY_SHA256},
    "bectoken": {"tags": 0, "merge_pcs": 0, "window_rows": 0,
                 "sha256": _EMPTY_SHA256},
    "loops_and_joins": {"tags": 5, "merge_pcs": 4, "window_rows": 12,
                        "sha256": "da6c8f0c43bdb4c56eadb8e0bc9a5900d8890da95"
                                  "cf85736b5f478fb92b70c82"},
    "past_the_caps": {"tags": 32, "merge_pcs": 40, "window_rows": 64,
                      "sha256": "b13e3bf55e7989a052cb692deaa3d94c32daca3e85"
                                "18bc4f68ca228fa456514b"}}


def check_tables(fr, expected: dict, what: str) -> None:
    """The tables a DeviceFrontier built for itself equal `expected` (the
    JAX static analysis's, as the constants above hold them)."""
    got = fr.tables()
    if not fr.own_tables or any(
            np.asarray(got[key]).tolist() != np.asarray(expected[key]).tolist()
            for key in frontier.TABLE_KEYS):
        raise AssertionError(f"{what}: the frontier's own tables differ from "
                             f"the JAX static analysis's: {got}")
    for key in ("merge_pcs", "mem_pcs", "mem_words"):
        if got[key].dtype != np.int32:
            raise AssertionError(f"{what}: {key} is {got[key].dtype}")


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


def host_us(fn, reps: int = 200) -> float:
    """Median host time of fn() in microseconds over `reps` calls."""
    spent = []
    for _ in range(reps):
        start = time.perf_counter()
        fn()
        spent.append(time.perf_counter() - start)
    return float(np.median(spent)) * 1e6


def lookup_us(cache, tensors_of, static: tuple) -> dict:
    """A cached plan's lookup on the host, in microseconds: building its
    key from the tensors (`key_us`) against the last-call check that
    `ops._Plans.get` makes first (`last_call_us`), the tensor list built in
    both. The cache's last call must have had these tensors."""
    hit = cache.get(tensors_of(), static, lambda: None)
    if hit is None:
        raise AssertionError("the plan looked up was not the last call's")
    return {"tensors": len(tensors_of()),
            "key_us": host_us(lambda: ops._key(tensors_of(), static)),
            "last_call_us": host_us(lambda: cache.get(tensors_of(), static,
                                                      None))}


def paired_ms(fns: dict, reps: int, rounds: int = 6) -> dict:
    """Event time of each of `fns` in ms (as event_ms), taken in turn
    `rounds` times, the order reversed every other round: each one's
    median over the rounds and its spread (least and most)."""
    times = {name: [] for name in fns}
    for turn in range(rounds):
        for name in (list(fns) if turn % 2 == 0 else list(fns)[::-1]):
            times[name].append(event_ms(fns[name], reps))
    return {name: {"ms": float(np.median(v)), "min_ms": min(v),
                   "max_ms": max(v)} for name, v in times.items()}


def profile_cuda(run, what: str, prepare=None, complete=None):
    """run() under torch.profiler (CUPTI), after prepare() outside it:
    (prepare's result, run's result, the trace's CUDA events). Now and then
    CUPTI hands back a trace without any device time, or drops a few
    kernel records; prepare() and run() then run again, three times in all,
    when the trace has no device time or `complete(events)` (the caller's
    count of the launches it knows ran) is false. A trace still short
    after that fails its caller's check."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        prepared = prepare() if prepare else None
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            result = run(prepared)
            torch.cuda.synchronize()
        events = [event for event in prof.key_averages()
                  if event.device_type == DeviceType.CUDA]
        if sum(event.self_device_time_total for event in events) > 0:
            if complete is None or complete(events):
                break
            print(f"{what}: the profiler dropped kernel records "
                  f"(attempt {attempt + 1})", file=sys.stderr, flush=True)
            continue
        print(f"{what}: the profiler recorded no device time "
              f"(attempt {attempt + 1})", file=sys.stderr, flush=True)
    return prepared, result, events


def device_times(fn, reps: int, counts: bool = False, complete=None) -> dict:
    """Mean device time in ms per fn() call over `reps` calls of every CUDA
    function it runs, by name, as torch.profiler (CUPTI) records it,
    without the host's time to enqueue them; with `counts`, (ms, launches)
    per fn() call. `complete` as in profile_cuda."""
    fn(None)  # warm
    _, _, events = profile_cuda(
        lambda _: [fn(None) for _ in range(reps)], "device_times",
        complete=complete)
    return {event.key: ((event.self_device_time_total / reps / 1e3,
                         event.count / reps) if counts
                        else event.self_device_time_total / reps / 1e3)
            for event in events}


def refill(dst_trees, src_trees) -> None:
    """Copy every leaf of `src_trees` into `dst_trees`' storage: a cached
    plan and graph stay keyed on the same tensors between timed calls."""
    for dst, src in zip(dst_trees, src_trees):
        for dst_leaf, src_leaf in zip(dst, src):
            dst_leaf.copy_(src_leaf)


def launch_table(times: dict, prefix: str, per: int, grids: dict) -> dict:
    """{kernel: {device ms, launches, blocks}} per `per` of the functions
    named `prefix`... in `device_times(..., counts=True)`."""
    table = {}
    for key, (ms, calls) in times.items():
        name = key.split("(")[0].split()[-1].split("<")[0]
        if name.startswith(prefix):
            table[name] = {"device_ms": ms / per, "launches": calls / per,
                           "blocks": grids.get(name)}
    return table


def named_ms(times: dict, names=None) -> float:
    """The device_times() of every function whose name contains one of
    `names` (all of them when None), summed."""
    total = sum(ms for key, ms in times.items()
                if names is None or any(name in key for name in names))
    if total <= 0:
        raise AssertionError(f"the profiler recorded no device time of "
                             f"{names or 'any function'}")
    return total


def launch_ms(fn, reps: int, name: str) -> float:
    """Device ms a launch of the CUDA functions whose name contains `name`
    over `reps` calls of fn(), over the launches the profiler recorded (it
    drops a few of a side stream's records)."""
    times = device_times(fn, reps, counts=True)
    ms = sum(t for key, (t, _) in times.items() if name in key)
    calls = sum(c for key, (_, c) in times.items() if name in key)
    if ms <= 0 or not calls:
        raise AssertionError(f"the profiler recorded no launch of {name}")
    return ms / calls


def device_ms(fn, reps: int, names=None) -> float:
    """Mean device time of fn() in ms over `reps` calls: every CUDA function
    it runs whose name contains one of `names` (all of them when None)."""
    return named_ms(device_times(fn, reps), names)


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
    # the messages a warp takes: the wrapper's choice against one and 32,
    # timed in turn at both shapes
    choose = ops.messages_a_warp

    def forced(per: int, call):
        def run(_):
            ops.messages_a_warp = lambda batch, device: per
            try:
                return call()
            finally:
                ops.messages_a_warp = choose
        return run

    def per_warp_ms(call, shape: int, reps: int) -> dict:
        chosen = choose(shape, dev)
        return {"chosen": chosen, **paired_ms(
            {per: forced(per, call) for per in sorted({1, chosen, 32})}, reps)}

    per_warp = {
        "messages": per_warp_ms(lambda: ops.keccak_rows(data, length), n, 20),
        "main_shape": per_warp_ms(lambda: ops.keccak_rows(
            memory, mlen, offset=offset, limit=msize, mask=mask), LANES, 50)}
    lens = mlen[mask].to(torch.int64)
    blocks = int(((lens + 1 + 135) // 136).sum())
    nbytes = int(lens.sum()) + LANES * (8 + 4 + 4 + 1 + 32)
    b_ms, b_by = bound_ms(nbytes, blocks * KECCAK_OPS_PER_BLOCK)
    record = {"phase": "keccak", "messages": n, "max_abs_err": err_msgs,
              "messages_ms": msgs_ms,
              "messages_per_s": n / (msgs_ms / 1e3),
              "main_shape": [LANES, 4096], "main_max_abs_err": err,
              "per_warp_ms": per_warp}
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

    # the same program at frontier_wide's 2048 lanes: one chunk held to the
    # twin, then K2's device time a step there
    wide = B.build_batch(mixed_specs(WIDE_LANES), device=dev)
    wide_plain = convert.clone(wide)
    for _ in range(32):
        wide = lockstep.step(wide)
        wide_plain = lockstep.step_reference(wide_plain)
    assert_same(wide, wide_plain, f"K2 mixed chunk 0 at {WIDE_LANES} lanes")
    emit({"phase": "evm_step", "bench_loop": [512, 256], "mixed": [LANES, 256],
          "mixed_wide": [WIDE_LANES, 32], "max_abs_err": 0})

    # time one step from the mixed program's first chunk (divisions, EXP,
    # MULMOD and SHA3 still ahead of most lanes), each call on the same
    # tensors refilled from the snapshot (the cached plan holds)
    nbytes, nops = step_work(snapshot)
    b_ms, b_by = bound_ms(nbytes, nops)
    timed = convert.clone(snapshot)

    def split_ms(source, tree):
        """K1's step form's and K2's device ms a step, from the profiler;
        each must launch once a step, and sha_prep (folded into K1) not at
        all."""
        times = device_times(
            lambda _: (refill([tree], [source]), ops.evm_step(tree)), 20,
            counts=True, complete=lambda events: all(
                sum(e.count for e in events if f"{name}_kernel" in e.key) == 20
                for name in ("keccak_step", "evm_step")))
        if any("sha_prep" in key for key in times):
            raise AssertionError(f"sha_prep launched: {sorted(times)}")
        split = {}
        for name in ("keccak_step", "evm_step"):
            launches = sum(count for key, (_, count) in times.items()
                           if f"{name}_kernel" in key)
            if launches != 1:
                raise AssertionError(f"{name}: {launches} launches a step")
            split[name] = named_ms({key: ms for key, (ms, _) in times.items()},
                                   [f"{name}_kernel"])
        return split

    wide_timed = convert.clone(wide)
    device, grid, k1_grid, no_sha3 = {}, {}, {}, {}
    for lanes, source, tree in ((LANES, snapshot, timed),
                                (WIDE_LANES, wide, wide_timed)):
        device[lanes] = split_ms(source, tree)
        # as the last launches recorded them: a block of a warp a lane
        grid[lanes] = ops.evm_step_grid()
        k1_grid[lanes] = ops.keccak_step_grid()
        if grid[lanes] != (lanes, 32) or k1_grid[lanes] != (lanes, 32):
            raise AssertionError(f"K1/K2 at {lanes} lanes launched "
                                 f"{k1_grid[lanes]}, {grid[lanes]}")
        # K1's step form where no lane hashes: bench.py's loop
        loop = B.build_batch([B.LaneSpec(BENCH_LOOP, gas_limit=2 ** 60)] * lanes,
                             device=dev)
        no_sha3[lanes] = split_ms(loop, convert.clone(loop))["keccak_step"]

    def ptxas(source, names):
        report = build.ptxas_report(source)
        return {name: next((props for fn, props in report.items() if name in fn), None)
                for name in names}

    k2 = {"name": "evm_step", "route": "cuda",
          "source": "mythril_tpu_torch/kernels/evm_step.cu",
          "replaces": "mythril_tpu/parallel/lockstep.py:159",
          "max_abs_err": 0,
          "ms": event_ms(lambda _: ops.evm_step(timed), 20,
                         setup=lambda: refill([timed], [snapshot])),
          "plain_ms": event_ms(lambda s: lockstep.step_reference(s), 5,
                               setup=lambda: convert.clone(snapshot)),
          "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
          "device_ms": device[LANES], "device_ms_wide": device[WIDE_LANES],
          "wide_lanes": WIDE_LANES, "grid": grid[LANES],
          "grid_wide": grid[WIDE_LANES],
          "ptxas": ptxas("evm_step", ("evm_step_kernel", "heavy_word")),
          "held_by": "phase evm_step"}
    k1_step = {"step_device_ms": {"mixed": device[LANES]["keccak_step"],
                                  "mixed_wide": device[WIDE_LANES]["keccak_step"],
                                  "no_sha3": no_sha3[LANES],
                                  "no_sha3_wide": no_sha3[WIDE_LANES]},
               "step_grid": k1_grid[LANES], "step_grid_wide": k1_grid[WIDE_LANES],
               "ptxas": ptxas("keccak", ("keccak_step_kernel", "keccak_rows_kernel"))}
    return k2, k1_step


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
    """K4 (K3 folded in; K1-K2 through it) vs the twins on contracts that
    walk the symbolic planes, a cold SLOAD pause and a concrete SHA3 on the
    device."""
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
    if any(launches[name] == 0 for name in ("keccak", "evm_step",
                                             "arena_alloc_step", "sym_step",
                                             "pack_rows")):
        raise AssertionError(f"a kernel of the slice never ran: {launches}")
    replays = dict(ops.REPLAYS)
    if replays["run_chunk"] != chunks:
        raise AssertionError(f"the slice's chunks were not graphed: {replays}")
    if snapshot is None:
        raise AssertionError("the frontier drained before the timing snapshot")

    # per-kernel times on the main path: one chunk of eager steps from the
    # snapshot, CUDA events around each host call (K4 = its pre and post
    # calls; K2 = evm_step; K1 = its step form), then the same
    # chunk under the profiler for the kernels' device time per step
    spans = {"keccak": [], "evm_step": [], "sym_step": []}
    owner = {"mtpu_keccak_step": "keccak", "mtpu_evm_step": "evm_step"}
    call = ops._call

    def timed_call(name, block):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call(name, block)
        end.record()
        spans[owner.get(name, "sym_step")].append((start, end))

    timing = [convert.clone(t) for t in snapshot]
    before = {k: int(getattr(timing[3], k)) for k in ("pops", "forks", "executed")}
    frontier.reset_esc_reference(timing[3])
    ops.step_plan(*timing)  # built before the timed span
    ops._call = timed_call
    try:
        for _ in range(CHUNK):
            timing = list(ops.sym_step(*timing))
        torch.cuda.synchronize()
    finally:
        ops._call = call
    per = {k: sum(s.elapsed_time(e) for s, e in v) / CHUNK
           for k, v in spans.items()}
    k2_only = per["evm_step"]
    k4_only = per["sym_step"]
    moved = (int(timing[3].pops) - before["pops"] + int(timing[3].esc_count)
             + int(timing[3].forks) - before["forks"])
    lane_steps = int(timing[3].executed) - before["executed"]
    eager = [convert.clone(t) for t in snapshot]
    frontier.reset_esc_reference(eager[3])
    step_times = device_times(lambda _: ops.sym_step(*eager), CHUNK)
    k4_device = named_ms(step_times, K4_KERNELS)
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
                        "sym_step": k4_only,
                        "whole_step": sum(per.values())},
          "eager_device_ms_per_step": {
              "sym_step": k4_device,
              "by_kernel": {name: named_ms(step_times, (name,))
                            for name in K4_KERNELS}},
          "replays": replays,
          "timed_chunk": {"lane_steps": lane_steps, "rows_moved": moved},
          "peak_device_bytes": peak_bytes,
          "launches": launches})
    record = {"name": "sym_step", "route": "cuda",
              "source": "mythril_tpu_torch/kernels/sym_step.cu",
              "replaces": "mythril_tpu/parallel/symstep.py:347",
              "max_abs_err": 0, "ms": k4_only, "device_ms": k4_device,
              "plain_ms": plain_ms,
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


def stress_seed(n_branches: int, body=None):
    body = body or branchy_contract(n_branches)
    code = assemble(dispatcher({"stress()": body}))
    return [(code, {}, False, 10_000_000, 0)]


#: DeviceFrontier with telemetry and state merging off (PR 2's runs)
OFF = {"telemetry": False, "state_merge": False}


def default_totals(fr) -> dict:
    """frontier_totals plus the merge totals and the final telemetry
    words of a default-configuration run."""
    return {**frontier_totals(fr), "merge_passes": fr.merge_passes,
            "merges": fr.merges, "merge_ites": fr.merge_ites,
            "mem_blends": fr.mem_blends, "blocked_by": dict(fr.blocked_by),
            "telemetry_words": [int(v) for v in fr.tel_words]}


def shard_totals(fr) -> dict:
    """default_totals plus the steal passes and the steal counters of a
    sharded run."""
    return {**default_totals(fr), "steal_passes": fr.steal_passes,
            "steal_rows": int(fr.steal_rows),
            "steals_sent": [int(v) for v in fr.steals_sent],
            "steals_received": [int(v) for v in fr.steals_received]}


def check_same(got, ref, what: str) -> None:
    for mine, theirs in zip(got, ref):
        if mine.dtype != theirs.dtype or not torch.equal(mine, theirs):
            raise AssertionError(f"{what} disagrees with its twin")


def phase_frontier_programs(dev) -> list:
    """K5-K8 vs their twins at the main path's shapes, two chunks into the
    slice, each timed beside its twin and its library yardstick."""
    fr = frontier.DeviceFrontier(LANES, device=dev, **OFF)
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
    # the chunk graph's lookup in run_chunk (the last call's tensors)
    _, step_static = ops._step_parts(
        state, planes, arena, sched, ops.LANES_PER_BLOCK, ops.LANE_GROUP)
    chunk_lookup = lookup_us(
        ops._GRAPHS, lambda: ops._step_parts(
            state, planes, arena, sched, ops.LANES_PER_BLOCK,
            ops.LANE_GROUP)[0], step_static + (CHUNK,))

    # K5: the summary, its grid as the launch recorded it, its device time
    # by launch, and the drain loop's read beside a pinned copy, timed in
    # turn on one plan
    ref = frontier.summary_reference(state, planes, arena, sched)
    packed = frontier.summary(state, planes, arena, sched).clone()
    check_same([packed], [ref], "K5")
    grid = ops.frontier_summary_grid()
    esc_rows = sched.esc_state.status.shape[0]
    if grid[0] < 2:
        raise AssertionError(f"K5 at {esc_rows} escape rows launched {grid}")
    read = frontier.summary_read(state, planes, arena, sched)
    if not np.array_equal(read, ref.cpu().numpy()):
        raise AssertionError("K5's read disagrees with its twin")
    out = frontier.summary(state, planes, arena, sched)
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    copied = torch.cuda.Event()

    def pinned_read(_):
        host.copy_(frontier.summary(state, planes, arena, sched),
                   non_blocking=True)
        copied.record()
        copied.synchronize()
        return host.numpy()

    if not np.array_equal(pinned_read(None), read):
        raise AssertionError("K5's pinned read disagrees with its twin")
    k5_times = device_times(lambda _: frontier.summary(state, planes, arena,
                                                       sched), 20)
    k5_split = {name: named_ms(k5_times, (name,))
                for name in ("frontier_summary_kernel",
                             "frontier_summary_combine_kernel")}
    live_rows = esc_count
    b_ms, b_by = bound_ms(live_rows * (4 + 4 + 64 + 4) + LANES * 12
                          + (13 + 3 * LANES) * 8 + 6 * 8 + 2 * 4, 0)
    records.append({
        "name": "frontier_summary", "route": "cuda",
        "source": "mythril_tpu_torch/kernels/frontier_summary.cu",
        "replaces": "mythril_tpu/parallel/frontier.py:99", "max_abs_err": 0,
        "ms": event_ms(lambda _: frontier.summary(state, planes, arena,
                                                  sched), 50),
        "device_ms": sum(k5_split.values()),
        "device_ms_by_kernel": k5_split,
        "plain_ms": event_ms(lambda _: frontier.summary_reference(
            state, planes, arena, sched), 20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "library": "none: no single PyTorch call packs the summary",
        "escape_rows": esc_rows, "live_rows": live_rows,
        "grid": {"blocks": grid[0], "threads": grid[1]},
        "lookup": lookup_us(ops._SUMMARY_PLANS, lambda: ops._summary_tensors(
            state, planes, arena, sched), ()),
        "read": paired_ms({
            "pageable": lambda _: frontier.summary_read(state, planes, arena,
                                                        sched),
            "pinned": pinned_read}, 50),
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
    # each entry's grid as its last launch recorded it (the maxima over
    # more than one block at the drain's rows), its device time by launch,
    # and the plan lookup of the pool's rows (key against last call)
    k6_grid = ops.pack_rows_grid()
    if k6_grid["row_maxima"][0] < 2:
        raise AssertionError(f"K6 row_maxima over {bucket} rows launched {k6_grid}")

    def by_launch(fn, names):
        times = device_times(fn, 20)
        return {name: named_ms(times, (name,)) for name in names}

    k6_device = {
        **by_launch(lambda _: frontier.row_maxima(*rows, index),
                    ("row_maxima_kernel", "row_maxima_combine_kernel")),
        **by_launch(lambda _: frontier.pack_rows(*rows, index, *widths),
                    ("pack_rows_kernel",)),
        **by_launch(lambda _: frontier.reset_esc(reset_k), ("reset_esc_kernel",))}
    frontier.pack_rows(*rows, index, *widths)
    k6_lookup = lookup_us(ops._ROW_PLANS, lambda: list(rows[0]) + list(rows[1]), ())
    records.append({
        "name": "pack_rows", "route": "cuda",
        "source": "mythril_tpu_torch/kernels/pack_rows.cu",
        "replaces": "mythril_tpu/parallel/frontier.py:156", "max_abs_err": 0,
        "ms": event_ms(lambda _: frontier.pack_rows(*rows, index, *widths),
                       50),
        "device_ms": k6_device["pack_rows_kernel"],
        "plain_ms": event_ms(lambda _: frontier.pack_rows_reference(
            *rows, index, *widths), 20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "library": "none: no single PyTorch call packs the row fields",
        "row_maxima_ms": maxima_ms, "reset_esc_ms": reset_ms,
        "device_ms_by_kernel": k6_device, "grid": k6_grid,
        "lookup": k6_lookup, "rows": bucket,
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
    # clamped gather indices, dropped scatter pads, separate source leaves
    odd = torch.tensor([-5, 3, LANES + 7, LANES - 1, 0, 2 ** 31 - 1, -2 ** 31, 9],
                       dtype=torch.int32, device=dev)
    odd_rows = frontier.gather_rows(state, planes, odd)
    odd_ref = frontier.gather_rows_reference(state, planes, odd)
    for got, ref in zip(odd_rows, odd_ref):
        assert_same(got, ref, "K7 gather, clamped indices")
    pads = torch.tensor([7, -1, LANES, 40, 2 ** 31 - 1, 11, -2 ** 31, 100],
                        dtype=torch.int32, device=dev)
    drop_k = [convert.clone(t) for t in (state, planes)]
    drop_p = [convert.clone(t) for t in (state, planes)]
    frontier.scatter_rows(*drop_k, pads, *odd_ref)
    frontier.scatter_rows_reference(*drop_p, pads, *odd_ref)
    assert_same(drop_k[0], drop_p[0], "K7 scatter state, dropped pads")
    assert_same(drop_k[1], drop_p[1], "K7 scatter planes, dropped pads")
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
        "blocks": ops.rows_plan(state, planes, lanes).blocks,
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
               [t.cpu() for t in A.fetch_delta_reference(
                   arena, 1, 0, d_bucket, d_cbucket)], "K8")
    # the whole refresh, from the launch to the mirror landed (HostArena's
    # delta fetch, its landing in host memory and the mirror's copy), of
    # that delta into an emptied mirror, host clock
    mirror = A.HostArena(arena, 1, 0)

    def refresh():
        mirror.n, mirror.n_const = 1, 0
        mirror.refresh(arena, arena_n, arena_nc)

    refresh()
    for col in A.ROW_COLS:
        if not np.array_equal(getattr(mirror, col)[1:arena_n],
                              getattr(arena, col)[1:arena_n].cpu().numpy()):
            raise AssertionError(f"K8's refresh: mirror column {col} differs")
    if not np.array_equal(mirror.const_vals[:arena_nc], arena.const_vals[
            :arena_nc].cpu().numpy().view(np.uint32)):
        raise AssertionError("K8's refresh: mirror consts differ")
    # a refresh is one launch on its plan: 20 refreshes launch K8 20 times
    # and allocate no device memory, and their profile holds K8 and no
    # copy (CUPTI drops a few of the copy stream's kernel records)
    def twenty(_):
        before = ops.LAUNCHES["arena_delta"]
        for _ in range(20):
            refresh()
        return ops.LAUNCHES["arena_delta"] - before

    allocations = torch.cuda.memory_stats()["allocation.all.allocated"]
    _, launched, events = profile_cuda(twenty, "K8 refresh")
    k8_profile = {event.key: event.count for event in events}
    if torch.cuda.memory_stats()["allocation.all.allocated"] != allocations \
            or launched != 20 or any("emcpy" in key for key in k8_profile) \
            or not any("arena_delta_kernel" in key for key in k8_profile):
        raise AssertionError(f"K8's refresh is not one launch: {launched} "
                             f"launches, profile {k8_profile}")
    cols = [getattr(arena, col) for col in A.ROW_COLS]
    host_rows = torch.empty((6, d_bucket), dtype=torch.int32, pin_memory=True)
    host_consts = torch.empty((d_cbucket, 16), dtype=torch.int32,
                              pin_memory=True)

    def library_delta():
        for position, col in enumerate(cols):
            host_rows[position].copy_(col.narrow(0, 1, d_bucket),
                                      non_blocking=True)
        host_consts.copy_(arena.const_vals.narrow(0, 0, d_cbucket),
                          non_blocking=True)
        torch.cuda.current_stream().synchronize()

    # the device-to-pinned copy rate of this card (64 MiB)
    big = torch.empty(1 << 26, dtype=torch.uint8, device=dev)
    big_host = torch.empty(1 << 26, dtype=torch.uint8, pin_memory=True)
    pinned_rate = (1 << 26) / (event_ms(lambda _: big_host.copy_(
        big, non_blocking=True), 5) * 1e-3)
    del big, big_host
    delta_bytes = 6 * d_bucket * 4 + d_cbucket * 64
    b_ms = max(bound_ms(delta_bytes, 0)[0],
               delta_bytes / pinned_rate * 1e3)
    records.append({
        "name": "arena_delta", "route": "cuda",
        "source": "mythril_tpu_torch/kernels/arena_delta.cu",
        "replaces": "mythril_tpu/parallel/arena.py:185", "max_abs_err": 0,
        "ms": host_us(refresh) / 1e3,
        "ms_is": "host clock, launch to mirror landed (HostArena.refresh)",
        "fetch_ms": host_us(lambda: [t.cpu() for t in A.fetch_delta(
            arena, 1, 0, d_bucket, d_cbucket)]) / 1e3,
        "device_ms": launch_ms(lambda _: A.fetch_delta(
            arena, 1, 0, d_bucket, d_cbucket), 20, "arena_delta_kernel"),
        "plain_ms": host_us(lambda: [t.cpu() for t in A.fetch_delta_reference(
            arena, 1, 0, d_bucket, d_cbucket)], 50) / 1e3,
        "plain_is": "host clock, the twin on the card, landed by .cpu()",
        "bound_ms": b_ms, "bound_by": "bytes",
        "bound_is": "the delta read once at 3.35 TB/s, or written to the "
                    "host once at the measured pinned rate (the larger)",
        "pinned_bytes_per_s": pinned_rate, "delta_bytes": delta_bytes,
        "library_ms": host_us(library_delta) / 1e3,
        "library": "narrow + copy_ into pinned host tensors (7 calls) and "
                   "a wait, host clock",
        "refresh_profile": k8_profile,
        "held_by": "phase frontier_programs"})
    emit({"phase": "frontier_programs", "esc_count": esc_count,
          "esc_rows": esc_cap, "drain_bucket": bucket,
          "pack_widths": list(widths), "pack_bytes": pack_bytes,
          "gather_lanes": 32, "delta": [d_bucket, d_cbucket],
          "max_abs_err": 0, "chunk_graph_lookup": chunk_lookup,
          "ms": {r["name"]: r["ms"] for r in records}})
    return records


#: the drain loop's calls a chunk's host time is split by (HOST_CALLS[:-1])
#: and the rest of the chunk's host time ("other")
HOST_CALLS = ("run_chunk", "steal_pass", "summary_read", "decode", "drain",
              "other")


def drive_frontier(fr, seeds, by_chunk: bool = False) -> dict:
    """Seed and run one DeviceFrontier with the launch counts zeroed just
    before and read just after; returns the run's timing record. Each
    chunk's host time (from one `run_chunk` call to the next, or to the
    run's end) is split by call: the chunk's enqueue, the steal pass, the
    summary with its read (which waits for the chunk's device work), the
    decode, the drain (escape fetch and flush, deferral, spill, reseed) and
    the rest; the record holds the mean per chunk and, with `by_chunk`,
    every chunk's."""
    state, planes = fr.seed(seeds)
    chunk_events = []
    drain_s, setup_s = [0.0], [0.0]
    chunk_host = []   # per chunk: {call: seconds}, and its start
    run_chunk = symstep.run_chunk
    steal_pass, summary_read = frontier.steal_pass, frontier.summary_read

    def host_timed(fn, total=None, call=None):
        def run(*args, **kwargs):
            start = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent = time.perf_counter() - start
                if total is not None:
                    total[0] += spent
                if call and chunk_host:
                    chunk_host[-1][call] += spent
        return run

    def timed_chunk(*args):
        chunk_host.append({**{call: 0.0 for call in HOST_CALLS},
                           "start": time.perf_counter()})
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run_chunk(*args)
        end.record()
        chunk_events.append((start, end))
        chunk_host[-1]["run_chunk"] = time.perf_counter() \
            - chunk_host[-1]["start"]
        return out

    for name in ("_fetch_escapes", "_flush_backlog", "_defer_lanes",
                 "_spill_host", "_reseed_host"):
        setattr(fr, name, host_timed(getattr(fr, name), drain_s, "drain"))
    fr._decode_summary = host_timed(fr._decode_summary, call="decode")
    fr.new_sched = host_timed(fr.new_sched, setup_s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    symstep.run_chunk = timed_chunk
    frontier.steal_pass = host_timed(steal_pass, call="steal_pass")
    frontier.summary_read = host_timed(summary_read, call="summary_read")
    ops.reset_launches()
    start = time.perf_counter()
    try:
        fr.run(state, planes)
        torch.cuda.synchronize()
    finally:
        symstep.run_chunk = run_chunk
        frontier.steal_pass, frontier.summary_read = steal_pass, summary_read
    end = time.perf_counter()
    wall = end - start
    launches = dict(ops.LAUNCHES)
    chunk_ms = sum(s.elapsed_time(e) for s, e in chunk_events)
    chunks = max(fr.chunks, 1)
    for index, record in enumerate(chunk_host):
        until = chunk_host[index + 1]["start"] if index + 1 < len(chunk_host) \
            else end
        record["other"] = until - record.pop("start") - sum(
            record[call] for call in HOST_CALLS[:-1])
    host = {call: [record[call] * 1e3 for record in chunk_host]
            for call in HOST_CALLS}
    timing = {"launches": launches, "replays": dict(ops.REPLAYS),
              "wall_s": wall, "setup_ms": setup_s[0] * 1e3,
              "chunk_stream_ms": chunk_ms / chunks,
              "host_ms_per_chunk": (wall * 1e3 - chunk_ms) / chunks,
              "drain_host_ms_per_chunk": drain_s[0] * 1e3 / chunks,
              "host_ms_by_call": {call: sum(values) / chunks
                                  for call, values in host.items()},
              "lane_steps_per_s": fr.lane_steps / wall,
              "peak_device_bytes": torch.cuda.max_memory_allocated()}
    if by_chunk:
        timing["host_ms_by_chunk"] = host
    return timing


#: K4's CUDA functions (K9 is the TEL instantiation of the counting ones)
K4_KERNELS = ("sym_seed_count_kernel", "sym_seed_seg_kernel",
              "sym_seed_apply_kernel", "sym_move_kernel",
              "sym_classify_kernel", "sym_alloc_count_kernel",
              "sym_alloc_seg_kernel", "sym_planes_kernel",
              "sym_esc_seg_kernel", "sym_esc_apply_kernel",
              "sym_fork_seg_kernel", "sym_fork_apply_kernel")

#: CUDA function -> the port kernel (wrapper) that launches it (K9 runs
#: inside K4's launches: its device time is phase telemetry's; the folded
#: K3 allocations run inside K4's sym_alloc_*/sym_planes launches and
#: K10's merge_alloc_seg/merge_nodes launches)
KERNEL_OF = {
    "keccak_rows_kernel": "keccak", "keccak_step_kernel": "keccak",
    "evm_step_kernel": "evm_step", "arena_alloc_kernel": "arena_alloc",
    **{name: "sym_step" for name in K4_KERNELS},
    "frontier_summary_kernel": "frontier_summary",
    "frontier_summary_combine_kernel": "frontier_summary",
    "merge_hash_kernel": "merge_pass", "merge_pair_kernel": "merge_pass",
    "merge_keys_kernel": "merge_pass", "merge_sort_stage_kernel": "merge_pass",
    "merge_pairs_kernel": "merge_pass",
    "merge_check_kernel": "merge_pass", "merge_nodes_kernel": "merge_pass",
    "merge_alloc_seg_kernel": "merge_pass",
    "merge_apply_kernel": "merge_pass", "merge_blocked_kernel": "merge_pass",
    "steal_plan_kernel": "steal_pass", "steal_move_kernel": "steal_pass",
    "row_maxima_kernel": "pack_rows", "row_maxima_combine_kernel": "pack_rows",
    "pack_rows_kernel": "pack_rows",
    "reset_esc_kernel": "pack_rows", "gather_rows_kernel": "gather_rows",
    "scatter_rows_kernel": "gather_rows",
    "arena_delta_kernel": "arena_delta"}


def k4_table(times: dict, steps: float = 1.0) -> dict:
    """K4's CUDA functions as instantiated ("sym_classify_kernel<true>")
    from `{profiler key: (device ms, launches)}` over `steps` steps: each
    one's device ms a launch and launches a step."""
    table = {}
    for key, (ms, calls) in times.items():
        name = key.split("(")[0].split()[-1]
        if name.split("<")[0] in K4_KERNELS and calls:
            table[name] = {"ms_per_launch": ms / calls,
                           "launches_per_step": calls / steps}
    return table


def k9_increments(tel: dict, plain: dict) -> dict:
    """K9's device time by launch: for each of K4's functions, its device
    ms a launch in the telemetry run (the TEL instantiation, or the
    untemplated function) minus that in the plain run (the TEL = false
    instantiation), and that difference a step; `total` sums the steps'."""
    out, total = {}, 0.0
    for name in K4_KERNELS:
        on = tel.get(f"{name}<true>") or tel.get(name)
        off = plain.get(f"{name}<false>") or plain.get(name)
        if on is None or off is None:
            continue
        k9 = on["ms_per_launch"] - off["ms_per_launch"]
        out[name] = {"tel_ms": on["ms_per_launch"],
                     "plain_ms": off["ms_per_launch"], "k9_ms": k9,
                     "launches_per_step": on["launches_per_step"],
                     "k9_ms_per_step": k9 * on["launches_per_step"]}
        total += k9 * on["launches_per_step"]
    out["total"] = {"k9_ms_per_step": total}
    return out


def k9_eager(snapshot, steps: int) -> tuple:
    """K9 by launch over `steps` eager steps from `snapshot` (a tree with
    the plane armed), with the plane and without it: both walk the same
    states, since the plane changes nothing else. Returns (increments,
    K4's device ms a step with the plane, without it)."""
    on = [convert.clone(t) for t in snapshot]
    off = [convert.clone(t) for t in snapshot]
    off[3] = off[3]._replace(telemetry=None)
    tables = [k4_table(device_times(lambda _, tree=tree: ops.sym_step(*tree),
                                    steps, counts=True))
              for tree in (on, off)]
    step_ms = [sum(f["ms_per_launch"] * f["launches_per_step"]
                   for f in table.values()) for table in tables]
    return k9_increments(*tables), step_ms[0], step_ms[1]


def ptxas_side_by_side(source: str, names) -> dict:
    """ptxas's registers, stack frame and spills of each function's TEL
    (`<true>`) and plain (`<false>`) instantiations, side by side
    (`untemplated` for a function with one)."""
    out = {}
    for mangled, info in build.ptxas_report(source).items():
        name = next((n for n in names if n in mangled), None)
        if name is None:
            continue
        kind = ("tel" if "ILb1E" in mangled else
                "plain" if "ILb0E" in mangled else "untemplated")
        out.setdefault(name, {})[kind] = info
    return out


#: K4's launches over lanes (many blocks a launch); the rest run one block
K4_MANY_BLOCKS = ("sym_seed_count_kernel", "sym_seed_apply_kernel",
                  "sym_move_kernel", "sym_classify_kernel",
                  "sym_alloc_count_kernel", "sym_planes_kernel",
                  "sym_esc_apply_kernel", "sym_fork_apply_kernel")


def global_atomics(source: str, names) -> dict:
    """Global-memory atomic instructions (RED, ATOM; not the shared ATOMS)
    in the SASS of each instantiation of `names` in the built `source`,
    as cuobjdump lists it: {function: {"tel" | "plain" | "untemplated": n}}."""
    import re

    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", build.library_path(source)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            mangled = found.group(1)
            name = next((n for n in names if n in mangled), None)
            current = None
            if name is not None:
                kind = ("tel" if "ILb1E" in mangled else
                        "plain" if "ILb0E" in mangled else "untemplated")
                current = counts.setdefault(name, {}).setdefault(kind, [0])
            continue
        if current is not None and re.search(r"\b(RED|REDG|ATOM|ATOMG)\.", line):
            current[0] += 1
    return {name: {kind: n[0] for kind, n in kinds.items()}
            for name, kinds in counts.items()}


def profiled_run(make, seeds) -> tuple:
    """Run the drain loop again, on a DeviceFrontier from make(), under
    torch.profiler (CUPTI): (the frontier, its record of device time per
    port kernel and for everything else on the card (copies, fills,
    PyTorch's own kernels), and the share of the run's wall time the card
    was idle). Profiling slows the host, so the wall here is longer than
    the unprofiled run's."""
    def prepare():
        fr = make()
        return fr, fr.seed(seeds), ops.LAUNCHES["evm_step"]

    def run(prepared):
        fr, (state, planes), _ = prepared
        start = time.perf_counter()
        fr.run(state, planes)
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3

    def complete(events):
        counts = [sum(e.count for e in events if f"{name}_kernel" in e.key)
                  for name in ("keccak_step", "evm_step")]
        return counts[0] == counts[1]

    (fr, _, steps), wall_ms, events = profile_cuda(run, "profiled_run",
                                                   prepare, complete)
    steps = max(ops.LAUNCHES["evm_step"] - steps, 1)
    by_kernel = {name: 0.0 for name in ops.LAUNCHES}
    device_calls = {name: 0 for name in ops.LAUNCHES}
    step_split = {"keccak_step": 0.0, "evm_step": 0.0}
    step_calls = {name: 0 for name in step_split}
    other_ms = 0.0
    for event in events:
        ms = event.self_device_time_total / 1e3
        if "sha_prep" in event.key:
            raise AssertionError(f"sha_prep launched: {event.key}")
        for name in step_split:
            if f"{name}_kernel" in event.key:
                step_split[name] += ms
                step_calls[name] += event.count
        owner = next((kernel for function, kernel in KERNEL_OF.items()
                      if function in event.key), None)
        if owner is None:
            other_ms += ms
        else:
            by_kernel[owner] += ms
            device_calls[owner] += event.count
    busy_ms = sum(by_kernel.values()) + other_ms
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    if step_calls["keccak_step"] != step_calls["evm_step"]:
        raise AssertionError(f"a step launched K1 other than once: {step_calls}")
    return fr, {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "step_device_ms_per_step": {name: ms / steps
                                            for name, ms in step_split.items()},
                "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
                "kernel_device_ms": by_kernel, "device_calls": device_calls,
                "other_device_ms": other_ms,
                "k4_functions": k4_table(
                    {event.key: (event.self_device_time_total / 1e3,
                                 event.count) for event in events}, steps)}


def checked_run(make, seeds, totals, expected: dict, what: str,
                tables=None) -> int:
    """One more drive of a DeviceFrontier from make() with every summary it
    reads (K5 and its copy to the host) held word for word to the twin on the
    same tensors, its totals(fr) to `expected` and, given `tables`, the
    tables it built for itself to them; returns the summaries checked."""
    read, checked = frontier.summary_read, [0]

    def check(state, planes, arena, sched):
        got = read(state, planes, arena, sched)
        ref = frontier.summary_reference(state, planes, arena, sched)
        if not np.array_equal(got, ref.cpu().numpy()):
            raise AssertionError(f"{what}: K5 disagrees with its twin at "
                                 f"summary {checked[0]}")
        checked[0] += 1
        return got

    fr = make()
    frontier.summary_read = check
    try:
        fr.run(*fr.seed(seeds))
    finally:
        frontier.summary_read = read
    check_totals(totals(fr), expected, f"{what} (summaries checked)")
    if tables is not None:
        check_tables(fr, tables, f"{what} (summaries checked)")
    return checked[0]


def check_totals(totals: dict, expected: dict, what: str) -> None:
    if totals != expected:
        diff = {k: (totals.get(k), v) for k, v in expected.items()
                if totals.get(k) != v}
        raise AssertionError(f"{what} differs from the JAX reference: {diff}")


def phase_static_tables() -> None:
    """The port's static analysis on the host: for each of static_codes(),
    the tables `frontier.static_tables` builds, held to EXPECTED_STATIC (the
    JAX static analysis's), the cold build (a fresh Disassembly per code:
    the CFA, absint and taint passes as `DeviceFrontier.seed` warms them,
    then the tables; median of 5) and the memoized lookup (median of 200)."""
    record = {}
    for name, codes in static_codes().items():
        cold = []
        for _ in range(5):
            disassemblies = {}
            start = time.perf_counter()
            frontier.warm_static(codes, disassemblies)
            tables = frontier.static_tables(codes,
                                            disassemblies=disassemblies)
            cold.append(time.perf_counter() - start)
        counts = table_counts(tables)
        if counts != EXPECTED_STATIC[name]:
            raise AssertionError(f"static_tables {name}: {counts} differs "
                                 f"from the JAX analysis's "
                                 f"{EXPECTED_STATIC[name]}")
        record[name] = {**counts, "codes": len(codes),
                        "code_bytes": sum(len(code) for code in codes),
                        "cold_ms": float(np.median(cold)) * 1e3,
                        "memo_us": host_us(lambda: frontier.static_tables(
                            codes, disassemblies=disassemblies))}
    emit({"phase": "static_tables", "tables": record})


def phase_frontier(dev) -> tuple:
    # the first run of the process pays one-time costs (pinned host pages,
    # the copy stream, pool allocations); the second is the steady state
    cold = frontier.DeviceFrontier(LANES, device=dev, **OFF)
    cold_wall = drive_frontier(cold, stress_seed(N_BRANCHES))["wall_s"]
    check_totals(frontier_totals(cold), EXPECTED_FRONTIER, "cold frontier")
    fr = frontier.DeviceFrontier(LANES, device=dev, **OFF)
    timing = drive_frontier(fr, stress_seed(N_BRANCHES), by_chunk=True)
    totals = frontier_totals(fr)
    check_totals(totals, EXPECTED_FRONTIER, "frontier")
    # one K8 plan (and pinned staging) served every refresh of the drive
    delta_plan = ops.delta_plan(fr.arena, fr.harena._key)
    if delta_plan.launches != timing["launches"]["arena_delta"]:
        raise AssertionError(f"K8: {delta_plan.launches} of the drive's "
                             f"{timing['launches']['arena_delta']} refreshes "
                             "on its mirror's plan")
    replay, profiled = profiled_run(
        lambda: frontier.DeviceFrontier(LANES, device=dev, **OFF),
        stress_seed(N_BRANCHES))
    check_totals(frontier_totals(replay), EXPECTED_FRONTIER, "profiled frontier")
    checked = checked_run(lambda: frontier.DeviceFrontier(LANES, device=dev, **OFF),
                          stress_seed(N_BRANCHES), frontier_totals,
                          EXPECTED_FRONTIER, "frontier")
    emit({"phase": "frontier", "contract": f"dispatcher(branchy({N_BRANCHES}))",
          "lanes": LANES, "chunk": fr.chunk, "row_bytes": fr.row_bytes,
          "drain_batch": fr.drain_batch, "arena_capacity": fr.arena.capacity,
          **totals, **timing, "cold_wall_s": cold_wall,
          "k8_plan": {"refreshes": delta_plan.launches,
                      "staging_slot_words": delta_plan.slot_words},
          "profiled": profiled, "summaries_checked": checked})
    return timing, profiled


def phase_frontier_spill(dev) -> dict:
    def make():
        return frontier.DeviceFrontier(SPILL_LANES, device=dev,
                                       stack_bytes=SPILL_STACK_ROWS * 39306,
                                       **OFF)

    fr = make()
    timing = drive_frontier(fr, stress_seed(SPILL_BRANCHES))
    if fr.row_bytes != 39306:
        raise AssertionError(f"row bytes {fr.row_bytes} != 39306")
    totals = frontier_totals(fr)
    check_totals(totals, EXPECTED_SPILL, "frontier_spill")
    if not (fr.spilled and fr.reseeded and fr.frozen_rows):
        raise AssertionError("the spill run missed a path")
    checked = checked_run(make, stress_seed(SPILL_BRANCHES), frontier_totals,
                          EXPECTED_SPILL, "frontier_spill")
    emit({"phase": "frontier_spill",
          "contract": f"dispatcher(branchy({SPILL_BRANCHES}))",
          "lanes": SPILL_LANES, "stack_rows": SPILL_STACK_ROWS,
          **totals, **timing, "summaries_checked": checked})
    return timing


# ---- phases 10-13: the default configuration ---------------------------------------

#: telemetry tags of phase telemetry: pcs the planes contracts' lanes pass
#: and one no lane reaches; contexts 0..2 -> fleet slots
TEL_TAG_PCS = [5, 13, 0x1B, 0x40, 0x7FF]
TEL_FLEET_SLOTS = [0, 1, 0]


def phase_telemetry(dev) -> dict:
    """K9 (K4's TEL instantiation) and K5's tail vs the twins."""
    codes = [assemble(dispatcher({"planes()": PLANES_SOURCE})),
             assemble(dispatcher(KILLBILLY)),
             assemble(dispatcher({"stress()": branchy_contract(3)}))]
    tree = seed_frontier(dev, codes, base_sym=[1])
    tree[3] = tree[3]._replace(telemetry=symstep.new_telemetry(
        TEL_TAG_PCS, TEL_FLEET_SLOTS, 2, device=dev))
    plain = [convert.clone(t) for t in tree]
    snapshot = None
    for chunk in range(2):
        tree = list(symstep.run_chunk(*tree, CHUNK))
        plain = list(symstep.run_chunk_reference(*plain, CHUNK))
        for kind, got, ref in zip(("state", "planes", "arena", "sched"),
                                  tree, plain):
            assert_same(got, ref, f"telemetry chunk {chunk} {kind}")
        check_same([frontier.summary(*tree)],
                   [frontier.summary_reference(*plain)], "K5 telemetry tail")
        if chunk == 0:
            snapshot = [convert.clone(t) for t in tree]
        drain(tree, at_stop=False)
        drain(plain, at_stop=False, reset=frontier.reset_esc_reference)
    words = symstep.telemetry_words(tree[3].telemetry).cpu().tolist()
    lifecycle = dict(zip(symstep.LIFECYCLE_NAMES, tree[3].telemetry
                         .lifecycle.cpu().tolist()))
    if not (lifecycle["cold_sloads"] and lifecycle["esc_buffered"]
            and lifecycle["forks_claimed"]):
        raise AssertionError(f"the telemetry run missed a path: {lifecycle}")

    # K9's device cost per step and by launch: the TEL instantiation against
    # the plain one, a chunk of eager steps each from the same snapshot; at
    # 2048 lanes from one graphed chunk of wide_tree's 256 seeds with the
    # plane armed, its escape rows drained
    by_launch, on_ms, off_ms = k9_eager(snapshot, CHUNK)
    wide = wide_tree(dev, 1)
    wide[3] = wide[3]._replace(telemetry=symstep.new_telemetry(
        TEL_TAG_PCS, TEL_FLEET_SLOTS, 2, device=dev))
    wide = list(symstep.run_chunk(*wide, CHUNK))
    frontier.reset_esc(wide[3])
    wide_by_launch, wide_on_ms, wide_off_ms = k9_eager(wide, 16)
    registers = ptxas_side_by_side("sym_step", K4_KERNELS)
    # no launch over lanes adds to the plane with a global atomic: the TEL
    # instantiations of K4's many-block launches hold none (the plain
    # classify holds the executed count's, which shows the search works)
    atomics = global_atomics("sym_step", K4_KERNELS)
    shared = {name: kinds for name, kinds in atomics.items()
              if name in K4_MANY_BLOCKS and kinds.get("tel")}
    if shared or not atomics.get("sym_classify_kernel", {}).get("plain"):
        raise AssertionError(f"K9: global atomics in the many-block TEL "
                             f"launches: {shared} (found {atomics})")
    plain_on = [convert.clone(t) for t in snapshot]
    plain_off = [convert.clone(t) for t in snapshot]
    plain_off[3] = plain_off[3]._replace(telemetry=None)
    # the twin's plane costs the device time of its counting ops: the same
    # on-off difference over every CUDA function of the twin step (its
    # event-timed step is host-bound and spreads by more than the plane)
    plain_on_ms = device_ms(
        lambda _: symstep.sym_step_reference(*plain_on), 16)
    plain_off_ms = device_ms(
        lambda _: symstep.sym_step_reference(*plain_off), 16)
    plain_ms = plain_on_ms - plain_off_ms
    tel = snapshot[3].telemetry
    # the plane's words read and written once, two scratch words per lane
    nbytes = 2 * 8 * int(symstep.telemetry_words(tel).shape[0]) \
        + LANES * (2 * 4 * 2 + 4) + 4 * (len(TEL_TAG_PCS)
                                         + len(TEL_FLEET_SLOTS))
    b_ms, b_by = bound_ms(nbytes, LANES * (4 + len(TEL_TAG_PCS)))
    emit({"phase": "telemetry", "contracts": ["planes()", "KILLBILLY",
                                              "branchy(3)"],
          "chunks": 2, "tag_pcs": TEL_TAG_PCS, "fleet_slots": TEL_FLEET_SLOTS,
          "telemetry_words": words, "max_abs_err": 0,
          "step_device_ms": {"tel": on_ms, "plain": off_ms,
                             "k9": on_ms - off_ms},
          "wide_step_device_ms": {"lanes": WIDE_LANES, "tel": wide_on_ms,
                                  "plain": wide_off_ms,
                                  "k9": wide_on_ms - wide_off_ms},
          "k9_by_launch": {"lanes_128": by_launch,
                           f"lanes_{WIDE_LANES}": wide_by_launch},
          "ptxas": registers, "global_atomics": atomics,
          "twin_step_device_ms": {"tel": plain_on_ms, "plain": plain_off_ms,
                                  "plane": plain_ms}})
    return {"name": "telemetry", "route": "cuda",
            "source": "mythril_tpu_torch/kernels/sym_step.cu",
            "replaces": "mythril_tpu/parallel/symstep.py:822",
            "max_abs_err": 0, "ms": on_ms - off_ms,
            "device_ms": on_ms - off_ms, "plain_ms": plain_ms,
            "wide_device_ms": wide_on_ms - wide_off_ms,
            "k9_by_launch_eager": {
                "lanes_128": {name: v["k9_ms_per_step"]
                              for name, v in by_launch.items()},
                f"lanes_{WIDE_LANES}": {name: v["k9_ms_per_step"]
                                        for name, v in wide_by_launch.items()}},
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library": "none: no PyTorch call computes the counters",
            "held_by": "phase telemetry"}


#: the merge_kernel phase's runs: (branches, body, the tables the frontier
#: must build for itself)
MERGE_RUNS = {"branchy12": (N_BRANCHES, None, NO_TABLES),
              "mem_branchy8": (0, mem_branchy_contract(MERGE_BRANCHES),
                               mem_branchy_tables())}


def captured_merges(dev, name) -> list:
    """The (state, planes, arena, tables) each merge pass of a default
    DeviceFrontier(128) run on `name` is handed, cloned before the pass; the
    frontier builds its tables itself."""
    branches, body, tables = MERGE_RUNS[name]
    captured = []
    merge_pass = symstep.merge_pass

    def capture(state, planes, arena, *args, **kwargs):
        captured.append(([convert.clone(t) for t in (state, planes, arena)],
                         args, kwargs))
        return merge_pass(state, planes, arena, *args, **kwargs)

    fr = frontier.DeviceFrontier(LANES, device=dev)
    symstep.merge_pass = capture
    try:
        fr.run(*fr.seed(stress_seed(branches, body)))
    finally:
        symstep.merge_pass = merge_pass
    check_tables(fr, tables, f"merge_kernel {name}")
    return captured


def merge_grids(trees, tables) -> dict:
    """Blocks of each K10 launch of a pass over these lanes (up to 1024)."""
    lanes = trees[0].pc.shape[0]
    return {"merge_hash_kernel": lanes, "merge_pair_kernel": 1,
            "merge_check_kernel": lanes // 2, "merge_alloc_seg_kernel": 1,
            "merge_nodes_kernel": lanes // 2, "merge_apply_kernel": lanes // 2,
            "merge_blocked_kernel": lanes // 2}


def merge_times(trees, tables, n_rounds) -> dict:
    """One pass's event time, device time and launches by kernel, and its
    standalone K3 calls, from `trees` copied into the same tensors before
    each call."""
    work = [convert.clone(t) for t in trees]

    def fresh():
        refill(work, trees)

    def run(_):
        return ops.merge_pass(*work, *tables, n_rounds)

    def timed(_):
        fresh()
        return run(None)

    times = device_times(timed, 4, counts=True)
    launches = launch_table(times, "merge_", 1, merge_grids(trees, tables))
    ops.reset_launches()
    timed(None)
    standalone = ops.LAUNCHES["arena_alloc"]
    if standalone or ops.LAUNCHES["arena_alloc_merge"] != 1:
        raise AssertionError(f"K10 made standalone K3 calls: {ops.LAUNCHES}")
    return {"ms": event_ms(run, 5, setup=fresh),
            "device_ms": sum(row["device_ms"] for row in launches.values()),
            "launches": sum(row["launches"] for row in launches.values()),
            "by_launch": launches, "standalone_k3_calls": standalone}


def phase_merge_kernel(dev) -> dict:
    """K10 (K3's allocations folded in) vs merge_pass_reference on the
    states a default frontier hands its merge passes."""
    stats = {}
    timed = {}
    for name in MERGE_RUNS:
        captured = captured_merges(dev, name)
        if not captured:
            raise AssertionError(f"{name}: the frontier ran no merge pass")
        totals = None
        for trees, args, kwargs in captured:
            kern = [convert.clone(t) for t in trees]
            plain = [convert.clone(t) for t in trees]
            tables = symstep._merge_tables(*args, dev)
            n_rounds = kwargs["n_rounds"]
            ref = symstep.merge_pass_reference(*plain, *tables,
                                               n_rounds=n_rounds)
            got = ops.merge_pass(*kern, *tables, n_rounds)
            for kind, mine, theirs in zip(("state", "planes", "arena"),
                                          got[:3], ref[:3]):
                assert_same(mine, theirs, f"K10 {name} {kind}")
            check_same([got[3]], [ref[3]], f"K10 {name} stats")
            totals = ref[3] if totals is None else totals + ref[3]
            widened = bool(tables[1].shape[0])
            kind = "widened" if widened else "strict"
            if kind not in timed and (int(ref[3][2]) or not widened):
                timed[kind] = (trees, tables, n_rounds)
        stats[name] = {"passes": len(captured),
                       "stats": totals.cpu().tolist()}
        if not int(totals[0]):
            raise AssertionError(f"{name}: no pair merged")
    if "widened" not in timed:
        raise AssertionError("no merge pass blended memory")

    # K10's time per pass: the first strict pass of branchy(12), the first
    # widened pass that blended memory
    passes = {kind: merge_times(*timed[kind]) for kind in ("strict", "widened")}
    trees, tables, n_rounds = timed["widened"]

    def fresh():
        return [convert.clone(t) for t in trees]

    plain_ms = event_ms(lambda t: symstep.merge_pass_reference(
        *t, *tables, n_rounds=n_rounds), 3, setup=fresh)
    # the library yardstick: torch.argsort(stable=True) on the first
    # round's sort keys, against K10's own bitonic sort
    state, planes, arena = trees
    static_h = symstep._merge_hash(state, planes, symstep.MERGE_WEAK_LEAVES
                                   + symstep.MERGE_MEM_LEAVES)
    cc, _, last, conds_abs, eligible = symstep._merge_keys(state, planes)
    h = symstep._merge_fold(static_h, conds_abs) * symstep._H_PRIME + cc
    keys = torch.where(eligible, ((h & symstep._H_MASK) << 1)
                       | (last > 0).to(torch.int64), symstep._H_SENTINEL)
    library_ms = event_ms(lambda _: torch.argsort(keys, stable=True), 50)
    # each input read once: the lanes' rows of every leaf the pass reads;
    # each output written once: the new arena nodes and consts
    read = sum(leaf[0].numel() * leaf.element_size()
               for leaf in list(state) + list(planes))
    after = ops.merge_pass(*fresh(), *tables, n_rounds)[2]
    new_nodes = int(after.n) - int(arena.n)
    new_consts = int(after.n_const) - int(arena.n_const)
    b_ms, b_by = bound_ms(LANES * read + new_nodes * 7 * 4 + new_consts * 64,
                          0)
    widened = passes["widened"]
    emit({"phase": "merge_kernel", "runs": stats, "n_rounds": n_rounds,
          "max_abs_err": 0, "passes": passes,
          "plain_ms_per_pass": plain_ms, "argsort_ms": library_ms})
    return {"name": "merge_pass", "route": "cuda",
            "source": "mythril_tpu_torch/kernels/merge_pass.cu",
            "replaces": "mythril_tpu/parallel/symstep.py:1057",
            "max_abs_err": 0, "per": "widened pass (mem_branchy(8), 128 lanes)",
            "ms": widened["ms"], "device_ms": widened["device_ms"],
            "strict_ms": passes["strict"]["ms"],
            "strict_device_ms": passes["strict"]["device_ms"],
            "launches_per_pass": {kind: p["launches"]
                                  for kind, p in passes.items()},
            "standalone_k3_calls_per_pass": {
                kind: p["standalone_k3_calls"] for kind, p in passes.items()},
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms,
            "library": "torch.argsort(stable=True) on the first round's keys "
                       "(the pass's sort only)",
            "held_by": "phase merge_kernel"}


def phase_frontier_default(dev, off_timing, off_profiled) -> dict:
    """The default configuration on branchy(12), beside phase frontier's
    telemetry-and-merge-off run of the same contract."""
    fr = frontier.DeviceFrontier(LANES, device=dev)
    timing = drive_frontier(fr, stress_seed(N_BRANCHES))
    totals = default_totals(fr)
    check_totals(totals, EXPECTED_DEFAULT, "frontier_default")
    check_tables(fr, NO_TABLES, "frontier_default")
    replay, profiled = profiled_run(
        lambda: frontier.DeviceFrontier(LANES, device=dev),
        stress_seed(N_BRANCHES))
    check_totals(default_totals(replay), EXPECTED_DEFAULT,
                 "profiled frontier_default")
    checked = checked_run(lambda: frontier.DeviceFrontier(LANES, device=dev),
                          stress_seed(N_BRANCHES), default_totals,
                          EXPECTED_DEFAULT, "frontier_default", NO_TABLES)
    emit({"phase": "frontier_default",
          "contract": f"dispatcher(branchy({N_BRANCHES}))", "lanes": LANES,
          **totals, **timing, "profiled": profiled,
          "summaries_checked": checked,
          "off": {"wall_s": off_timing["wall_s"],
                  "idle_share": off_profiled["idle_share"],
                  "device_busy_ms": off_profiled["device_busy_ms"]},
          "wall_ratio_on_off": timing["wall_s"] / off_timing["wall_s"],
          "k9_by_launch": k9_increments(profiled["k4_functions"],
                                        off_profiled["k4_functions"])})
    return timing, profiled


def phase_frontier_merge(dev) -> dict:
    """The default configuration on mem_branchy(8), on the tables the
    frontier builds for itself: the tag trigger and the widened rounds."""
    tables = mem_branchy_tables()
    fr = frontier.DeviceFrontier(LANES, device=dev)
    timing = drive_frontier(fr, stress_seed(
        0, mem_branchy_contract(MERGE_BRANCHES)))
    totals = default_totals(fr)
    check_totals(totals, EXPECTED_MERGE, "frontier_merge")
    check_tables(fr, tables, "frontier_merge")
    if not (fr.mem_blends and fr.merges):
        raise AssertionError("frontier_merge blended no memory")
    checked = checked_run(
        lambda: frontier.DeviceFrontier(LANES, device=dev),
        stress_seed(0, mem_branchy_contract(MERGE_BRANCHES)), default_totals,
        EXPECTED_MERGE, "frontier_merge", tables)
    emit({"phase": "frontier_merge",
          "contract": f"dispatcher(mem_branchy({MERGE_BRANCHES}))",
          "lanes": LANES, "tables": table_counts(fr.tables()),
          **totals, "tag_merges": fr.tag_merges, "ite_depth": fr.ite_depth,
          **timing, "summaries_checked": checked})
    return timing


# ---- phases 14-15: the chunk graph and 2048 lanes ---------------------------------

def phase_graph_chunk(dev) -> dict:
    """`run_chunk`'s CUDA graph against eager `sym_step` calls from the
    same state at the default geometry, branchy(12): telemetry and merging
    off, on (a merge pass between chunks, in place), and on with 4 shards
    (a seed in each block); every leaf, the arena and the scheduler after
    each chunk. After the first chunk the graphed side's tensors are
    rebound to copies, which must recapture."""
    code = assemble(dispatcher({"stress()": branchy_contract(N_BRANCHES)}))
    empty = symstep._merge_tables(np.zeros(0, np.int32), None, None, dev)
    cases = {}
    for name, armed, n_shards in (("off", False, 1), ("on", True, 1),
                                  ("d4", True, SHARDS)):
        placed = {lane: code for lane in range(0, LANES, LANES // n_shards)}
        tel = symstep.new_telemetry(TEL_TAG_PCS, device=dev) if armed else None
        graphed = sharded_tree(dev, placed, telemetry=tel, n_shards=n_shards)
        eager = [convert.clone(t) for t in graphed]
        ops.reset_launches()
        ops._GRAPHS.clear()  # every case captures its own
        for chunk in range(3):
            graphed = list(symstep.run_chunk(*graphed, CHUNK))
            eager = list(symstep.run_chunk(*eager, CHUNK, graph=False))
            for kind, got, ref in zip(("state", "planes", "arena", "sched"),
                                      graphed, eager):
                assert_same(got, ref, f"graph_chunk {name} chunk {chunk} {kind}")
            for tree in (graphed, eager):
                frontier.reset_esc(tree[3])
                if armed:
                    symstep.merge_pass(*tree[:3], *empty, n_rounds=frontier.MERGE_ROUNDS)
            if chunk == 0:
                graphed = [convert.clone(t) for t in graphed]
        replays = {kind: ops.REPLAYS[kind] for kind in ("run_chunk", "captures")}
        if replays != {"run_chunk": 3, "captures": 2}:
            raise AssertionError(f"graph_chunk {name}: {dict(ops.REPLAYS)}")
        cases[name] = {"forks": int(eager[3].forks),
                       "pushes": int(eager[3].pushes),
                       "executed": int(eager[3].executed), **replays}
    emit({"phase": "graph_chunk", "contract": f"dispatcher(branchy({N_BRANCHES}))",
          "lanes": LANES, "chunk": CHUNK, "chunks": 3, "cases": cases,
          "max_abs_err": 0})
    return cases


#: phase wide_lanes: a branchy(12) seed every 8 lanes, pools of two rows
#: a lane
WIDE_STACK_ROWS = 2 * WIDE_LANES
WIDE_ESC_ROWS = 2 * WIDE_LANES


def wide_tree(dev, n_shards: int):
    """[state, planes, arena, sched] at 2048 lanes and the default row
    geometry: a branchy(12) seed on every 8th lane, the rest DEAD."""
    code = assemble(dispatcher({"stress()": branchy_contract(N_BRANCHES)}))
    state = B.build_batch([B.LaneSpec(code=code, gas_limit=10_000_000)]
                          * WIDE_LANES, device=dev)
    planes = symstep.SymPlanes.empty(WIDE_LANES, state.stack.shape[1],
                                     state.memory.shape[1],
                                     state.storage_keys.shape[1], MAX_CONDS,
                                     device=dev)
    seeds = torch.arange(0, WIDE_LANES, 8, device=dev)
    state.status.fill_(B.DEAD)
    state.status[seeds] = B.RUNNING
    planes.ctx_id[seeds] = torch.arange(len(seeds), dtype=torch.int32,
                                        device=dev)
    sched = symstep.new_scheduler(state, planes, WIDE_STACK_ROWS,
                                  WIDE_ESC_ROWS, n_shards=n_shards)
    return [state, planes, A.new_arena(device=dev), sched]


def phase_wide_lanes(dev) -> dict:
    """K4 (K3 folded in) and K10 at 2048 lanes against their twins on the
    card: one graphed chunk from 256 branchy(12) seeds at D = 1 and D = 2,
    every leaf; then one merge pass (strict rounds, the sort above 1024
    lanes) on the D = 1 chunk's state. K4's device time per step there."""
    record = {}
    end = None
    for n_shards in (1, 2):
        tree = wide_tree(dev, n_shards)
        plain = [convert.clone(t) for t in tree]
        tree = list(symstep.run_chunk(*tree, CHUNK))
        plain = list(symstep.run_chunk_reference(*plain, CHUNK))
        for kind, got, ref in zip(("state", "planes", "arena", "sched"),
                                  tree, plain):
            assert_same(got, ref, f"wide_lanes d{n_shards} {kind}")
        record[f"d{n_shards}"] = {"forks": int(plain[3].forks),
                                  "pushes": int(plain[3].pushes),
                                  "escapes": int(plain[3].esc_count.sum()),
                                  "executed": int(plain[3].executed)}
        if n_shards == 1:
            end = tree
    if not record["d1"]["pushes"]:
        raise AssertionError(f"wide_lanes pushed nothing: {record}")
    tables = symstep._merge_tables(np.zeros(0, np.int32), None, None, dev)
    kern = [convert.clone(t) for t in end[:3]]
    plain = [convert.clone(t) for t in end[:3]]
    got = ops.merge_pass(*kern, *tables, frontier.MERGE_ROUNDS)
    ref = symstep.merge_pass_reference(*plain, *tables, n_rounds=frontier.MERGE_ROUNDS)
    for kind, mine, theirs in zip(("state", "planes", "arena"), got[:3],
                                  ref[:3]):
        assert_same(mine, theirs, f"wide_lanes merge {kind}")
    check_same([got[3]], [ref[3]], "wide_lanes merge stats")
    step = [convert.clone(t) for t in end]
    frontier.reset_esc_reference(step[3])
    k4_ms = device_ms(lambda _: ops.sym_step(*step), 16, K4_KERNELS)
    emit({"phase": "wide_lanes", "lanes": WIDE_LANES, "chunk": CHUNK,
          "seeds": WIDE_LANES // 8, "stack_rows": WIDE_STACK_ROWS,
          "esc_rows": WIDE_ESC_ROWS, **record,
          "merge_stats": ref[3].cpu().tolist(),
          "k4_device_ms_per_step": k4_ms, "max_abs_err": 0})
    return record


def phase_frontier_wide(dev) -> tuple:
    """DeviceFrontier(2048) in the default configuration on branchy(12)
    until the tree drains, held to the JAX `_Frontier(n_lanes=2048)`'s
    counters, digests and telemetry words; its wall and lane-steps/s. As in
    phase frontier, a cold run first takes the process's one-time costs at
    this width."""
    cold = frontier.DeviceFrontier(WIDE_LANES, device=dev)
    cold_wall = drive_frontier(cold, stress_seed(N_BRANCHES))["wall_s"]
    check_totals(default_totals(cold), EXPECTED_WIDE, "cold frontier_wide")
    fr = frontier.DeviceFrontier(WIDE_LANES, device=dev)
    timing = drive_frontier(fr, stress_seed(N_BRANCHES))
    totals = default_totals(fr)
    check_totals(totals, EXPECTED_WIDE, "frontier_wide")
    replays = dict(ops.REPLAYS)
    replay, profiled = profiled_run(
        lambda: frontier.DeviceFrontier(WIDE_LANES, device=dev),
        stress_seed(N_BRANCHES))
    check_totals(default_totals(replay), EXPECTED_WIDE, "profiled frontier_wide")
    checked = checked_run(
        lambda: frontier.DeviceFrontier(WIDE_LANES, device=dev),
        stress_seed(N_BRANCHES), default_totals, EXPECTED_WIDE, "frontier_wide")
    # the same drive with telemetry and merging off (no merge pass runs at
    # this width): K9 by launch, the graphed TEL functions against these
    off, off_profiled = profiled_run(
        lambda: frontier.DeviceFrontier(WIDE_LANES, device=dev, **OFF),
        stress_seed(N_BRANCHES))
    if off.lane_steps != fr.lane_steps:
        raise AssertionError(f"frontier_wide off walked {off.lane_steps} "
                             f"lane-steps, on {fr.lane_steps}")
    k9 = k9_increments(profiled["k4_functions"], off_profiled["k4_functions"])
    emit({"phase": "frontier_wide",
          "contract": f"dispatcher(branchy({N_BRANCHES}))",
          "lanes": WIDE_LANES, "chunk": fr.chunk, "drain_batch": fr.drain_batch,
          **totals, **timing, "cold_wall_s": cold_wall, "replays": replays,
          "profiled": profiled, "summaries_checked": checked,
          "off_profiled": {key: off_profiled[key] for key in (
              "wall_ms", "device_busy_ms", "idle_share", "k4_functions")},
          "k9_by_launch": k9})
    return timing, k9


# ---- phases 14-16: the sharded frontier (K4/K5 segmented, K12) -----------------------

SHARD_STACK_ROWS = STACK_ROWS   # 768 rows a segment
SHARD_ESC_ROWS = ESC_ROWS       # 256 rows a segment
#: steal width of the full-width frontier: min(P / D, max(16, B / D))
STEAL_MAX_ROWS = min(SHARD_STACK_ROWS // SHARDS, max(16, LANES // SHARDS))


def sharded_tree(dev, placed, base_sym=(), telemetry=None, n_shards=SHARDS):
    """[state, planes, arena, sched] at the default geometry with
    `placed` = {lane: code} RUNNING (ctx_id in order), the rest DEAD, and
    a scheduler of 3072 stack and 1024 escape rows in `n_shards` shards."""
    specs = [B.LaneSpec(code=b"\x00")] * LANES
    for lane, code in placed.items():
        specs[lane] = B.LaneSpec(code=code, gas_limit=10_000_000)
    state = B.build_batch(specs, device=dev)
    planes = symstep.SymPlanes.empty(LANES, state.stack.shape[1],
                                     state.memory.shape[1],
                                     state.storage_keys.shape[1], MAX_CONDS,
                                     device=dev)
    state.status.fill_(B.DEAD)
    for index, lane in enumerate(placed):
        state.status[lane] = B.RUNNING
        planes.ctx_id[lane] = index
    for lane in base_sym:
        planes.storage_base_sym[lane] = True
    sched = symstep.new_scheduler(state, planes, SHARD_STACK_ROWS,
                                  SHARD_ESC_ROWS, telemetry=telemetry,
                                  n_shards=n_shards)
    return [state, planes, A.new_arena(device=dev), sched]


def phase_shard_step(dev) -> dict:
    """K4 and K5 with 4 shards (vector tops, segment-local ranks) vs the
    twins: the planes contracts and branchy(12), one per lane block,
    telemetry armed, 2 chunks, every leaf and the summary with its shard
    block compared."""
    placed = {0: assemble(dispatcher({"planes()": PLANES_SOURCE})),
              32: assemble(dispatcher(KILLBILLY)),
              64: assemble(dispatcher({"stress()": branchy_contract(3)})),
              96: assemble(dispatcher({"stress()": branchy_contract(
                  N_BRANCHES)}))}
    tree = sharded_tree(dev, placed, base_sym=[32],
                        telemetry=symstep.new_telemetry(
                            TEL_TAG_PCS, [0, 1, 0, 1], 2, device=dev))
    plain = [convert.clone(t) for t in tree]
    escapes = 0
    for chunk in range(2):
        tree = list(symstep.run_chunk(*tree, CHUNK))
        plain = list(symstep.run_chunk_reference(*plain, CHUNK))
        for kind, got, ref in zip(("state", "planes", "arena", "sched"),
                                  tree, plain):
            assert_same(got, ref, f"shard_step chunk {chunk} {kind}")
        check_same([frontier.summary(*tree)],
                   [frontier.summary_reference(*plain)], "K5 shard block")
        escapes += int(tree[3].esc_count.sum())
        frontier.reset_esc(tree[3])
        frontier.reset_esc_reference(plain[3])
    tops = tree[3].stack_top.tolist()
    if not (escapes and int(tree[3].pushes) and max(tops) > 0
            and min(tops) == 0):
        raise AssertionError(f"shard_step missed a path: tops {tops}, "
                             f"{escapes} escapes")

    # K4's device time per step, one chunk from the same seeds with one
    # and with four shards (the same work but for the lanes the segments
    # place), and the rows each step moved (reseeds, escapes, forks)
    def k4_chunk(n_shards):
        def chunk(_):
            fresh = sharded_tree(dev, placed, base_sym=[32], n_shards=n_shards)
            for _ in range(CHUNK):
                fresh = list(ops.sym_step(*fresh))
            moved[n_shards] = int(fresh[3].pops) + int(fresh[3].forks) \
                + int(fresh[3].esc_count.sum())
        moved = {}
        ms = device_ms(chunk, 2, K4_KERNELS)
        return ms / CHUNK, moved[n_shards] / CHUNK

    k4_d1, moved_d1 = k4_chunk(1)
    k4_d4, moved_d4 = k4_chunk(SHARDS)
    emit({"phase": "shard_step", "shards": SHARDS,
          "contracts": ["planes()", "KILLBILLY", "branchy(3)",
                        f"branchy({N_BRANCHES})"],
          "chunks": 2, "escapes": escapes, "stack_tops": tops,
          "forks": int(tree[3].forks), "pushes": int(tree[3].pushes),
          "max_abs_err": 0,
          "k4_device_ms_per_step": {"d1": k4_d1, "d4": k4_d4},
          "rows_moved_per_step": {"d1": moved_d1, "d4": moved_d4}})
    return k4_d1, k4_d4


def fill_pool(sched, seed: int) -> None:
    """Every pool leaf of the stack filled with random bytes, so that a
    misplaced or partial row copy shows."""
    gen = torch.Generator(device=sched.stack_top.device)
    gen.manual_seed(seed)
    for leaf in list(sched.stack_state) + list(sched.stack_planes):
        if leaf.dtype == torch.bool:
            leaf.copy_(torch.randint(0, 2, leaf.shape, generator=gen,
                                     device=leaf.device).bool())
        else:
            info = torch.iinfo(leaf.dtype)
            low, high = max(info.min, -(1 << 31)), min(info.max, (1 << 31) - 1)
            leaf.copy_(torch.randint(low, high, leaf.shape, generator=gen,
                                     device=leaf.device, dtype=torch.int64)
                       .to(leaf.dtype))


def steal_case(dev, tops, running, seed: int):
    """(state, sched): 128 lanes at the default geometry, `running[d]` of
    block d's lanes RUNNING, a 4-shard pool of random rows with `tops`."""
    state = B.build_batch([B.LaneSpec(code=b"\x00")] * LANES, device=dev)
    planes = symstep.SymPlanes.empty(LANES, state.stack.shape[1],
                                     state.memory.shape[1],
                                     state.storage_keys.shape[1], MAX_CONDS,
                                     device=dev)
    state.status.fill_(B.DEAD)
    block = LANES // SHARDS
    for d, count in enumerate(running):
        state.status[d * block:d * block + count] = B.RUNNING
    sched = symstep.new_scheduler(state, planes, SHARD_STACK_ROWS,
                                  SHARD_ESC_ROWS, n_shards=SHARDS)
    fill_pool(sched, seed)
    sched.stack_top.copy_(torch.tensor(tops, dtype=torch.int32))
    return state, sched


def captured_steal(dev):
    """(state, sched) the sharded frontier hands its first steal pass
    (chunk 4 of the frontier_shard run), cloned before the pass."""
    captured = []
    steal_pass = frontier.steal_pass

    def capture(state, sched, *args):
        if not captured:
            captured.append((convert.clone(state), convert.clone(sched)))
        return steal_pass(state, sched, *args)

    fr = frontier.DeviceFrontier(LANES, device=dev, n_shards=SHARDS,
                                 max_steps=4 * CHUNK)
    frontier.steal_pass = capture
    try:
        fr.run(*fr.seed(stress_seed(N_BRANCHES)))
    finally:
        frontier.steal_pass = steal_pass
    return captured[0]


#: (tops, RUNNING lanes per block, min_imbalance) of phase steal_kernel
STEAL_CASES = {
    # shards 1 and 3 rich: both pairs move STEAL_MAX_ROWS rows
    "forced": ([0, 700, 0, 500], [0, 32, 0, 0], 8),
    # every gap below the threshold: nothing moves
    "below_threshold": ([3, 5, 4, 6], [0, 0, 0, 0], 8),
    # loads 40, 40, 0, 0: the stable order pairs (2, 1) and (3, 0)
    "tied": ([40, 40, 0, 0], [0, 0, 0, 0], 8),
    # loads 760, 800, 766, 788: half the gaps (20, 11) exceed the
    # receivers' room (8, 2)
    "short_room": ([760, 768, 766, 768], [0, 32, 0, 20], 8),
}


def phase_steal_kernel(dev) -> dict:
    """K12 vs steal_pass_reference at the full geometry, every pool leaf
    and counter; its time beside the twin's, the bound and one
    index_select + index_copy_ per leaf; one pass under the sync check."""
    cases = {name: steal_case(dev, tops, running, seed)
             for seed, (name, (tops, running, _)) in enumerate(
                 STEAL_CASES.items())}
    cases["mid_run"] = captured_steal(dev)
    thresholds = {name: case[2] for name, case in STEAL_CASES.items()}
    thresholds["mid_run"] = frontier.STEAL_MIN_IMBALANCE
    moved, grids = {}, {}
    for name, (state, sched) in cases.items():
        kernel, plain = convert.clone(sched), convert.clone(sched)
        frontier.steal_pass(state, kernel, thresholds[name], STEAL_MAX_ROWS)
        grids[name] = ops.steal_pass_grid()  # as the pass's launches recorded it
        frontier.steal_pass_reference(state, plain, thresholds[name],
                                      STEAL_MAX_ROWS)
        assert_same(kernel, plain, f"K12 {name}")
        moved[name] = int(plain.steal_rows) - int(sched.steal_rows)
    expected = {"forced": 2 * STEAL_MAX_ROWS, "below_threshold": 0,
                "tied": 40, "short_room": 10}
    if any(moved[name] != count for name, count in expected.items()) \
            or not moved["mid_run"]:
        raise AssertionError(f"K12 moved {moved}")
    # the moves run on a (slot, item) grid: several copy items a row slot
    plan_blocks, plan_threads, move_blocks, move_threads = grids["forced"]
    slots = SHARDS // 2 * STEAL_MAX_ROWS
    if plan_blocks != 1 or move_blocks % slots or move_blocks // slots < 2 \
            or len(set(grids.values())) != 1:
        raise AssertionError(f"K12 launched {grids}")

    # no host synchronization in the pass (the sizes stay on the card)
    state, sched = cases["forced"]
    quiet = convert.clone(sched)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        frontier.steal_pass(state, quiet, thresholds["forced"], STEAL_MAX_ROWS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

    # time on the forced case (64 rows moved), each rep from the same pool
    # tensors refilled from the case (outside the timed span), as the drain
    # loop passes the same tensors pass after pass (its plan cached)
    timed = convert.clone(sched)

    def fresh():
        for (_, mine), (_, theirs) in zip(convert.leaves(timed),
                                          convert.leaves(sched)):
            mine.copy_(theirs)
        return timed

    ms = event_ms(lambda t: ops.steal_pass(state, t, 8, STEAL_MAX_ROWS), 20,
                  setup=fresh)
    lookup = lookup_us(ops._STEAL_PLANS, lambda: ops._steal_tensors(state, timed),
                       (STEAL_MAX_ROWS,))
    by_kernel = device_times(lambda _: ops.steal_pass(state, fresh(), 8,
                                                      STEAL_MAX_ROWS), 10)
    dev_split = {name: named_ms(by_kernel, (name,))
                 for name in ("steal_plan_kernel", "steal_move_kernel")}
    dev_ms = sum(dev_split.values())
    plain_ms = event_ms(lambda t: frontier.steal_pass_reference(
        state, t, 8, STEAL_MAX_ROWS), 5, setup=fresh)
    seg_pool = SHARD_STACK_ROWS // SHARDS
    src, dst = [], []
    for poor, rich, n in frontier.steal_plan(state.status, sched.stack_top,
                                             seg_pool, 8, STEAL_MAX_ROWS):
        top_r, top_p = int(sched.stack_top[rich]), int(sched.stack_top[poor])
        src += [rich * seg_pool + top_r - 1 - r for r in range(n)]
        dst += [poor * seg_pool + top_p + r for r in range(n)]
    src_t = torch.tensor(src, dtype=torch.int64, device=dev)
    dst_t = torch.tensor(dst, dtype=torch.int64, device=dev)
    pool = fresh()
    leaves = list(pool.stack_state) + list(pool.stack_planes)

    def library(_):
        for leaf in leaves:
            leaf.index_copy_(0, dst_t, leaf.index_select(0, src_t))

    library_ms = event_ms(library, 20)
    row_bytes = sum(leaf[0].numel() * leaf.element_size() for leaf in leaves)
    nbytes = 2 * len(src) * row_bytes + LANES * 4 + SHARDS * (2 * 4 + 2 * 8) + 8
    b_ms, b_by = bound_ms(nbytes, 0)
    emit({"phase": "steal_kernel", "shards": SHARDS,
          "stack_rows": SHARD_STACK_ROWS, "max_rows": STEAL_MAX_ROWS,
          "row_bytes": row_bytes, "rows_moved": moved, "max_abs_err": 0,
          "grid": {"plan": [plan_blocks, plan_threads],
                   "move": [move_blocks, move_threads],
                   "items_per_row": move_blocks // slots},
          "no_host_sync": True, "ms": ms, "device_ms": dev_ms,
          "lookup": lookup,
          "device_ms_by_kernel": dev_split,
          "plain_ms": plain_ms, "library_ms": library_ms,
          "bound_bytes": nbytes})
    return {"name": "steal_pass", "route": "cuda",
            "source": "mythril_tpu_torch/kernels/steal_pass.cu",
            "replaces": "mythril_tpu/parallel/frontier.py:319",
            "max_abs_err": 0, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms,
            "library": "index_select + index_copy_ per leaf (46 pairs)",
            "grid": {"plan": [plan_blocks, plan_threads],
                     "move": [move_blocks, move_threads]},
            "held_by": "phase steal_kernel"}


def phase_frontier_shard(dev, default_timing, default_profiled) -> tuple:
    """DeviceFrontier(128, n_shards=4) in the default configuration on
    branchy(12) from one seed in shard 0, held to the JAX constants; its
    wall, idle share and K4's device time per step beside the unsharded
    default run's; then the two-member fleet."""
    fr = frontier.DeviceFrontier(LANES, device=dev, n_shards=SHARDS)
    timing = drive_frontier(fr, stress_seed(N_BRANCHES))
    totals = shard_totals(fr)
    check_totals(totals, EXPECTED_SHARD, "frontier_shard")
    replay, profiled = profiled_run(
        lambda: frontier.DeviceFrontier(LANES, device=dev, n_shards=SHARDS),
        stress_seed(N_BRANCHES))
    check_totals(shard_totals(replay), EXPECTED_SHARD,
                 "profiled frontier_shard")
    checked = checked_run(
        lambda: frontier.DeviceFrontier(LANES, device=dev, n_shards=SHARDS),
        stress_seed(N_BRANCHES), shard_totals, EXPECTED_SHARD, "frontier_shard")

    def k4_step_ms(run_timing, run_profiled):
        return run_profiled["kernel_device_ms"]["sym_step"] \
            / run_timing["launches"]["sym_step"]

    emit({"phase": "frontier_shard",
          "contract": f"dispatcher(branchy({N_BRANCHES}))", "lanes": LANES,
          "shards": SHARDS, "steal_cadence": fr.steal_cadence,
          "steal_min_imbalance": fr.steal_min_imbalance,
          "steal_max_rows": STEAL_MAX_ROWS, **totals, **timing,
          "profiled": profiled, "shard_tops": fr.shard_tops.tolist(),
          "shard_fairness": fr.shard_fairness,
          "shard_imbalance": fr.shard_imbalance,
          "k12_launches": timing["launches"]["steal_pass"],
          "k4_device_ms_per_step": {
              "d4": k4_step_ms(timing, profiled),
              "d1_frontier_default": k4_step_ms(default_timing,
                                                default_profiled)},
          "unsharded": {"wall_s": default_timing["wall_s"],
                        "idle_share": default_profiled["idle_share"]},
          "summaries_checked": checked})

    names = list(FLEET_RUN)

    def make_fleet():
        return frontier.DeviceFrontier(LANES, device=dev, n_shards=SHARDS,
                                       seed_owner_index=FLEET_OWNERS,
                                       fleet_slots=list(range(len(names))),
                                       fleet_names=names)

    fleet = make_fleet()
    seeds = [seed for body in FLEET_RUN.values()
             for seed in stress_seed(0, body)]
    fleet_timing = drive_frontier(fleet, seeds)
    fleet_totals = shard_totals(fleet)
    check_totals(fleet_totals, EXPECTED_FLEET, "frontier_shard fleet")
    check_tables(fleet, fleet_tables(), "frontier_shard fleet")
    if not (fleet.mem_blends and fleet.steal_rows):
        raise AssertionError("the fleet run blended no memory or stole "
                             "no rows")
    fleet_checked = checked_run(make_fleet, seeds, shard_totals, EXPECTED_FLEET,
                                "frontier_shard fleet", fleet_tables())
    emit({"phase": "frontier_shard_fleet", "members": names,
          "owners": FLEET_OWNERS, "lanes": LANES, "shards": SHARDS,
          **fleet_totals,
          "fleet_occupancy": dict(zip(names, fleet.fleet_occupancy.tolist())),
          **fleet_timing, "summaries_checked": fleet_checked})
    return timing, profiled, fleet_timing


# ---- phases 17-19: the device SAT lane (K11) --------------------------------------

#: captured analysis queries (tests/data/smt2_corpus.tar.gz) the lane runs
#: at full width: two of the 64-tile bucket, two of the 256-tile one (V1 =
#: 65,536 for all; 32 probes)
SAT_CORPUS = "tests/data/smt2_corpus.tar.gz"
SAT_LANE_QUERIES = ("1689-24.smt2", "1540-2.smt2", "1689-28.smt2",
                    "1674-23.smt2")
#: the query the JAX lane decides in a few chunks: held to its verdict,
#: chunk count and model too
SAT_FULL_QUERY = "1689-24.smt2"
#: one dispatch flush: four queries of the 64-tile bucket, solved as one
#: batch at a short chunk
SAT_BATCH_QUERIES = ("1689-24.smt2", "1540-2.smt2", "1536-1.smt2",
                     "1689-10.smt2")
SAT_BATCH_CHUNK = 32
#: the queries above whose CNF came out the same in every process we ran
#: (24 with random hash seeds). The JAX pipeline, and the port's copy of
#: it, orders commutative operands by a hash of their children's ids
#: (terms.py), so most captured queries, the 256-tile ones among them,
#: blast to a CNF that depends on the process: those are held to their
#: sizes, the CDCL verdict and the twin on the card instead of a digest
#: (`tests/_torch_sat_constants.py stability` lists the stable ones)
STABLE_CNFS = frozenset({"1689-24.smt2", "1540-2.smt2", "1536-1.smt2",
                         "1689-10.smt2"})

#: the JAX lane's numbers for these queries, printed by
#: tests/_torch_sat_constants.py (mythril_tpu's from_smt2 ->
#: lower_constraints -> Blaster, the native CDCL core, then
#: jax_solver.solve_cnf_device with its defaults on the CPU): clause and
#: variable counts, the tile bucket, the CDCL verdict (1 SAT, 0 UNSAT); for
#: a stable CNF its sha256 (`cnf_digest`) and, on the lane, the state after
#: the first two chunks (`state_digest`); for SAT_FULL_QUERY the JAX lane's
#: verdict, chunk count and model (`model_digest`)
EXPECTED_SAT = {
    "1689-24.smt2": {
        "clauses": 57463, "n_vars": 16468, "tiles": 64, "cdcl": 1,
        "cnf": "5a0d28076df926aa5eb38cdf22bad05c1a2251da12cf66112b70460b2865d3db",
        "chunks": ["0d6f97568a404a705374e28733fb44c6d00c2fd5adc7f84ecd3cd5227da54bc5",
                   "e8a18ed68055cb63ee8552eaef0061fa74a453aa118413d206736707fec2a996"],
        "jax": {"status": 1, "chunks": 10,
                "model": "8172ea319f6368a8cc9a470ba86ca61b70fc73a21d12106a0d03bfd635ffe983"}},
    "1540-2.smt2": {
        "clauses": 58488, "n_vars": 16980, "tiles": 64, "cdcl": 1,
        "cnf": "36aecd682216cbfaa0515fc67e41e169adaa4112f26ac31eeda9dffb632a5a24",
        "chunks": ["eb76ebde3f35370980b253640a1d7b29c9d146e26a97e0eaf9c94d93b14a71d7",
                   "1e5af8eafb8c8a4c4efafebbed505e078639491af5265e08e08d9a9a0813307d"]},
    "1689-28.smt2": {
        "clauses": 143559, "n_vars": 42114, "tiles": 256, "cdcl": 1},
    "1674-23.smt2": {
        "clauses": 134237, "n_vars": 39288, "tiles": 256, "cdcl": 0},
    "1536-1.smt2": {
        "clauses": 63601, "n_vars": 17946, "tiles": 64, "cdcl": 1,
        "cnf": "3d15f7436559b31318af61f8a28668c28594d47ee357dfc33d5c0fd8b26cc3c8"},
    "1689-10.smt2": {
        "clauses": 58488, "n_vars": 16980, "tiles": 64, "cdcl": 1,
        "cnf": "f3dde26bfc2a494a6a2160a721e5e84d9bf9694d4f0d99d638d5a20ffa996907"},
}
#: the JAX batch runner's state after the first chunk of SAT_BATCH_QUERIES
#: (jax_solver.solve_cnf_device_batch, chunk SAT_BATCH_CHUNK)
EXPECTED_SAT_BATCH = \
    "5118d7baf4d0e1f264d333ecb4e6b5b975196d9ae37051337f9013580e71b13f"


def sha256_of(*arrays) -> str:
    sha = hashlib.sha256()
    for array in arrays:
        sha.update(np.ascontiguousarray(array).tobytes())
    return sha.hexdigest()


def cnf_digest(clauses, n_vars: int) -> str:
    """sha256 of int32 LE [n_vars, n_clauses, clause 0's literals, 0, ...]."""
    flat = [n_vars, len(clauses)]
    for clause in clauses:
        flat.extend(clause)
        flat.append(0)
    return sha256_of(np.asarray(flat, dtype="<i4"))


def state_digest(leaves) -> str:
    """sha256 of a SolverState's five leaves (assign, trail, tag,
    trail_len, status), C order, as numpy arrays or tensors."""
    return sha256_of(*[leaf.cpu().numpy() if isinstance(leaf, torch.Tensor)
                       else leaf for leaf in leaves])


def model_digest(model) -> str:
    return sha256_of(np.asarray(model, dtype=np.uint8))


def corpus_query(name: str):
    """(clauses, n_vars, lowered constraints, blaster) of one captured
    query through the port's from_smt2 -> lower_constraints -> Blaster."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        SAT_CORPUS)
    # fresh names from 0, as if the query were the first of its process
    preprocess._fresh_counter = itertools.count()
    with tarfile.open(path) as tar:
        text = tar.extractfile(name).read().decode("utf-8")
    lowered, _ = preprocess.lower_constraints(list(from_smt2(text)))
    blaster = Blaster()
    for node in lowered:
        blaster.assert_true(node)
    return blaster.clauses, blaster.n_vars, lowered, blaster


def check_model(clauses, lowered, blaster, model, what: str) -> None:
    """A SAT model holds every clause and every lowered constraint."""
    values = np.concatenate([[False], np.asarray(model, dtype=bool)])
    lits = np.zeros((len(clauses), 3), dtype=np.int64)
    for i, clause in enumerate(clauses):
        lits[i, :len(clause)] = clause
    hit = np.where(lits > 0, values[np.abs(lits)], ~values[np.abs(lits)])
    if not (hit & (lits != 0)).any(axis=1).all():
        raise AssertionError(f"{what}: the model falsifies a clause")

    def bit(lit):
        return bool(values[abs(lit)]) != (lit < 0)

    assignment = {var: bit(lit) for var, lit in blaster.var_lits.items()}
    for var, bits in blaster.var_bits.items():
        assignment[var] = sum(int(bit(lit)) << i for i, lit in enumerate(bits))
    for node in lowered:
        if terms.evaluate(node, assignment) is not True:
            raise AssertionError(f"{what}: the model falsifies a constraint")


#: the K11 fixtures: opposite-phase races inside one tile and across two
#: (the higher clause index lands), the no-flip backtrack, 32 probes on a
#: 3-SAT instance deep enough for their forced prefixes, implications and
#: a backtrack spread over the whole variable range; pad variables in
#: all. (name, clauses, n_vars, probes)
def sat_fixtures() -> list:
    return [("race_tile", [[-1, 2], [-1, -2], [3, 4]], 4, 2),
            ("race_tiles", [[-1, -2]] * 2100 + [[-1, 2]], 2, 2),
            ("no_flip", [[1, 2], [1, -2], [-1, 3], [-1, -3]], 3, 2),
            ("prefix32", three_sat(9), 60, 32),
            ("spread", spread_cnf(), 900, 2)]


def spread_cnf() -> list:
    """Var 1 is decided first (in the forced prefix), var 2 next (FALSE,
    flippable); that implies vars 3..402 at once, they imply 403..802, a
    phase race on 802 and then a conflict follow, and the backtrack to var
    2 clears 800 trail entries: appends and clears across every tile of a
    small variable tile."""
    spread = range(3, 403)
    return ([[1, s, s + 400] for s in spread] + [[1, 803, 804]]
            + [[2, s] for s in spread] + [[-s, s + 400] for s in spread]
            + [[-402, -802]])


def three_sat(seed: int, n_vars: int = 60, n_clauses: int = 250) -> list:
    """Random 3-SAT without unit clauses: deep enough to search."""
    rng = random.Random(seed)
    return [[rng.choice([-1, 1]) * v
             for v in rng.sample(range(1, n_vars + 1), 3)]
            for _ in range(n_clauses)]


def sat_batch_fixture() -> list:
    """A bucket of 4 queries for the batch runner; the second decides in
    its first steps, so the freeze holds it while the others step."""
    return [(three_sat(10), 60), ([[1, 2], [-1, 2], [-2, 3], [-3]], 3),
            (three_sat(11), 60), (three_sat(12), 60)]


def sat_compare(state, tensors, chunk, n_chunks, n_probes, freeze, what,
                graphs=(True, False), var_tile=ops.SAT_VAR_TILE):
    """K11 against run_chunk_reference from one state, every leaf after
    each chunk, once for each of `graphs` (the chunk's CUDA graph, eager
    launches); returns the kernel's final state."""
    depth = device_solver.forced_depth_of(n_probes)
    plain = convert.clone(state)
    kerns = [convert.clone(state) for _ in graphs]
    for index in range(n_chunks):
        device_solver.run_chunk_reference(plain, tensors, chunk, depth, freeze)
        for kern, graph in zip(kerns, graphs):
            ops.sat_run(kern, tensors, chunk, depth, freeze, graph, var_tile)
            mode = "graphed" if graph else "eager"
            assert_same(kern, plain, f"K11 {what} {mode} chunk {index}")
    return kerns[0]


def sat_step_bytes(before, after, tensors) -> int:
    """The least bytes one step of one query moved, from the state before
    and after it: `valid` read once and the literals of each real clause;
    every probe's status, and each searching probe's assignment row, its
    tags inside the trail and its trail length; `order` at the free vars of
    the probes that decided; the trail entries a backtrack read; each leaf
    element the step changed, written once."""
    searching = before.status == device_solver.SEARCHING
    v1 = before.assign.shape[-1]
    length, new_length = before.trail_len.long(), after.trail_len.long()
    # a decision appends one entry tagged 1 or 2; a backtrack shortens the
    # trail, or keeps its length with a flip at its end, or refutes the cube
    appended = after.tag.gather(-1, length.clamp(max=v1 - 1)[..., None])[..., 0]
    decided = searching & (new_length == length + 1) & (appended >= 1)
    refuted = searching & (after.status == device_solver.S_UNSAT)
    flipped = searching & (after.status == device_solver.SEARCHING) \
        & (new_length <= length)
    free = (before.assign == 0) & decided[..., None]  # unassigned
    trail_read = (torch.where(refuted, length, 0)
                  + torch.where(flipped, length - new_length + 1, 0))
    reads = (tensors.valid.numel() + 12 * int(tensors.valid.sum())
             + before.status.numel()
             + int(searching.sum()) * (v1 + 4)
             + int(torch.where(searching, length, 0).sum())
             + 4 * int(free.any(dim=-2).sum()) + 4 * int(trail_read.sum()))
    writes = sum(int((old != new).sum()) * old.element_size()
                 for old, new in zip(before, after))
    return reads + writes


def sat_bound_ms_per_step(state, tensors, steps: int, depth: int) -> tuple:
    """bound_ms of one step, averaged over the `steps` steps from `state`
    (stepped by the twin on a copy)."""
    total = 0
    before = convert.clone(state)
    for _ in range(steps):
        after = device_solver.run_chunk_reference(convert.clone(before),
                                                  tensors, 1, depth)
        total += sat_step_bytes(before, after, tensors)
        before = after
    return bound_ms(total / steps, 0)


#: K11's variable tile in the fixtures' second pass: V1 1,024 over 16 blocks
SAT_SMALL_TILE = 64


def phase_sat_kernel(dev) -> dict:
    """K11, graphed and eager, vs its twin on the fixtures (at the card's
    variable tile and at a small one) and at full width on a query of each
    bucket; its time per step there, by launch."""
    for var_tile in (ops.SAT_VAR_TILE, SAT_SMALL_TILE):
        for name, clauses, n_vars, n_probes in sat_fixtures():
            problem = device_solver.build_problem(clauses, n_vars)
            tensors = device_solver.device_problem(problem, dev)
            state = device_solver.initial_state(problem.init_assign, n_probes,
                                                dev)
            sat_compare(state, tensors, 2, 6, n_probes, False, name,
                        var_tile=var_tile)
        problems = [device_solver.build_problem(c, n)
                    for c, n in sat_batch_fixture()]
        tensors = device_solver.device_problem(problems, dev)
        state = device_solver.initial_state(
            np.stack([p.init_assign for p in problems]), 8, dev)
        sat_compare(state, tensors, 4, 5, 8, True, "batch", var_tile=var_tile)

    # full width, both buckets: 64 compared steps, graphed and eager, then
    # the time per step
    depth = device_solver.forced_depth_of(32)
    steps = 64
    timings = {}
    for name in ("1689-24.smt2", "1689-28.smt2"):
        clauses, n_vars, _, _ = corpus_query(name)
        problem = device_solver.build_problem(clauses, n_vars)
        tensors = device_solver.device_problem(problem, dev)
        state = device_solver.initial_state(problem.init_assign, 32, dev)
        state = sat_compare(state, tensors, 32, 2, 32, False, name)
        v1 = problem.order.shape[0]
        n_clauses = problem.valid.size
        tiles = 32 * -(-v1 // ops.SAT_VAR_TILE)
        # propagate: a thread per clause and group of four probes
        grids = {"sat_mirror_kernel": -(-v1 * 32 // 256),
                 "sat_propagate_kernel": -(-n_clauses * 8 // 256),
                 "sat_count_kernel": tiles, "sat_apply_kernel": tiles}
        if tiles < 132:
            raise AssertionError(f"{name}: resolve launches {tiles} blocks")
        work = convert.clone(state)

        def fresh(graph=True):
            refill([work], [state])
            return graph

        def run(graph):
            return ops.sat_run(work, tensors, steps, depth, False, graph)

        b_ms, b_by = sat_bound_ms_per_step(state, tensors, steps, depth)
        times = device_times(lambda _: run(fresh()), 2, counts=True)
        launches = launch_table(times, "sat_", steps, grids)
        ops.reset_launches()
        timings[name] = {
            "tiles": problem.lits.shape[0], "v1": v1,
            "ms_per_step": event_ms(run, 3, setup=fresh) / steps,
            "eager_ms_per_step": event_ms(
                run, 3, setup=lambda: fresh(False)) / steps,
            "device_ms_per_step": sum(
                row["device_ms"] for row in launches.values()),
            "launches_per_step": launches,
            "replays": dict(ops.REPLAYS),
            "plain_ms_per_step": event_ms(
                lambda s: device_solver.run_chunk_reference(
                    s, tensors, 4, depth), 2,
                setup=lambda: convert.clone(state)) / 4,
            "bound_ms_per_step": b_ms, "bound_by": b_by}
    emit({"phase": "sat_kernel",
          "fixtures": [f[0] for f in sat_fixtures()] + ["batch"],
          "var_tiles": [ops.SAT_VAR_TILE, SAT_SMALL_TILE],
          "probes": 32, "compared_steps": 64, "compared": "graphed, eager",
          "max_abs_err": 0, "full_width": timings})
    main = timings["1689-24.smt2"]
    return {"name": "sat_step", "route": "cuda",
            "source": "mythril_tpu_torch/kernels/sat_step.cu",
            "replaces": "mythril_tpu/parallel/jax_solver.py:247",
            "max_abs_err": 0, "per": "step (32 probes, 64 tiles, V1 65536)",
            "ms": main["ms_per_step"], "device_ms": main["device_ms_per_step"],
            "plain_ms": main["plain_ms_per_step"],
            "bound_ms": main["bound_ms_per_step"], "bound_by": main["bound_by"],
            "library_ms": None,
            "library": "none: no PyTorch call computes a DPLL step",
            "held_by": "phase sat_kernel"}


def sat_solve(solve, *args, **kwargs) -> dict:
    """One entry-point call with the launch counts zeroed just before and
    read just after, each chunk's stream time (CUDA events around
    run_chunk) and a device copy of the state after each of the first two
    chunks."""
    events, states = [], []
    run_chunk = device_solver.run_chunk

    def timed_chunk(state, *chunk_args, **chunk_kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run_chunk(state, *chunk_args, **chunk_kwargs)
        end.record()
        events.append((start, end))
        if len(states) < 2:
            states.append(convert.clone(state))
        return out

    torch.cuda.synchronize()
    device_solver.run_chunk = timed_chunk
    ops.reset_launches()
    start = time.perf_counter()
    try:
        result = solve(*args, **kwargs)
        torch.cuda.synchronize()
    finally:
        device_solver.run_chunk = run_chunk
    wall = time.perf_counter() - start
    stream_ms = sum(s.elapsed_time(e) for s, e in events)
    chunks = max(len(events), 1)
    return {"result": result, "launches": dict(ops.LAUNCHES),
            "replays": dict(ops.REPLAYS),
            "states": states, "chunks": len(events),
            "steps": len(events) * kwargs.get("chunk", 256),
            "wall_s": wall, "chunk_stream_ms": stream_ms / chunks,
            "host_ms_per_chunk": (wall * 1e3 - stream_ms) / chunks}


def sat_verdict(name, status, model, clauses, lowered, blaster) -> str:
    if status == device_solver.SAT:
        check_model(clauses, lowered, blaster, model, name)
    if status != device_solver.UNKNOWN and status != EXPECTED_SAT[name]["cdcl"]:
        raise AssertionError(f"{name}: verdict {status}, CDCL says "
                             f"{EXPECTED_SAT[name]['cdcl']}")
    return {device_solver.SAT: "sat", device_solver.UNSAT: "unsat",
            device_solver.UNKNOWN: "unknown"}[status]


def check_cnf(name, clauses, n_vars) -> None:
    want = EXPECTED_SAT[name]
    if (len(clauses), n_vars) != (want["clauses"], want["n_vars"]) \
            or ("cnf" in want and cnf_digest(clauses, n_vars) != want["cnf"]):
        raise AssertionError(f"{name}: the CNF differs from the JAX one")


def phase_sat_lane(dev) -> tuple:
    """The slice at full width: captured queries through the port's CNF
    pipeline and `solve_cnf_device` with its defaults."""
    launches = {name: 0 for name in ops.LAUNCHES}
    runs = {}
    for name in SAT_LANE_QUERIES:
        start = time.perf_counter()
        clauses, n_vars, lowered, blaster = corpus_query(name)
        cnf_s = time.perf_counter() - start
        check_cnf(name, clauses, n_vars)
        want = EXPECTED_SAT[name]
        run = sat_solve(device_solver.solve_cnf_device, clauses, n_vars,
                        device=dev)
        status, model = run.pop("result")
        states = run.pop("states")
        if "chunks" in want:
            held = "JAX digests"
            for index, state in enumerate(states):
                if state_digest(state) != want["chunks"][index]:
                    raise AssertionError(f"{name}: state after chunk "
                                         f"{index + 1} differs from the JAX "
                                         f"lane's")
        else:
            # a process-dependent CNF: the same chunks through the twin
            held = "the twin on the card"
            problem = device_solver.build_problem(clauses, n_vars)
            if problem.lits.shape[0] != want["tiles"]:
                raise AssertionError(f"{name}: {problem.lits.shape[0]} tiles")
            tensors = device_solver.device_problem(problem, dev)
            plain = device_solver.initial_state(problem.init_assign, 32, dev)
            for index, state in enumerate(states):
                device_solver.run_chunk_reference(plain, tensors, 256, 5)
                assert_same(state, plain, f"{name} chunk {index + 1}")
        verdict = sat_verdict(name, status, model, clauses, lowered, blaster)
        if "jax" in want:
            jax_run = want["jax"]
            if (status, run["chunks"]) != (jax_run["status"],
                                           jax_run["chunks"]) \
                    or model_digest(model) != jax_run["model"]:
                raise AssertionError(f"{name}: verdict, chunk count or model "
                                     f"differs from the JAX lane's")
        for kernel, count in run.pop("launches").items():
            launches[kernel] += count
        # the solve's host set-up: the bucketed arrays, built in Python
        start = time.perf_counter()
        device_solver.build_problem(clauses, n_vars)
        build_s = time.perf_counter() - start
        runs[name] = {"clauses": len(clauses), "n_vars": n_vars,
                      "tiles": want["tiles"], "verdict": verdict,
                      "chunks_held_to": held, "cnf_s": cnf_s,
                      "build_problem_s": build_s, **run}
    # the device's share of the lane: 1689-24 again under the profiler
    clauses, n_vars, _, _ = corpus_query(SAT_FULL_QUERY)

    def solve(_):
        start = time.perf_counter()
        device_solver.solve_cnf_device(clauses, n_vars, device=dev)
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3

    _, wall_ms, events = profile_cuda(solve, "sat_lane", ops.reset_launches)
    k11_ms = other_ms = 0.0
    for event in events:
        if "sat_" in event.key:
            k11_ms += event.self_device_time_total / 1e3
        else:
            other_ms += event.self_device_time_total / 1e3
    steps = ops.LAUNCHES["sat_step"] * 256
    if k11_ms <= 0 or not steps:
        raise AssertionError("the profiler recorded no device time of K11")
    idle_share = 1.0 - (k11_ms + other_ms) / wall_ms
    if idle_share < 0:
        raise AssertionError(f"the profiled solve's device time exceeds its "
                             f"wall time (idle share {idle_share})")
    profiled = {"query": SAT_FULL_QUERY, "wall_ms": wall_ms, "steps": steps,
                "k11_device_ms": k11_ms, "other_device_ms": other_ms,
                "idle_share": idle_share,
                "k11_device_ms_per_step": k11_ms / steps}
    emit({"phase": "sat_lane", "defaults": {"n_probes": 32, "chunk": 256,
                                            "max_steps": 20_000},
          "queries": runs, "profiled": profiled})
    return launches, profiled


def phase_sat_batch(dev) -> dict:
    """One dispatch flush: four captured queries of one bucket through
    `solve_cnf_device_batch`, held to the JAX batch runner's first chunk."""
    queries, parts = [], []
    for name in SAT_BATCH_QUERIES:
        clauses, n_vars, lowered, blaster = corpus_query(name)
        check_cnf(name, clauses, n_vars)
        queries.append((clauses, n_vars))
        parts.append((clauses, lowered, blaster))
    run = sat_solve(device_solver.solve_cnf_device_batch, queries,
                    chunk=SAT_BATCH_CHUNK, device=dev)
    # the flush's host set-up: the four bucketed arrays, built in Python
    start = time.perf_counter()
    for clauses, n_vars in queries:
        device_solver.build_problem(clauses, n_vars)
    run["build_problem_s"] = time.perf_counter() - start
    results = run.pop("result")
    if state_digest(run.pop("states")[0]) != EXPECTED_SAT_BATCH:
        raise AssertionError("sat_batch: the state after the first chunk "
                             "differs from the JAX batch runner's")
    verdicts = {name: sat_verdict(name, status, model, *part)
                for name, (status, model), part
                in zip(SAT_BATCH_QUERIES, results, parts)}
    launches = run.pop("launches")
    emit({"phase": "sat_batch", "chunk": SAT_BATCH_CHUNK,
          "queries": list(SAT_BATCH_QUERIES), "verdicts": verdicts, **run})
    return launches


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
    phase_static_tables()
    rng = np.random.default_rng(2024)
    keccak_record = phase_keccak(dev, rng)
    step_record, keccak_step = phase_step(dev)
    keccak_record.update(keccak_step)
    records = [keccak_record, step_record, phase_arena(dev, rng)]
    phase_planes(dev)
    records.append(phase_slice(dev))
    records += phase_frontier_programs(dev)
    records.append(phase_telemetry(dev))
    records.append(phase_merge_kernel(dev))
    phase_graph_chunk(dev)
    phase_wide_lanes(dev)
    k4_same_work = phase_shard_step(dev)
    records.append(phase_steal_kernel(dev))
    records.append(phase_sat_kernel(dev))
    # the main path: the drain loop at full width and the spill run with
    # telemetry and merging off, then the default configuration
    launches = {name: 0 for name in ops.LAUNCHES}
    off_timing, off_profiled = phase_frontier(dev)
    main_path_launches = [off_timing["launches"],
                       phase_frontier_spill(dev)["launches"]]
    default_timing, default_profiled = phase_frontier_default(
        dev, off_timing, off_profiled)
    main_path_launches += [default_timing["launches"],
                        phase_frontier_merge(dev)["launches"]]
    # the sharded frontier: 4 logical shards with stealing, then a fleet
    shard_timing, shard_profiled, fleet_timing = phase_frontier_shard(
        dev, default_timing, default_profiled)
    main_path_launches += [shard_timing["launches"], fleet_timing["launches"]]
    # 2048 lanes: past the 1024 that K4 and K10 once scanned in one block
    wide_timing, wide_k9 = phase_frontier_wide(dev)
    main_path_launches.append(wide_timing["launches"])
    # the device SAT lane: captured queries at full width, one flush
    sat_launches, sat_profiled = phase_sat_lane(dev)
    main_path_launches += [sat_launches, phase_sat_batch(dev)]
    for counts in main_path_launches:
        for name, count in counts.items():
            launches[name] += count
    # K3 runs on the main path folded into K4's steps and K10's passes
    # (one count a step and a pass); no standalone call is left there
    folded = launches["arena_alloc_step"] + launches["arena_alloc_merge"]
    idle = sorted(name for name, count in launches.items()
                  if count == 0 and name != "arena_alloc")
    if idle or not folded:
        raise AssertionError(f"kernels the main-path phases never ran: {idle}"
                             f" (K3 folded: {folded})")
    for record in records:
        name = record["name"]
        record["launches"] = launches[name]
        if name == "telemetry":
            # K9 by launch in the graphed drives with the plane armed
            record["k9_by_launch_graphed"] = {
                "frontier_default": {
                    key: value["k9_ms_per_step"] for key, value in
                    k9_increments(default_profiled["k4_functions"],
                                  off_profiled["k4_functions"]).items()},
                "frontier_wide": {key: value["k9_ms_per_step"]
                                  for key, value in wide_k9.items()}}
        if name == "arena_alloc":
            record["launches"] = launches[name] + folded
            record["launches_standalone"] = launches[name]
            record["launches_folded"] = {
                "sym_step": launches["arena_alloc_step"],
                "merge_pass": launches["arena_alloc_merge"]}
        if name == "sat_step":
            # K11's device time per step on the lane's profiled solve
            record["main_path_device_ms"] = \
                sat_profiled["k11_device_ms_per_step"]
            continue
        # device time per wrapper call on the full-width drain loop: the
        # off run's, or the default run's or the sharded run's for what only
        # they launch (K9 runs inside K4's launches and has no device time
        # of its own)
        run_timing, run_profiled = next(
            (run for run in ((off_timing, off_profiled),
                             (default_timing, default_profiled),
                             (shard_timing, shard_profiled))
             if run[0]["launches"][name]), (shard_timing, shard_profiled))
        calls = run_timing["launches"][name]
        record["main_path_device_ms"] = (
            run_profiled["kernel_device_ms"][name] / calls
            if calls and name != "telemetry" else None)
        if name == "sym_step":
            # the sharded run's steps, and one chunk of the same work at
            # D = 1 and D = 4 (phase shard_step)
            record["main_path_device_ms_d4"] = \
                shard_profiled["kernel_device_ms"][name] \
                / shard_timing["launches"][name]
            record["shard_step_device_ms"] = dict(zip(("d1", "d4"),
                                                      k4_same_work))
    print(CARD, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
