"""The port's CUDA kernel plumbing, checked without a card.

* the parameter-block layout matches the pytrees' field order, and the
  opcode table the kernels read matches the twins' tables;
* the wrappers refuse CPU tensors (they launch or raise, never fall back);
* the kernel sources themselves, compiled for the host by g++ with
  `_host_shim.h` standing in for the CUDA runtime (one std::thread per CUDA
  thread, std::barrier for __syncthreads), agree with the plain twins leaf
  for leaf. On the card, chip_smoke.py holds the nvcc build against the
  same twins."""

import ctypes
import functools
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from _torch_parity import seed_frontier, to_port
from chip_smoke import (BENCH_LOOP, mixed_specs, sat_batch_fixture,
                        sat_compare, sat_fixtures)
from mythril_tpu.frontends.asm import assemble
from mythril_tpu.parallel import symstep as jsym
from mythril_tpu_torch.kernels import build, layout, ops
from mythril_tpu_torch.parallel import arena as ta
from mythril_tpu_torch.parallel import batch as tb
from mythril_tpu_torch.parallel import convert, device_solver as tds
from mythril_tpu_torch.parallel import keccak as tk
from mythril_tpu_torch.parallel import lockstep as tl
from mythril_tpu_torch.parallel import symstep as ts
from mythril_tpu_torch.parallel import words as tw

SHIM = os.path.join(os.path.dirname(__file__), "_host_shim.h")


def test_layout_matches_pytree_fields():
    fields = list(tb.StateBatch._fields) + list(ts.SymPlanes._fields)
    assert layout.N_ROW_LEAVES == len(fields)
    assert layout.N_STATE_LEAVES == len(tb.StateBatch._fields)
    for index, name in enumerate(fields):
        assert layout.SLOTS[f"L_{name.upper()}"] == index
    for prefix in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K10",
                   "K11", "K12"):
        assert layout.SLOTS[f"{prefix}_NARGS"] <= layout.MTPU_MAX_ARGS
    assert layout.K4_ROW_BYTES + layout.N_ROW_LEAVES == layout.K4_B
    assert layout.K6_LEAF + layout.N_ROW_LEAVES == layout.K6_INDEX
    assert layout.K7_ROW_BYTES + layout.N_ROW_LEAVES == layout.K7_INDEX
    assert layout.K12_ROW_BYTES + layout.N_ROW_LEAVES == layout.K12_STATUS
    assert [layout.SLOTS[f"K11_{name.upper()}"]
            for name in tds.SolverState._fields] == list(range(5))


def test_optab_matches_twin_tables():
    table = ops.optab("cpu").numpy()
    assert (table[:, 0] == tl.POPS).all() and (table[:, 1] == tl.PUSHES).all()
    assert (table[:, 2] == tl.GAS_MIN).all()
    assert ((table[:, 3] & 1) == tl.VALID).all()
    assert (((table[:, 3] >> 2) & 1) == ts.SYM_OK).all()
    assert (((table[:, 3] >> 8) & 0xFF) == ts.ENV_CLASS).all()
    assert ((table[:, 3] >> 16) == ts.OP_CLASS).all()


def test_wrappers_refuse_cpu_tensors():
    data = torch.zeros((2, 8), dtype=torch.uint8)
    length = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.keccak256(data, length)
    state = tb.build_batch([tb.LaneSpec(code=b"\x00")], device="cpu")
    with pytest.raises(ValueError):
        ops.evm_step(state)
    # the dispatching entry points pick the twin only for CPU tensors
    assert torch.equal(tk.keccak256(data, length),
                       tk.keccak256_reference(data, length))
    planes = ts.SymPlanes.empty(1, 96, 4096, 64, device="cpu")
    index = torch.zeros(1, dtype=torch.int32)
    arena = ta.new_arena(64, 16, device="cpu")
    sched = ts.new_scheduler(state, planes, 2, 2)
    pair = tb.build_batch([tb.LaneSpec(code=b"\x00")] * 2, device="cpu")
    sharded = ts.new_scheduler(pair, ts.SymPlanes.empty(2, 96, 4096, 64,
                                                        device="cpu"),
                               2, 2, n_shards=2)
    for call in (lambda: ops.frontier_summary(state, planes, arena, sched),
                 lambda: ops.row_maxima(state, planes, index),
                 lambda: ops.pack_rows(state, planes, index, 1, 4, 1, 16),
                 lambda: ops.reset_esc(sched),
                 lambda: ops.gather_rows(state, planes, index),
                 lambda: ops.scatter_rows(state, planes, index, state, planes),
                 lambda: ops.arena_delta(arena, None, 0, 0, 0, 16, 16),
                 lambda: ops.steal_pass(state, sharded, 1, 4)):
        with pytest.raises(ValueError):
            call()
    problem = tds.build_problem([[1, 2]], 2)
    sat_state = tds.initial_state(problem.init_assign, 2, "cpu")
    with pytest.raises(ValueError):
        ops.sat_run(sat_state, tds.device_problem(problem, "cpu"), 1, 1, False)


@pytest.mark.parametrize("name", build.SOURCES)
def test_library_names_follow_sources(name):
    a = build.library_path(name)
    assert a == build.library_path(name)
    assert a != build.library_path(name, ["-lineinfo"])
    assert os.path.dirname(a) == build.BUILD_DIR
    assert os.path.basename(a).startswith(f"lib{name}-")
    assert os.path.exists(os.path.join(build.KERNEL_DIR, f"{name}.cu"))
    # every exported entry lives in a built source, and every kernel counts
    # (K9, the telemetry plane, is an instantiation inside sym_step.cu; K13,
    # the sharded chunk's combine, a kernel of sat_step.cu; K3's
    # allocations folded into K4's step and K10's pass count apart from
    # standalone K3)
    assert set(ops._ENTRY_LIB.values()) == set(build.SOURCES)
    assert set(ops.LAUNCHES) == set(build.SOURCES) | {
        "telemetry", "sat_shard_combine", "arena_alloc_step",
        "arena_alloc_merge"}


# ---- the kernel sources, compiled for the host -------------------------------------

@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """{source: CDLL} of the kernels built by g++ against the host shim."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel sources with")
    out = tmp_path_factory.mktemp("host_kernels")
    procs = {}
    for name in build.SOURCES:
        lib = str(out / f"lib{name}.so")
        cmd = [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
               "-Wall", "-Werror", "-include", SHIM, "-x", "c++",
               os.path.join(build.KERNEL_DIR, f"{name}.cu"), "-o", lib]
        procs[name] = (subprocess.Popen(cmd, stderr=subprocess.PIPE,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        libs[name] = ctypes.CDLL(lib)
    return libs


@pytest.fixture
def one_thread():
    """Run the test's PyTorch ops on one thread: the SAT twins are many
    small ops, and beside other test processes a pool of threads per op
    costs them more than it gives."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def host_staging(monkeypatch):
    """K8's staging in plain host memory, its launch on the calling thread
    (no copy stream or event: the shim's launch has returned when the
    blocks are written)."""
    monkeypatch.setattr(ops, "_pinned_int32",
                        lambda n: torch.zeros(n, dtype=torch.int32))
    monkeypatch.setattr(ops, "_launch_after_current",
                        lambda name, block, device, event: ops._call(name, block))
    monkeypatch.setattr(ops, "_DELTA_PLANS", ops._Plans(limit=8))


@pytest.fixture
def on_host(host_kernels, monkeypatch):
    """Route the wrappers to the host-built kernels and CPU tensors."""

    def check(t, what, dtype, shape=None):
        assert t.dtype == dtype, what
        assert shape is None or tuple(t.shape) == tuple(shape), what
        assert t.is_contiguous(), what
        return t.data_ptr()

    monkeypatch.setattr(build, "load", lambda name: host_kernels[name])
    monkeypatch.setattr(ops, "_FUNCS", {})
    monkeypatch.setattr(ops, "_check", check)
    monkeypatch.setattr(ops, "_raw_stream", lambda: 0)


def _same(kernel_tree, plain_tree, what):
    for (name, got), (_, ref) in zip(convert.leaves(convert.to_numpy(kernel_tree)),
                                     convert.leaves(convert.to_numpy(plain_tree))):
        assert got.dtype == ref.dtype and np.array_equal(got, ref), \
            f"{what}: {name}"


def _keccak_ranges_twin(data, length, offset, limit, mask):
    """The standalone K1's function, plainly: row i read from offset[i],
    bytes outside [0, min(limit[i], width)) as 0, masked rows a zero
    digest."""
    rows, width = data.shape
    top = int(length.max())
    idx = offset[:, None] + torch.arange(top)[None, :]
    ok = (idx >= 0) & (idx < torch.clamp(limit.to(torch.int64), max=width)[:, None])
    buf = torch.where(ok, torch.gather(data, 1, idx.clamp(0, width - 1)),
                      torch.zeros((), dtype=torch.uint8))
    out = tk.keccak256_reference(buf, length)
    return torch.where(mask[:, None], out, torch.zeros_like(out))


@pytest.mark.parametrize("case, per_warp", [("whole", 32), ("whole", 1),
                                            ("odd_width", 4), ("ranges", 32),
                                            ("ranges", None)])
def test_host_keccak_matches_twin(on_host, monkeypatch, case, per_warp):
    """The standalone K1 (a warp of `per_warp` messages, one a thread;
    None: the wrapper's choice, one at this batch and the host shim's 132
    SMs, 32 at 4224) against the twin at the padding boundaries, the
    longest message last: whole messages (16-byte loads), rows of an odd
    width (the byte path; 1100 bytes, past one staging window of four rate
    blocks), and ranges of a row with offsets (negative and past the row),
    limits (past the width) and masked rows."""
    if per_warp is not None:
        monkeypatch.setattr(ops, "messages_a_warp", lambda batch, device: per_warp)
    rng = np.random.default_rng(3)
    lengths = [0, 1, 135, 136, 137, 271, 272, 511] * 10 + [512]
    if case == "odd_width":
        lengths[-1] = 1100
    n = len(lengths)
    length = torch.tensor(lengths, dtype=torch.int32)
    width = 1201 if case == "odd_width" else 512
    if case != "ranges":
        data = torch.from_numpy(rng.integers(0, 256, (n, width), dtype=np.uint8))
        assert torch.equal(ops.keccak256(data, length),
                           tk.keccak256_reference(data, length))
        return
    data = torch.from_numpy(rng.integers(0, 256, (n, 1024), dtype=np.uint8))
    offset = torch.from_numpy(rng.integers(-40, 1000, n))
    offset[-1] = 7
    limit = torch.from_numpy(rng.integers(0, 1300, n).astype(np.int32))
    limit[-1] = 1000
    mask = torch.from_numpy(rng.random(n) < 0.8)
    mask[-1] = True
    if per_warp is None:
        assert [ops.messages_a_warp(b, data.device) for b in (n, 263, 264, 4224)] \
            == [1, 1, 2, 32]
    assert torch.equal(ops.keccak_rows(data, length, offset=offset, limit=limit,
                                       mask=mask),
                       _keccak_ranges_twin(data, length, offset, limit, mask))


def test_host_evm_step_matches_twin(on_host):
    specs = mixed_specs(12) + [tb.LaneSpec(BENCH_LOOP, gas_limit=2 ** 60)] \
        + [tb.LaneSpec(assemble(src), gas_limit=10_000) for src in (
            "PUSH1 0x01\nPUSH2 0x1000\nMSTORE\nSTOP",
            "PUSH2 0x0300\nPUSH1 0x00\nRETURN",
            "PUSH1 0x03\nJUMP\nSTOP",
            "PUSH4 0xffffffff\nMLOAD")]
    plain = tb.build_batch(specs, device="cpu")
    kernel = convert.clone(plain)
    for step in range(160):
        plain = tl.step_reference(plain)
        ops.evm_step(kernel)
        if step % 16 == 15:
            _same(kernel, plain, f"step {step}")
    assert int((plain.status == tb.RETURNED).sum()) == 12
    force_escape = torch.tensor([i % 3 == 0 for i in range(len(specs))])
    force_fork = torch.tensor([i % 5 == 1 for i in range(len(specs))])
    plain = tb.build_batch(specs, device="cpu")
    kernel = convert.clone(plain)
    for step in range(4):
        plain = tl.step_reference(plain, force_escape, force_fork)
        ops.evm_step(kernel, force_escape, force_fork)
    _same(kernel, plain, "forced")


def test_host_arena_alloc_matches_twin(on_host):
    rng = np.random.default_rng(4)
    plain = ta.new_arena(64, 16, device="cpu")
    kernel = convert.clone(plain)
    for round_ in range(10):
        want = torch.from_numpy(rng.random(16) < 0.6)
        if round_ % 3 == 0:
            words = torch.from_numpy(rng.integers(0, 1 << 16, (16, 16))
                                     .astype(np.int32))
            plain, ids_p, ovf_p = ta.alloc_consts_reference(plain, want, words)
            kernel, ids_k, ovf_k = ops.arena_alloc(kernel, want, words)
        else:
            n = int(plain.n)
            args = [torch.from_numpy(v.astype(np.int32)) for v in (
                rng.choice([0x01, 0x10, ta.VAR, ta.CONST], 16),
                rng.integers(0, n, 16), rng.integers(0, n, 16),
                rng.integers(0, n, 16), rng.integers(0, 40, 16),
                rng.integers(-5, 1 << 20, 16))]
            plain, ids_p, ovf_p = ta.alloc_rows_reference(plain, want, *args)
            kernel, ids_k, ovf_k = ops.arena_alloc(kernel, want, None, *args)
        assert torch.equal(ids_p, ids_k) and torch.equal(ovf_p, ovf_k)
        _same(kernel, plain, f"round {round_}")
    assert int(plain.n) == 64


@pytest.mark.parametrize("n", [1000, 6144])
def test_host_arena_alloc_runs_match_twin(on_host, n):
    """K3 over more entries than threads (the merge pass's flattened
    masks): each thread walks a run, ranks and ids stay the twin's, and
    the const pool and the node table both overflow on the way."""
    rng = np.random.default_rng(n)
    plain = ta.new_arena(n, n // 2, device="cpu")
    kernel = ta.Arena(*[t.clone() for t in plain])
    for round_ in range(4):
        want = torch.from_numpy(rng.random(n) < 0.4)
        if round_ % 2 == 0:
            words = torch.from_numpy(rng.integers(0, 1 << 16, (n, 16))
                                     .astype(np.int32))
            plain, ids_p, ovf_p = ta.alloc_consts_reference(plain, want, words)
            kernel, ids_k, ovf_k = ops.arena_alloc(kernel, want, words)
        else:
            top = int(plain.n)
            args = [torch.from_numpy(v.astype(np.int32)) for v in (
                rng.choice([0x01, 0x0F, ta.VAR, ta.CONST], n),
                rng.integers(0, top, n), rng.integers(0, top, n),
                rng.integers(0, top, n), rng.integers(0, 40, n),
                rng.integers(-5, 1 << 20, n))]
            plain, ids_p, ovf_p = ta.alloc_rows_reference(plain, want, *args)
            kernel, ids_k, ovf_k = ops.arena_alloc(kernel, want, None, *args)
        assert torch.equal(ids_p, ids_k) and torch.equal(ovf_p, ovf_k)
        _same(kernel, plain, f"round {round_}")
    assert int(plain.n) == n and int(plain.n_const) == n // 2


def test_host_sym_step_matches_twin(on_host):
    from test_torch_symstep import CODES as codes

    state, planes, arena = seed_frontier(codes, 8, base_sym=[0])
    sched = jsym.new_scheduler(state, planes, 4, 3)
    plain = [to_port(k, t) for k, t in zip(("state", "planes", "arena", "sched"),
                                           (state, planes, arena, sched))]
    kernel = [convert.clone(t) for t in plain]
    for step in range(72):
        plain = list(ts.sym_step_reference(*plain))
        kernel = list(ops.sym_step(*kernel))
        if step % 12 == 11:
            for kind, got, ref in zip(("state", "planes", "arena", "sched"),
                                      kernel, plain):
                _same(got, ref, f"step {step} {kind}")
            plain[3].esc_count.zero_()
            kernel[3].esc_count.zero_()
    assert int(plain[3].pushes) > 0 and int(plain[3].pops) > 0


def test_host_telemetry_matches_twin(on_host):
    """K9 (K4's TEL instantiation) and K5's telemetry tail against the
    twins on the telemetry tests' contracts: every counter of the plane
    after every chunk, tags and fleet slots armed."""
    from mythril_tpu_torch.parallel import frontier as tf
    from test_torch_telemetry import CODES as codes, FLEET_SLOTS, TAG_PCS

    state, planes, arena = seed_frontier(codes, 8, base_sym=[2],
                                         arena_capacity=64)
    sched = jsym.new_scheduler(state, planes, 4, 3, telemetry=jsym.new_telemetry(
        TAG_PCS, FLEET_SLOTS, 3))
    plain = [to_port(k, t) for k, t in zip(("state", "planes", "arena", "sched"),
                                           (state, planes, arena, sched))]
    kernel = [convert.clone(t) for t in plain]
    for chunk in range(6):
        plain = list(ts.run_chunk_reference(*plain, 12))
        for _ in range(12):
            kernel = list(ops.sym_step(*kernel))
        for kind, got, ref in zip(("state", "planes", "arena", "sched"),
                                  kernel, plain):
            _same(got, ref, f"chunk {chunk} {kind}")
        assert torch.equal(ops.frontier_summary(*kernel),
                           tf.summary_reference(*plain))
        plain[3].esc_count.zero_()
        kernel[3].esc_count.zero_()
    lifecycle = plain[3].telemetry.lifecycle
    assert int((lifecycle > 0).sum()) >= 8


#: a loop that forks on a calldata word, both sides looping; the same fork
#: to a pc past the code (the forker dies on the bad destination, the
#: fall-through side halts)
K9_FORKER = assemble("JUMPDEST\nPUSH1 0x00\nCALLDATALOAD\nPUSH1 0x00\nJUMPI\n"
                     "PUSH1 0x00\nJUMP")
K9_BAD_JUMP = assemble("PUSH1 0x00\nCALLDATALOAD\nPUSH1 0x40\nJUMPI\nSTOP")
K9_SPIN = assemble("JUMPDEST\nPUSH1 0x00\nJUMP")
#: an SLOAD of a slot not yet read, on a symbolic storage base: it pauses
K9_COLD_SLOAD = assemble("PUSH1 0x00\nSLOAD\nSTOP")


#: K9's per-step cases: (arena capacity, the lifecycle counts that must
#: fire); a small arena kills the forkers on overflow, a large one keeps
#: them forking until they wait for room
K9_CASES = {"pressure": (1 << 8, ("err_deaths", "bad_jump_deaths", "fork_waits",
                                  "cold_sloads", "forks_spilled",
                                  "frozen_revived")),
            "overflow": (8, ("err_deaths", "overflow_kills", "bad_jump_deaths",
                             "cold_sloads"))}


@pytest.mark.parametrize("case", sorted(K9_CASES))
@pytest.mark.parametrize("n_lanes, steps", [(128, 36), (2048, 36)],
                         ids=["128", "2048"])
def test_host_telemetry_plane_every_step(on_host, n_lanes, steps, case):
    """K9 at the card's tile (4 lanes a block: 32 and 512 blocks) against
    the twin after every step: the whole plane and the executed count.
    Every lane spins but the last block's: a forking loop, a fork to a bad
    destination, a cold SLOAD and a stack underflow. So no lane is free, forks push, spill and wait (the escape
    count is zeroed every 6 steps, as a drain does, and the waiting
    forkers revive), and every lifecycle count comes from the last block,
    which the shim runs last: it must reach the plane within its step
    (the fork phase's move folds the blocks' table, its columns on the
    grid's last teams). Every leaf at the end."""
    from test_torch_shard import seed_lanes
    from test_torch_telemetry import FLEET_SLOTS, TAG_PCS

    last = [K9_FORKER, K9_BAD_JUMP, K9_COLD_SLOAD, bytes.fromhex("01")]
    placed = {lane: K9_SPIN for lane in range(n_lanes - len(last))}
    placed.update({n_lanes - len(last) + i: code for i, code in enumerate(last)})
    capacity, counts = K9_CASES[case]
    state, planes, arena = seed_lanes(placed, n_lanes, base_sym=[n_lanes - 2],
                                      arena_capacity=capacity)
    sched = jsym.new_scheduler(state, planes, 4, 3, telemetry=jsym.new_telemetry(
        TAG_PCS, FLEET_SLOTS, 3))
    plain = [to_port(k, t) for k, t in zip(("state", "planes", "arena", "sched"),
                                           (state, planes, arena, sched))]
    kernel = [convert.clone(t) for t in plain]
    for step in range(steps):
        plain = list(ts.sym_step_reference(*plain))
        kernel = list(ops.sym_step(*kernel, lanes_per_block=4, group=1))
        _same(kernel[3].telemetry, plain[3].telemetry, f"step {step} plane")
        assert int(kernel[3].executed) == int(plain[3].executed), step
        if step % 6 == 5:
            plain[3].esc_count.zero_()
            kernel[3].esc_count.zero_()
    for kind, got, ref in zip(("state", "planes", "arena", "sched"), kernel,
                              plain):
        _same(got, ref, kind)
    lifecycle = dict(zip(ts.LIFECYCLE_NAMES, plain[3].telemetry.lifecycle.tolist()))
    for name in counts:
        assert lifecycle[name] > 0, (name, lifecycle)
    tel = plain[3].telemetry
    assert int(tel.esc_cause.sum()) > 0 and int(tel.tag_occ.sum()) > 0
    assert int((tel.fleet_occ > 0).sum()) == 3


def _k6_pool(seed: int, rows: int = 1024):
    """A pool of `rows` random rows (8 stack slots, 256 memory bytes, 64
    storage slots, 16 conds), every leaf filled from the seed."""
    rng = np.random.default_rng(seed)
    one = tb.build_batch([tb.LaneSpec(b"\x00")], stack_slots=8, memory_bytes=256,
                         calldata_bytes=32, retdata_bytes=16, storage_slots=64,
                         tstore_slots=2, device="cpu")
    one_planes = ts.SymPlanes.empty(1, 8, 256, 64, max_conds=16, device="cpu")

    def fill(leaf):
        shape = (rows,) + tuple(leaf.shape[1:])
        if leaf.dtype == torch.bool:
            return torch.from_numpy(rng.random(shape) < rng.random())
        info = np.iinfo(torch.empty(0, dtype=leaf.dtype).numpy().dtype)
        return torch.from_numpy(rng.integers(info.min, info.max, shape,
                                             endpoint=True)).to(leaf.dtype)

    state = type(one)(*[fill(leaf) for leaf in one])
    planes = type(one_planes)(*[fill(leaf) for leaf in one_planes])
    return state, planes


#: K6's host cases over a 1024-row pool (16 maxima blocks of 64 rows):
#: (index, widths); "mid_run" is K5-K8 on a mid-run state
K6_CASES = {
    # a drain of 700 rows padded to 1024 by repeating index[0]
    "repeated": (lambda: np.concatenate([np.arange(700), np.zeros(324, int)]),
                 (200, 5, 17, 9)),
    # out-of-range entries clamp, as JAX's gather does
    "clamped": (lambda: np.array([-7, 1023, 1024, 2 ** 31 - 1, -2 ** 31, 5] * 50),
                (256, 8, 64, 16)),
    # widths of 0 give empty runs
    "zero_widths": (lambda: np.arange(1024)[::-1].copy(), (0, 0, 0, 0)),
    # the largest maxima in the last block: row 1000, selected last
    "last_block": (lambda: np.arange(1001), (1, 4, 1, 16)),
}


@pytest.mark.parametrize("case", ["mid_run"] + sorted(K6_CASES))
def test_host_frontier_programs_match_twins(on_host, host_staging, case):
    """K5-K8 against their twins on a mid-run state: escape rows buffered,
    lanes forking; the escape drain's zero-padded index and a lane index
    padded by repetition; a scatter with a dropped pad; a delta whose
    start must clamp. K6 alone on a 1024-row pool: a padded drain, clamped
    indices, widths of 0, full and the drain's, the largest maxima in the
    last block; twice a plan, its grids as the launches recorded them."""
    from mythril_tpu_torch.parallel import frontier as tf
    from test_torch_symstep import CODES as codes

    if case != "mid_run":
        rows = _k6_pool(11)
        make_index, widths = K6_CASES[case]
        index = torch.from_numpy(make_index().astype(np.int32))
        n = index.shape[0]
        if case == "last_block":
            for column in (rows[0].msize, rows[0].sp, rows[1].cond_count):
                column[1000] = 2 ** 31 - 1
            rows[0].storage_used[1000] = True
        full = (256, 8, 64, 16)
        for attempt, pack_widths in enumerate((widths, full)):
            maxima = ops.row_maxima(*rows, index)
            assert torch.equal(maxima, tf.row_maxima_reference(*rows, index)), attempt
            if case == "last_block":
                assert maxima.tolist() == [2 ** 31 - 1] * 2 + [64, 2 ** 31 - 1]
            got = ops.pack_rows(*rows, index, *pack_widths)
            ref = tf.pack_rows_reference(*rows, index, *pack_widths)
            for mine, theirs in zip(got, ref):
                assert mine.dtype == theirs.dtype and torch.equal(mine, theirs), attempt
            assert ops.pack_rows_grid()["row_maxima"] == (-(-n // 64), 256)
            assert ops.pack_rows_grid()["pack_rows"] == (-(-n * 11 // 32), 256)
            index = index.flip(0).contiguous()
        return

    state, planes, arena = seed_frontier(codes, 8, base_sym=[0])
    sched = jsym.new_scheduler(state, planes, 4, 6)
    tree = [to_port(k, t) for k, t in zip(("state", "planes", "arena", "sched"),
                                          (state, planes, arena, sched))]
    tree = list(ts.run_chunk_reference(*tree, 24))
    state, planes, arena, sched = tree
    assert int(sched.esc_count) > 0
    assert torch.equal(ops.frontier_summary(*tree),
                       tf.summary_reference(*tree))
    esc_index = torch.tensor([0, 1, 2, 0], dtype=torch.int32)[
        :tf.next_pow2(int(sched.esc_count))]
    lane_index = torch.tensor([5, 2, 7, 5], dtype=torch.int32)
    for rows_state, rows_planes, index in (
            (sched.esc_state, sched.esc_planes, esc_index),
            (state, planes, lane_index)):
        maxima = ops.row_maxima(rows_state, rows_planes, index)
        assert torch.equal(maxima, tf.row_maxima_reference(
            rows_state, rows_planes, index))
        for widths in (tf.pack_widths(rows_state, rows_planes,
                                      *(int(v) for v in maxima)),
                       (256, 16, 8, 8)):
            got = ops.pack_rows(rows_state, rows_planes, index, *widths)
            ref = tf.pack_rows_reference(rows_state, rows_planes, index,
                                         *widths)
            for mine, theirs in zip(got, ref):
                assert mine.dtype == theirs.dtype and torch.equal(mine, theirs)
    for got, ref in zip(ops.gather_rows(state, planes, lane_index[:2]),
                        tf.gather_rows_reference(state, planes,
                                                 lane_index[:2])):
        _same(got, ref, "gather")
    rows = tf.gather_rows_reference(sched.esc_state, sched.esc_planes,
                                    torch.tensor([1, 0], dtype=torch.int32))
    scatter_index = torch.tensor([3, 8], dtype=torch.int32)  # 8: dropped
    plain = [convert.clone(t) for t in (state, planes)]
    kernel = [convert.clone(t) for t in (state, planes)]
    tf.scatter_rows_reference(*plain, scatter_index, *rows)
    ops.scatter_rows(*kernel, scatter_index, *rows)
    _same(kernel[0], plain[0], "scatter state")
    _same(kernel[1], plain[1], "scatter planes")
    for start, cstart, bucket, cbucket in ((0, 0, 16, 16), (int(arena.n), 3, 64, 16),
                                           (4090, 250, 16, 16)):
        for mine, theirs in zip(
                ops.arena_delta(arena, None, 0, start, cstart, bucket, cbucket)[:2],
                ta.fetch_delta_reference(arena, start, cstart, bucket, cbucket)):
            assert torch.equal(mine, theirs)
    ops.reset_esc(sched)
    assert int(sched.esc_count) == 0


#: K8's host cases: (start, cstart, bucket, cbucket) in call order over a
#: 4096-node arena with 256 consts: aligned and unaligned starts, starts
#: that clamp, buckets that grow the staging past a slot and to the whole
#: arena, then a small one again (the grown staging kept)
K8_CASES = [(0, 0, 16, 16), (5, 3, 16, 16), (1001, 17, 1024, 64),
            (4090, 250, 16, 16), (4093, 255, 64, 32), (1, 0, 4096, 256),
            (7, 9, 16, 16)]


def test_host_arena_delta_staging(on_host, host_staging):
    """K8 into its staging, each case in turn into slot 0 and 1, against
    `fetch_delta_reference`: the blocks as host views of the slot, the
    other slot left as it was; one plan for the arena and mirror, its
    staging grown by powers of two and never shrunk."""
    rng = np.random.default_rng(8)
    arena = ta.new_arena(4096, 256, device="cpu")
    for col in ta.ROW_COLS:
        getattr(arena, col).copy_(torch.from_numpy(
            rng.integers(-2 ** 31, 2 ** 31, 4096).astype(np.int32)))
    arena.const_vals.copy_(torch.from_numpy(
        rng.integers(-2 ** 31, 2 ** 31, (256, 16)).astype(np.int32)))
    plan, sizes = None, []
    for index, (start, cstart, bucket, cbucket) in enumerate(K8_CASES):
        slot = index % 2
        keep = plan.staging.clone() if plan is not None else None
        rows, consts, _ = ops.arena_delta(arena, "mirror", slot, start, cstart,
                                          bucket, cbucket)
        ref_rows, ref_consts = ta.fetch_delta_reference(arena, start, cstart,
                                                        bucket, cbucket)
        assert torch.equal(rows, ref_rows) and torch.equal(consts, ref_consts), index
        plan = ops.delta_plan(arena, "mirror")
        sizes.append(plan.slot_words)
        assert plan.slot_words >= 6 * bucket + 16 * cbucket
        assert rows.data_ptr() == plan.staging.data_ptr() + 4 * slot * plan.slot_words
        if keep is not None and sizes[-1] == sizes[-2]:
            # the other slot is untouched
            other = slice((1 - slot) * plan.slot_words, (2 - slot) * plan.slot_words)
            assert torch.equal(plan.staging[other], keep[other]), index
    assert plan.launches == len(K8_CASES)
    assert sizes == sorted(sizes) and len(set(sizes)) > 2
    assert all(size & (size - 1) == 0 for size in sizes)


#: K10's host cases: (inputs, free arena nodes, passes); "overflow*" cut
#: the arena so that it runs out inside the pair's blend
MERGE_CASES = {"diamond": ("diamond", None, 1),
               "bothwrite": ("bothwrite", None, 1),
               "bothwrite_windows": ("bothwrite_windows", None, 1),
               "overflow": ("diamond", 2, 1),
               "overflow_spare1": ("diamond", 1, 1),
               "overflow_windows_spare1": ("bothwrite_windows", 1, 1),
               "overflow_windows_spare2": ("bothwrite_windows", 2, 1),
               "mem_branchy": ("mem_branchy", None, 1),
               "mem_branchy_twice": ("mem_branchy", None, 2)}


@functools.cache
def _merge_inputs(name):
    """The JAX lanes, arena and tables a merge case starts from, run once
    for every case that shares them (JAX arrays are immutable)."""
    import test_torch_merge as tm
    from bench import _mem_branchy_contract
    from _torch_parity import jax_static_tables
    from mythril_tpu.frontends.asm import dispatcher

    if name == "mem_branchy":
        code = assemble(dispatcher({"stress()": _mem_branchy_contract(8)}))
        state, planes, arena = seed_frontier([code], 16, max_conds=16,
                                             arena_capacity=1 << 14,
                                             const_capacity=1 << 12)
        sched = jsym.new_scheduler(state, planes, 32, 32)
        state, planes, arena, _ = jsym.run_chunk(state, planes, arena, sched,
                                                 40)
        _, (merge_pcs, _, mem_pcs, mem_words) = jax_static_tables([code])
        return state, planes, arena, merge_pcs, mem_pcs, mem_words
    code, steps, merge_pcs, mem_pcs, mem_words = tm.DIAMONDS[name]
    return (*tm._pair_run(code, steps), merge_pcs, mem_pcs, mem_words)


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_host_merge_pass_matches_twin(on_host, case):
    """K10, K3's allocations folded into its launches, against
    `merge_pass_reference` on the merge tests' inputs: every leaf, the arena
    and the stats vector after each pass ("twice": a second pass through
    the same cached plan and scratch)."""
    import test_torch_merge as tm

    name, spare, passes = MERGE_CASES[case]
    state, planes, arena, merge_pcs, mem_pcs, mem_words = _merge_inputs(name)
    if spare is not None:
        arena = tm._shrink(arena, spare)
    plain = [to_port(k, t) for k, t in zip(("state", "planes", "arena"),
                                           (state, planes, arena))]
    kernel = [convert.clone(t) for t in plain]
    n_before = int(plain[2].n)
    tables = ts._merge_tables(merge_pcs, mem_pcs, mem_words, "cpu")
    for index in range(passes):
        ref = ts.merge_pass_reference(*plain, *tables, n_rounds=6)
        got = ops.merge_pass(*kernel, *tables, n_rounds=6)
        for kind, mine, theirs in zip(("state", "planes", "arena"), got, ref):
            _same(mine, theirs, f"pass {index} {kind}")
        assert torch.equal(got[3], ref[3])
        merged = int(ref[3][0]) if index == 0 else merged
    if name in ("diamond", "bothwrite_windows", "mem_branchy") and spare is None:
        assert merged > 0
    if spare is not None:
        # the pair stays unmerged; the nodes made before the arena ran out
        # stay allocated
        assert int(ref[3][0]) == 0 and int(ref[2].n) > n_before


@pytest.mark.parametrize("case", [f[0] for f in sat_fixtures()] + ["batch"])
def test_host_sat_step_matches_twin(on_host, one_thread, case):
    """K11 against `run_chunk_reference` on chip_smoke's fixtures (the
    phase-race, no-flip and 32-probe ones, and the batch runner's freeze),
    every leaf after each chunk."""
    if case == "batch":
        problems = [tds.build_problem(c, n) for c, n in sat_batch_fixture()]
        tensors = tds.device_problem(problems, "cpu")
        state = tds.initial_state(np.stack([p.init_assign for p in problems]),
                                  8, "cpu")
        kernel = sat_compare(state, tensors, 2, 3, 8, True, case,
                             graphs=(False,))
        assert (kernel.status[1] != tds.SEARCHING).all()
        return
    _, clauses, n_vars, n_probes = next(f for f in sat_fixtures()
                                        if f[0] == case)
    problem = tds.build_problem(clauses, n_vars)
    tensors = tds.device_problem(problem, "cpu")
    state = tds.initial_state(problem.init_assign, n_probes, "cpu")
    kernel = sat_compare(state, tensors, 2, 3, n_probes, False, case,
                         graphs=(False,))
    assert int(kernel.trail_len.max()) > 1


def _sat_case(case):
    """(state, problem tensors, probes, freeze) of a chip_smoke K11 fixture
    ("batch": the batch runner's four queries, 8 probes each)."""
    if case == "batch":
        problems = [tds.build_problem(c, n) for c, n in sat_batch_fixture()]
        state = tds.initial_state(np.stack([p.init_assign for p in problems]),
                                  8, "cpu")
        return state, tds.device_problem(problems, "cpu"), 8, True
    _, clauses, n_vars, n_probes = next(f for f in sat_fixtures()
                                        if f[0] == case)
    problem = tds.build_problem(clauses, n_vars)
    state = tds.initial_state(problem.init_assign, n_probes, "cpu")
    return state, tds.device_problem(problem, "cpu"), n_probes, False


SAT_CASES = [f[0] for f in sat_fixtures()] + ["batch"]


@pytest.mark.parametrize("case", SAT_CASES)
def test_host_sat_tiles_match_twin(on_host, one_thread, case):
    """K11 with each probe's 1,024 vars split over 16 blocks (a variable
    tile of 64): the count blocks' tile partials, each apply block
    combining the earlier tiles' partials itself in tile order, the ranked
    append and the clears across blocks, against
    `run_chunk_reference` after each of three 4-step chunks from one plan."""
    state, tensors, n_probes, freeze = _sat_case(case)
    assert state.assign.shape[-1] == 1024
    sat_compare(state, tensors, 4, 3, n_probes, freeze, case, graphs=(False,),
                var_tile=64)


def test_sat_fixtures_take_every_branch(one_thread):
    """The 12 steps the test above runs from the fixtures take every branch
    of a step: a conflict with a flip and one without (the cube refuted),
    units, SAT, and decisions inside and past the forced prefix."""
    seen = set()
    for case in SAT_CASES:
        current, tensors, n_probes, freeze = _sat_case(case)
        depth = tds.forced_depth_of(n_probes)
        for _ in range(12):
            after = tds.run_chunk_reference(convert.clone(current), tensors, 1,
                                            depth, freeze)
            length, new_length = (current.trail_len.long(),
                                  after.trail_len.long())
            appended = after.tag.gather(-1, length.clamp(
                max=current.assign.shape[-1] - 1)[..., None])[..., 0]
            moved = (current.status == tds.SEARCHING) & (
                (after.status != current.status) | (new_length != length)
                | (after.assign != current.assign).any(-1))
            going = moved & (after.status == tds.SEARCHING)
            for name, mask in (
                    ("refuted", moved & (after.status == tds.S_UNSAT)),
                    ("sat", moved & (after.status == tds.S_SAT)),
                    ("flip", going & (new_length <= length)),
                    ("units", going & (new_length > length) & (appended == 0)),
                    ("decide_forced", going & (new_length == length + 1)
                     & (appended == 2)),
                    ("decide", going & (new_length == length + 1)
                     & (appended == 1))):
                if bool(mask.any()):
                    seen.add(name)
            current = after
    assert seen == {"refuted", "sat", "flip", "units", "decide_forced",
                    "decide"}


# ---- the sharded scheduler: segmented K4/K5, K6's vector reset, K12 --------------------

@pytest.mark.parametrize("n_shards, telemetry", [(2, False), (4, True)],
                         ids=["d2", "d4-tel"])
def test_host_sharded_step_matches_twin(on_host, n_shards, telemetry):
    """K4 and K5 with vector tops, K6's reset of every segment and K12's
    steal pass against the twins, chunk after chunk, on the sharded
    tests' seeding: one block's stack segment fills while others have
    room, and the pass moves its rows."""
    from mythril_tpu_torch.parallel import frontier as tf
    from test_torch_shard import SEEDINGS, seed_lanes

    state, planes, arena = seed_lanes(SEEDINGS[n_shards],
                                      base_sym=[13 if n_shards == 4 else 12])
    tel = jsym.new_telemetry([5, 13, 0x1B], fleet_slots=[0, 0, 1, 1],
                             n_fleet=2) if telemetry else None
    sched = jsym.new_scheduler(state, planes, 4 * n_shards, 6 * n_shards,
                               telemetry=tel, n_shards=n_shards)
    plain = [to_port(k, t) for k, t in zip(("state", "planes", "arena", "sched"),
                                           (state, planes, arena, sched))]
    kernel = [convert.clone(t) for t in plain]
    for chunk in range(6):
        plain = list(ts.run_chunk_reference(*plain, 12))
        for _ in range(12):
            kernel = list(ops.sym_step(*kernel))
        for kind, got, ref in zip(("state", "planes", "arena", "sched"),
                                  kernel, plain):
            _same(got, ref, f"chunk {chunk} {kind}")
        assert torch.equal(ops.frontier_summary(*kernel),
                           tf.summary_reference(*plain))
        tf.steal_pass_reference(plain[0], plain[3], 1, 4)
        ops.steal_pass(kernel[0], kernel[3], 1, 4)
        _same(kernel[3], plain[3], f"chunk {chunk} steal")
        tf.reset_esc_reference(plain[3])
        ops.reset_esc(kernel[3])
        assert not kernel[3].esc_count.any()
    assert int(plain[3].pushes) > 0 and int(plain[3].steal_rows) > 0


def _steal_cases() -> dict:
    """K12's host cases: the JAX comparison's fixtures (forced imbalance,
    below the threshold, D = 3, tied loads, short room), a max_rows past
    the rows the pair moves, and 64-lane blocks (each warp's lanes in one
    shard, counted by one ballot)."""
    from test_torch_shard import STEAL_CASES, _pool_fixture

    return {**STEAL_CASES,
            "max_rows_spare": (lambda: _pool_fixture(8, 2, 8, [0, 4]), 1, 16),
            "warp_ballot": (lambda: _pool_fixture(128, 2, 8, [0, 4],
                                                  running=[10, 50]), 1, 4)}


@pytest.mark.parametrize("case", sorted(_steal_cases()))
def test_host_steal_pass_matches_twin(on_host, monkeypatch, case):
    """K12 against the twin with rows cut into 256-byte copy items (nine
    or more blocks a row, as the default geometry's 4 KB slices cut its
    39 KB rows), every pool leaf and counter; the move grid as the launch
    recorded it."""
    from mythril_tpu_torch.parallel import frontier as tf

    monkeypatch.setattr(ops, "_MOVE_SLICE", 256)
    monkeypatch.setattr(ops, "_STEAL_PLANS", ops._Plans(limit=4))
    make, min_imbalance, max_rows = _steal_cases()[case]
    state, sched = make()
    plain = to_port("sched", sched)
    kernel = convert.clone(plain)
    tf.steal_pass_reference(to_port("state", state), plain, min_imbalance,
                            max_rows)
    ops.steal_pass(to_port("state", state), kernel, min_imbalance, max_rows)
    _same(kernel, plain, case)
    plan = next(iter(ops._STEAL_PLANS.values()))
    n_items = plan.items.shape[0] - 1
    n_seg = int(plain.stack_top.shape[0])
    assert n_items >= 9
    assert ops.steal_pass_grid()[2:] == (n_seg // 2 * max_rows * n_items, 256)


#: K5's host cases: (shards, storage slots, live rows a segment or None for
#: all, telemetry armed)
SUMMARY_CASES = {"d1_partial": (1, 64, [700], False),
                 "d4_partial": (4, 64, [100, 0, 256, 37], False),
                 "all_live": (4, 64, None, False),
                 "telemetry": (4, 64, [200, 31, 0, 255], True),
                 "odd_slots": (2, 20, [300, 41], True)}


def _summary_tree(n_shards, slots, live, telemetry, seed=5):
    """[state, planes, arena, sched] on the CPU: 1024 escape rows of
    `slots` storage slots (512 at 20 slots), random columns spread over
    every row (an all-live fixture's sp negative, so that no 0 enters its
    maxima), `live` rows of each segment live (the others' columns larger
    than any live row's), random scheduler scalars, telemetry counters and
    steal counters."""
    rng = np.random.default_rng(seed)
    n_lanes = 8 * n_shards
    specs = [tb.LaneSpec(b"\x60\x01\x00")] * n_lanes
    state = tb.build_batch(specs, stack_slots=8, memory_bytes=64,
                           calldata_bytes=32, retdata_bytes=16,
                           storage_slots=slots, tstore_slots=2, device="cpu")
    planes = ts.SymPlanes.empty(n_lanes, 8, 64, slots, max_conds=4,
                                device="cpu")
    tel = ts.new_telemetry([5, 13, 0x1B], fleet_slots=[0, 1], n_fleet=2,
                           device="cpu") if telemetry else None
    esc_rows = 1024 if slots % 16 == 0 else 512
    sched = ts.new_scheduler(state, planes, 4 * n_shards, esc_rows,
                             telemetry=tel, n_shards=n_shards)
    esc, esc_planes = sched.esc_state, sched.esc_planes

    def fill(tensor, low, high):
        tensor.copy_(torch.from_numpy(rng.integers(
            low, high, tuple(tensor.shape)).astype(np.int64)).to(tensor.dtype))

    fill(esc.msize, 0, 5000)
    fill(esc.sp, -90 if live is None else 0, 9 if live is not None else -3)
    fill(esc_planes.cond_count, 0, 5)
    density = torch.from_numpy(rng.random((esc_rows, 1)) / 2)
    esc.storage_used.copy_(torch.from_numpy(rng.random((esc_rows, slots)))
                           < density)
    seg = esc_rows // n_shards
    counts = [seg] * n_shards if live is None else live
    sched.esc_count.copy_(torch.tensor(counts if n_shards > 1 else counts[0],
                                       dtype=torch.int32))
    # a non-live row holds the largest values and every slot used: counted,
    # it would set the maxima
    rows = torch.arange(esc_rows)
    dead = rows % seg >= torch.tensor(counts).repeat_interleave(seg)
    for column in (esc.msize, esc.sp, esc_planes.cond_count):
        column[dead] = 1 << 20
    esc.storage_used[dead] = True
    fill(sched.stack_top, 0, 5)
    for scalar in (sched.executed, sched.forks, sched.pushes, sched.pops):
        fill(scalar, 0, 1 << 40)
    if tel is not None:
        for counter in (tel.op_hist, tel.lifecycle, tel.esc_cause,
                        tel.occupancy, tel.hwm, tel.tag_occ, tel.fleet_occ):
            fill(counter, 0, 1 << 40)
    if n_shards > 1:
        for counter in (sched.steals_sent, sched.steals_received,
                        sched.steal_rows):
            fill(counter, 0, 1000)
    state.status.copy_(torch.from_numpy(rng.integers(0, 8, n_lanes)
                                        .astype(np.int32)))
    planes.fork_cond.copy_(torch.from_numpy(rng.integers(
        -5, 1 << 20, n_lanes).astype(np.int32)))
    planes.ctx_id.copy_(torch.from_numpy(rng.integers(0, 9, n_lanes)
                                         .astype(np.int32)))
    arena = ta.new_arena(64, 16, device="cpu")
    arena.n.fill_(17)
    arena.n_const.fill_(3)
    return [state, planes, arena, sched]


@pytest.mark.parametrize("case", sorted(SUMMARY_CASES))
def test_host_summary_matches_twin(on_host, case):
    """K5 against the twin over several blocks' worth of escape rows (16
    blocks of 64 rows at 64 slots, 4 of 128 at 20), then again on the same
    plan after the rows changed (the highest live row, in the last block
    when every row is live, taking msize's maximum); the grid is the one
    the launch recorded."""
    from mythril_tpu_torch.parallel import frontier as tf

    tree = _summary_tree(*SUMMARY_CASES[case])
    state, planes, arena, sched = tree
    rows_per_block = 64 if sched.esc_state.storage_used.shape[1] == 64 else 128
    maxima = []
    for attempt in range(2):
        got = ops.frontier_summary(*tree).clone()
        ref = tf.summary_reference(*tree)
        assert got.dtype == ref.dtype and torch.equal(got, ref), attempt
        assert ops.frontier_summary_grid() == (
            sched.esc_state.status.shape[0] // rows_per_block, 256)
        maxima.append(got[8:12].tolist())
        # the second launch sees other maxima in other blocks: msize's in
        # the highest live row (the last block when every row is live)
        sched.esc_count.copy_(torch.maximum(sched.esc_count - 1,
                                            torch.zeros_like(sched.esc_count)))
        counts = sched.esc_count.reshape(-1).tolist()
        seg = sched.esc_state.sp.shape[0] // len(counts)
        top = max(d * seg + n - 1 for d, n in enumerate(counts) if n)
        sched.esc_state.msize[top] = 9999 + attempt
        sched.esc_state.sp.add_(1)
        sched.esc_planes.cond_count[sched.esc_state.sp.shape[0] // 2] = 77
        sched.esc_state.storage_used[3].fill_(True)
    assert maxima[0] != maxima[1]
    if SUMMARY_CASES[case][2] is None:
        assert max(maxima[0]) > 0 > maxima[0][1]


def test_plans_last_call_and_key():
    """ops._Plans: the very tensors of the last call take its plan without
    building the key; other tensor objects over the same storage find it by
    key; other static arguments or storage build anew; the least recently
    used plan goes past the limit; no tensor is kept alive."""
    import gc
    import weakref

    plans, built = ops._Plans(limit=2), []

    def build():
        built.append(object())
        return built[-1]

    a, b = torch.zeros(4), torch.ones(4)
    first = plans.get([a, b], (1,), build)
    assert plans.get([a, b], (1,), build) is first
    assert plans.get([a.view(4), b], (1,), build) is first
    assert len(built) == 1
    second = plans.get([a, b], (2,), build)
    third = plans.get([a, torch.ones(4)], (1,), build)
    assert len({id(first), id(second), id(third)}) == 3 and len(built) == 3
    assert plans.get([a, b], (2,), build) is second
    assert plans.get([a, b], (1,), build) is not first   # dropped at the limit
    plans.clear()
    assert plans.get([a, b], (2,), build) is not second
    dead = torch.zeros(3)
    plans.get([dead], (), build)
    ref = weakref.ref(dead)
    del dead
    gc.collect()
    assert ref() is None


def test_k6_plan_per_source_tree(on_host, monkeypatch):
    """K6's wrappers take their block from one `ops._Plans` entry per
    source tree: the maxima and the pack of one pool share it; a second
    drive's pool takes a new plan, and the first pool's is found again by
    its key; the escape reset has a plan of its own; no plan keeps a pool
    alive."""
    import gc
    import weakref

    from mythril_tpu_torch.parallel import frontier as tf

    monkeypatch.setattr(ops, "_ROW_PLANS", ops._Plans(limit=8))
    monkeypatch.setattr(ops, "_RESET_PLANS", ops._Plans(limit=8))
    first, second = _k6_pool(1, rows=128), _k6_pool(2, rows=128)
    index = torch.arange(100, dtype=torch.int32)
    ops.row_maxima(*first, index)
    ops.pack_rows(*first, index, 1, 4, 1, 16)
    plan = ops.row_plan(*first)
    assert len(ops._ROW_PLANS.plans) == 1
    got = ops.row_maxima(*second, index)
    assert torch.equal(got, tf.row_maxima_reference(*second, index))
    assert len(ops._ROW_PLANS.plans) == 2 and ops.row_plan(*second) is not plan
    again = [type(tree)(*[leaf.view(leaf.shape) for leaf in tree]) for tree in first]
    assert ops.row_plan(*again) is plan   # other tensor objects, same storage
    for mine, theirs in zip(ops.pack_rows(*first, index, 1, 4, 1, 16),
                            tf.pack_rows_reference(*first, index, 1, 4, 1, 16)):
        assert torch.equal(mine, theirs)
    counts = torch.full((4,), 9, dtype=torch.int32)
    sched = type("Sched", (), {"esc_count": counts})()
    ops.reset_esc(sched)
    assert counts.tolist() == [0] * 4 and len(ops._RESET_PLANS.plans) == 1
    assert ops.pack_rows_grid()["reset_esc"] == (1, 32)
    dead = weakref.ref(second[0].msize)
    del second, got
    gc.collect()
    assert dead() is None


def test_summary_decode_copies_what_it_keeps():
    """The drain loop's decode keeps no view of the summary it is given:
    after that buffer is overwritten, the telemetry words and the shard
    block it kept are unchanged, and the next summary's steal and
    telemetry deltas are its own."""
    from mythril_tpu_torch.parallel import frontier as tf

    fr = tf.DeviceFrontier(16, device="cpu", n_shards=2)
    state, planes = fr.seed([(BENCH_LOOP, {}, False, 10_000, 0)])
    sched = fr.new_sched(state, planes)
    sched.telemetry.op_hist.fill_(3)
    sched.steals_sent.copy_(torch.tensor([5, 0]))
    sched.steal_rows.fill_(5)
    buffer = tf.summary_reference(state, planes, fr.arena, sched).numpy().copy()
    first = buffer.copy()
    fr._decode_summary(buffer, True)
    kept = (fr.tel_words.copy(), fr.shard_tops.copy(), fr.shard_esc.copy(),
            [np.copy(part) for part in fr.shard_steals])
    buffer[:] = -7
    assert np.array_equal(fr.tel_words, kept[0])
    assert np.array_equal(fr.shard_tops, kept[1])
    assert np.array_equal(fr.shard_esc, kept[2])
    assert all(np.array_equal(mine, theirs)
               for mine, theirs in zip(fr.shard_steals, kept[3]))
    # the next chunk: two more steals and one more op of each class
    buffer[:] = first
    n_tel = fr.tel_words.shape[0]
    tail = 4 * 2 + 1
    tel_at = len(buffer) - tail - n_tel
    buffer[tel_at:tel_at + ts.N_OP_CLASSES] += 1
    buffer[-tail + 4] += 2     # steals_sent[0]
    buffer[-1] += 2            # steal_rows
    fr._decode_summary(buffer, True)
    assert fr.steals_sent.tolist() == [7, 0] and int(fr.steal_rows) == 7
    assert fr.op_hist.tolist() == [4] * ts.N_OP_CLASSES


# ---- K2's parity hazards: one block (a warp on the card) per lane ---------------------

def _word(value: int) -> str:
    return f"PUSH32 0x{value % (1 << 256):064x}"


def _pattern(n_words: int, seed: int) -> list:
    """MSTOREs of n_words random words at 0, 32, ..."""
    rng = np.random.default_rng(seed)
    lines = []
    for k in range(n_words):
        lines += [_word(int.from_bytes(rng.bytes(32), "big")),
                  f"PUSH2 0x{32 * k:04x}", "MSTORE"]
    return lines


def _op3(op: str, a: int, b: int = 0, c: int = 0) -> list:
    """Push c, b, a (a on top) and run `op`."""
    return [_word(c), _word(b), _word(a), op]


def _lane(lines, **kw) -> tb.LaneSpec:
    return tb.LaneSpec(assemble("\n".join(lines)), gas_limit=10_000_000, **kw)


def _set_slot(state, field: str, lane: int, slot: int, key: int,
              value: int) -> None:
    keys = getattr(state, f"{field}_keys")
    vals = getattr(state, f"{field}_vals")
    keys[lane, slot] = torch.from_numpy(
        tw.from_int(key).view(np.int32).copy())
    vals[lane, slot] = torch.from_numpy(
        tw.from_int(value).view(np.int32).copy())
    getattr(state, f"{field}_used")[lane, slot] = True


def _k2_mcopy():
    base = _pattern(3, 1)  # msize 96
    specs = [_lane(base + _op3("MCOPY", 0x10, 0x00, 0x80) + ["STOP"]),
             _lane(base + _op3("MCOPY", 0x00, 0x28, 0x64) + ["STOP"]),
             _lane(base + _op3("MCOPY", 0x30, 0x08, 0x200)
                   + _op3("MCOPY", 0x00, 0x02, 0x201)),
             _lane(base + _op3("MCOPY", 0x40, 0x40, 0x40)
                   + _op3("MCOPY", 0x41, 0x21, 0x1ff) + ["STOP"])]
    return tb.build_batch(specs, device="cpu"), None, 20


def _k2_copies():
    calldata = bytes(range(130))
    specs = [_lane(_op3("CALLDATACOPY", 0x00, 100, 512) + ["STOP"],
                   calldata=calldata),
             _lane(_op3("CODECOPY", 0x100, 3, 512) + ["STOP"]),
             _lane(_op3("CALLDATACOPY", 0x08, (1 << 256) - 1, 512) + ["STOP"],
                   calldata=calldata),
             _lane(_op3("CODECOPY", 3800, 0, 512) + ["STOP"]),
             _lane(_op3("RETURNDATACOPY", 0x00, 0, 64) + ["STOP"]),
             _lane(_op3("CALLDATACOPY", 0x00, 0, 513) + ["STOP"],
                   calldata=calldata)]
    return tb.build_batch(specs, device="cpu"), None, 8


def _k2_return():
    base = _pattern(4, 2)
    specs = [_lane(base + [_word(512), _word(0), "RETURN"]),
             _lane(base + [_word(513), _word(0), "RETURN"]),
             _lane(base + [_word(300), _word(100), "REVERT"]),
             _lane(base + [_word(200), _word(4000), "RETURN"]),
             _lane(base + [_word(0), _word(1 << 40), "RETURN"])]
    return tb.build_batch(specs, device="cpu"), None, 20


def _k2_sload_two():
    specs = [_lane(["PUSH1 0x05", "SLOAD", "PUSH1 0x09", "SLOAD",
                    "PUSH1 0x0b", "SLOAD", "PUSH1 0x07", "TLOAD", "STOP"],
                   storage={5: (1 << 256) - 1, 9: 0xBEEF})] * 2
    state = tb.build_batch(specs, device="cpu")
    _set_slot(state, "storage", 0, 40, 5, 0xFFFF_0001 << 200 | 0xFFFF)
    _set_slot(state, "storage", 1, 32, 5, 12345)  # slot 0's thread
    for lane, slots in ((0, (1, 6)), (1, (0, 7))):
        for slot in slots:
            _set_slot(state, "tstore", lane, slot, 7, 0xFFFF << 16 * slot)
    return state, None, 9


def _k2_sstore_free():
    table = {100 + k: k for k in range(64)}
    specs = [_lane(_op3("SSTORE", 7, 0xAB) + ["STOP"], storage=table),
             _lane(_op3("SSTORE", 8, 0xCD) + ["STOP"], storage=table),
             _lane(_op3("SSTORE", 9, 0xEF) + ["STOP"], storage=table),
             _lane(_op3("TSTORE", 3, 0x11) + _op3("TSTORE", 4, 0x22)
                   + ["STOP"])]
    state = tb.build_batch(specs, device="cpu")
    for lane in (0, 1):
        state.storage_used[lane, 3] = False
        state.storage_used[lane, 37] = False
        _set_slot(state, "storage", lane, 45, 7, 1)
    state.storage_used[2, 33:35] = False  # free slots on threads 1 and 2
    for slot in (0, 1, 2, 3, 4, 6, 7):
        _set_slot(state, "tstore", 3, slot, 50 + slot, slot)
    _set_slot(state, "tstore", 3, 6, 3, 0x99)
    return state, None, 8


def _k2_full():
    table = {100 + k: k for k in range(64)}
    specs = [_lane(_op3("SSTORE", 7, 1) + ["STOP"], storage=table),
             _lane(_op3("SSTORE", 163, 1) + ["STOP"], storage=table),
             _lane(_op3("TSTORE", 9, 1) + ["STOP"])]
    state = tb.build_batch(specs, device="cpu")
    for slot in range(8):
        _set_slot(state, "tstore", 2, slot, 20 + slot, slot)
    return state, None, 6


def _k2_arith():
    rng = np.random.default_rng(11)
    loop = ["PUSH1 0x00", "JUMPDEST", "PUSH1 0x01", "ADD", "DUP1",
            "PUSH1 0x0c", "GT", "PUSH1 0x02", "JUMPI", "STOP"]
    specs = []
    for position, op in enumerate(("DIV", "SDIV", "MOD", "SMOD", "ADDMOD",
                                   "MULMOD", "EXP", "SIGNEXTEND", "DIV",
                                   "MULMOD")):
        a, b, c = (int.from_bytes(rng.bytes(32), "big") >> int(rng.integers(0, 250))
                   for _ in range(3))
        if position >= 8:
            b = c = 0  # by zero
        specs.append(_lane(_op3(op, a, b, c) + ["PUSH1 0x00", "MSTORE",
                                                "STOP"]))
        specs.append(_lane(loop))
    return tb.build_batch(specs, device="cpu"), None, 48


def _k2_forced():
    specs = mixed_specs(6) + [tb.LaneSpec(BENCH_LOOP, gas_limit=2 ** 60)] * 3
    n = len(specs)
    rng = np.random.default_rng(5)
    masks = [(torch.from_numpy(rng.random(n) < 0.3),
              torch.from_numpy(rng.random(n) < 0.2)) for _ in range(6)]
    return tb.build_batch(specs, device="cpu"), masks, 6


#: K1's SHA3 lanes: (offset, length, msize), the length words at keccak's
#: padding boundaries, misaligned offsets, a range straddling msize (the
#: memory past it is not zero), ranges past the row, 513 bytes and
#: lengths and offsets past 32 bits; the two lanes before the last are
#: forced to escape and to fork at the SHA3, the last (512 bytes across
#: msize) decides in the last block
SHA3_LANES = [(0, 0, 544), (0, 135, 544), (3, 136, 544), (17, 137, 544),
              (64, 271, 544), (5, 272, 544), (0, 512, 4096), (4000, 200, 4096),
              (4100, 32, 4096), (0, 513, 4096), (0, 1 << 40, 4096),
              (1 << 40, 0, 96), ((1 << 32) + 5, 10, 96), (9, 100, 544),
              (9, 100, 544), (77, 512, 300)]


def _k2_sha3():
    rng = np.random.default_rng(12)
    specs = [_lane(_op3("SHA3", off, length) + ["PUSH1 0x00", "MSTORE", "STOP"])
             for off, length, _ in SHA3_LANES]
    state = tb.build_batch(specs, device="cpu")
    state.memory.copy_(torch.from_numpy(rng.integers(0, 256, tuple(state.memory.shape),
                                                     dtype=np.uint8)))
    state.msize.copy_(torch.tensor([msize for _, _, msize in SHA3_LANES],
                                   dtype=torch.int32))
    n = len(SHA3_LANES)
    masks = [(torch.zeros(n, dtype=torch.bool), torch.zeros(n, dtype=torch.bool))
             for _ in range(7)]
    masks[3][0][n - 3] = True   # the SHA3 step: escape, fork
    masks[3][1][n - 2] = True
    return state, masks, 7


#: the twin's final statuses: each fixture reaches its escapes and halts
K2_FINAL = {"mcopy": [1, 1, 5, 1], "copies": [1, 1, 1, 5, 1, 5],
            "return": [2, 5, 3, 5, 2], "sload_two": [1, 1],
            "sstore_free": [1, 1, 1, 0], "full": [5, 1, 5],
            "arith": [1, 0] * 10, "forced": [6, 5, 6, 5, 5, 5, 5, 5, 5],
            "sha3": [1, 1, 1, 1, 1, 1, 1, 5, 5, 5, 5, 1, 4, 5, 6, 1]}

K2_HAZARDS = {"mcopy": _k2_mcopy, "copies": _k2_copies, "return": _k2_return,
              "sload_two": _k2_sload_two, "sstore_free": _k2_sstore_free,
              "full": _k2_full, "arith": _k2_arith, "forced": _k2_forced,
              "sha3": _k2_sha3}


@pytest.mark.parametrize("case", sorted(K2_HAZARDS))
def test_host_evm_step_hazards_match_twin(on_host, monkeypatch, case):
    """K2 (a block a lane) against `step_reference` after every step on
    one fixture per parity hazard: MCOPY overlapping both ways across the
    old msize, 512-byte copies past the buffer and past M, RETURN of R and
    R + 1 bytes, SLOAD/TLOAD over two matching slots, SSTORE/TSTORE with a
    free slot before the match, full tables, the heavy families beside
    PUSH/JUMPI lanes, forced escape and fork lanes, and K1's step form
    (a block of a warp a lane, as its launch records it) on SHA3 lanes at
    the padding boundaries, across msize and past the row."""
    monkeypatch.setattr(ops, "_K2_PLANS", ops._Plans(limit=16))
    plain, masks, steps = K2_HAZARDS[case]()
    kernel = convert.clone(plain)
    for step in range(steps):
        forced = masks[step] if masks else (None, None)
        plain = tl.step_reference(plain, *forced)
        ops.evm_step(kernel, *forced)
        _same(kernel, plain, f"{case} step {step}")
    assert plain.status.tolist() == K2_FINAL[case]
    assert ops.evm_step_grid() == (len(K2_FINAL[case]), 32)  # a block a lane
    assert ops.keccak_step_grid() == (len(K2_FINAL[case]), 32)
    if case == "sha3":  # K1 hashed exactly the lanes that may commit a SHA3
        digest = ops._K2_PLANS.get(list(kernel) + list(masks[3]), (False, False),
                                   lambda: None)[1]
        skipped = [9, 10, len(SHA3_LANES) - 3, len(SHA3_LANES) - 2]
        assert [bool(row.any()) for row in digest] == [
            lane not in skipped for lane in range(len(SHA3_LANES))]
    if case == "sstore_free":  # match over an earlier free slot, else the free
        assert [int(np.nonzero(plain.storage_vals[lane, :, 0] == v)[0][0])
                for lane, v in ((0, 0xAB), (1, 0xCD), (2, 0xEF))] == [45, 3, 33]
        assert [int(plain.tstore_vals[3, slot, 0]) for slot in (5, 6)] \
            == [0x22, 0x11]


# ---- K7: one copy plan, one flat buffer a gather ------------------------------------

def _k7_lanes():
    from test_torch_symstep import CODES as codes

    state, planes, arena = seed_frontier(codes, 8, base_sym=[0])
    sched = jsym.new_scheduler(state, planes, 4, 6)
    tree = [to_port(k, t) for k, t in zip(("state", "planes", "arena", "sched"),
                                          (state, planes, arena, sched))]
    state, planes = ts.run_chunk_reference(*tree, 12)[:2]
    state.pc.copy_(torch.arange(8, dtype=torch.int32) * 7)  # distinct rows
    return state, planes


@pytest.mark.parametrize("case", ["clamped", "dropped", "no_alias", "views"])
def test_host_gather_scatter_rows(on_host, case):
    """K7 against its twins: a gather with negative and past-the-end
    indices (clamped), a scatter with dropped pads, two gathers whose
    results do not alias, and leaf views that are contiguous, carry the
    twin's dtypes and shapes and lie in one buffer."""
    from mythril_tpu_torch.parallel import frontier as tf

    state, planes = _k7_lanes()
    index = torch.tensor([-3, 0, 7, 100, 5, 2], dtype=torch.int32)
    got = ops.gather_rows(state, planes, index)
    ref = tf.gather_rows_reference(state, planes, index)
    _same(got[0], ref[0], "gather state")
    _same(got[1], ref[1], "gather planes")
    leaves = list(got[0]) + list(got[1])
    if case == "clamped":
        flat, plan = ops.gather_rows_flat(state, planes, index)
        assert flat.dtype == torch.uint8 and flat.numel() == plan.total
        assert plan.blocks == index.shape[0] * (plan.items.shape[0] - 1)
    elif case == "dropped":
        target = torch.tensor([2, 8, -1, 5, 1000, 0], dtype=torch.int32)
        plain = [convert.clone(t) for t in (state, planes)]
        kernel = [convert.clone(t) for t in (state, planes)]
        tf.scatter_rows_reference(*plain, target, *ref)
        ops.scatter_rows(*kernel, target, *got)
        _same(kernel[0], plain[0], "scatter state")
        _same(kernel[1], plain[1], "scatter planes")
        kernel = [convert.clone(t) for t in (state, planes)]
        ops.scatter_rows(*kernel, target, *ref)  # separate leaves
        _same(kernel[0], plain[0], "scatter separate leaves")
    elif case == "no_alias":
        again = ops.gather_rows(state, planes, index)
        spans = [(leaf.data_ptr(), leaf.data_ptr() + leaf.numel()
                  * leaf.element_size()) for leaf in leaves]
        for leaf in list(again[0]) + list(again[1]):
            start = leaf.data_ptr()
            assert all(not lo <= start < hi for lo, hi in spans)
        for leaf in leaves:
            leaf.zero_()
        _same(again[0], ref[0], "second gather state")
        _same(again[1], ref[1], "second gather planes")
    else:
        base = leaves[0].untyped_storage().data_ptr()
        for leaf, twin in zip(leaves, list(ref[0]) + list(ref[1])):
            assert leaf.is_contiguous() and leaf.dtype == twin.dtype
            assert leaf.shape == twin.shape
            assert leaf.untyped_storage().data_ptr() == base
            assert leaf.data_ptr() % 16 == 0
        with pytest.raises(ValueError):
            ops.scatter_rows(state, planes, index, *ref[::-1])
