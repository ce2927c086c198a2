"""The port's symbolic frontier step (mythril_tpu_torch.parallel.symstep)
against the JAX package's, leaf for leaf and exactly.

Contracts: the KILLBILLY dispatcher and bench.py's branchy body under a
dispatcher. Pools are small enough that forks claim lanes, push siblings
onto the DFS stack and spill them into the escape buffer; between chunks
the escape count is zeroed as the frontier's drain does."""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import assert_same, seed_frontier, to_port
from mythril_tpu.frontends.asm import assemble, dispatcher
from mythril_tpu.parallel import symstep as jsym
from mythril_tpu_torch.parallel import convert
from mythril_tpu_torch.parallel import symstep as tsym

from chip_smoke import PLANES_SOURCE
from test_analysis import KILLBILLY

N_LANES = 8
CHUNK = 12
N_CHUNKS = 7


def _branchy(n_branches):
    lines = []
    for i in range(n_branches):
        lines += [f"PUSH2 {hex(4 + 32 * i)}", "CALLDATALOAD",
                  f"PUSH4 {hex(0x10000 + i)}", "LT", f"PUSH @l{i}", "JUMPI",
                  f"l{i}:", "JUMPDEST"]
    return "\n".join(lines + ["STOP"])


CODES = [assemble(dispatcher(KILLBILLY)),
         assemble(dispatcher({"stress()": _branchy(4)})),
         assemble(dispatcher({"planes()": PLANES_SOURCE}))]


@pytest.fixture(scope="module")
def chunk_trace():
    """(jax, port) trees after every chunk of run_chunk from one seed."""
    state, planes, arena = seed_frontier(CODES, N_LANES, base_sym=[0])
    sched = jsym.new_scheduler(state, planes, 4, 3)
    p_state, p_planes, p_arena = (to_port("state", state),
                                  to_port("planes", planes),
                                  to_port("arena", arena))
    p_sched = to_port("sched", sched)
    trace = []
    totals = {"pushes": 0, "spills": 0, "escapes": 0}
    for _ in range(N_CHUNKS):
        state, planes, arena, sched = jsym.run_chunk(state, planes, arena,
                                                     sched, CHUNK)
        p_state, p_planes, p_arena, p_sched = tsym.run_chunk(
            p_state, p_planes, p_arena, p_sched, CHUNK)
        # the port updates the arena and the pools in place: snapshot now
        trace.append(((state, planes, arena, sched),
                      tuple(convert.clone(t) for t in
                            (p_state, p_planes, p_arena, p_sched))))
        n_esc = int(sched.esc_count)
        totals["escapes"] += n_esc
        # a spilled sibling sits in the escape buffer still RUNNING
        totals["spills"] += int(np.sum(
            np.asarray(sched.esc_state.status)[:n_esc] == 0))
        sched = sched._replace(esc_count=jnp.zeros_like(sched.esc_count))
        p_sched.esc_count.zero_()
    totals["pushes"] = int(sched.pushes)
    totals["forks"] = int(sched.forks)
    return trace, totals


@pytest.mark.parametrize("chunk", range(N_CHUNKS))
@pytest.mark.parametrize("kind", ["state", "planes", "arena", "sched"])
def test_run_chunk_matches_jax(chunk_trace, chunk, kind):
    trace, _ = chunk_trace
    index = ["state", "planes", "arena", "sched"].index(kind)
    jax_tree, port_tree = trace[chunk][0][index], trace[chunk][1][index]
    assert_same(jax_tree, port_tree, f"chunk {chunk} {kind}.")


def test_run_chunk_exercises_scheduler(chunk_trace):
    """The comparison above is only worth something if the run forked,
    pushed, spilled and escaped."""
    _, totals = chunk_trace
    assert totals["pushes"] > 0 and totals["spills"] > 0
    assert totals["forks"] > totals["pushes"] + totals["spills"]  # claims
    assert totals["escapes"] > totals["spills"]


def test_sym_step_many_matches_jax():
    state, planes, arena = seed_frontier(CODES, N_LANES, base_sym=[0])
    p = (to_port("state", state), to_port("planes", planes),
         to_port("arena", arena))
    j_out = jsym.sym_step_many(state, planes, arena, 24)
    p_out = tsym.sym_step_many(*p, 24)
    for kind, jt, pt in zip(("state", "planes", "arena"), j_out, p_out):
        assert_same(jt, pt, f"{kind}.")


def test_arena_exhaustion_kills_lanes_like_jax():
    """With a tiny arena the allocations overflow: the lanes die (counted,
    never silent) exactly where the JAX step kills them."""
    state, planes, arena = seed_frontier(CODES, N_LANES, base_sym=[0],
                                         arena_capacity=24, const_capacity=8)
    p = (to_port("state", state), to_port("planes", planes),
         to_port("arena", arena))
    j_out = jsym.sym_step_many(state, planes, arena, 30)
    p_out = tsym.sym_step_many(*p, 30)
    for kind, jt, pt in zip(("state", "planes", "arena"), j_out, p_out):
        assert_same(jt, pt, f"{kind}.")
    assert int(np.asarray(j_out[2].n)) == 24


def test_sym_step_many_counted_matches_jax():
    state, planes, arena = seed_frontier(CODES[1:], N_LANES)
    p = (to_port("state", state), to_port("planes", planes),
         to_port("arena", arena))
    *_, executed = jsym.sym_step_many_counted(state, planes, arena, 16)
    *_, p_executed = tsym.sym_step_many_counted(*p, 16)
    assert int(p_executed) == int(executed) > 0


@pytest.mark.parametrize("kind", ["state", "planes", "arena", "sched"])
def test_convert_round_trip(chunk_trace, kind):
    """to_numpy(from_numpy(x)) gives back every leaf byte for byte."""
    trace, _ = chunk_trace
    index = ["state", "planes", "arena", "sched"].index(kind)
    jax_tree = trace[-1][0][index]
    back = convert.to_numpy(to_port(kind, jax_tree))
    assert_same(jax_tree, convert.from_numpy(kind, back, device="cpu"))


def test_unported_scheduler_options_raise():
    """Sharded schedulers are not ported; the telemetry plane is, up to
    the tag and fleet slots the kernel holds."""
    state, planes, arena = seed_frontier(CODES[1:], N_LANES)
    p_state, p_planes = to_port("state", state), to_port("planes", planes)
    with pytest.raises(NotImplementedError):
        tsym.new_scheduler(p_state, p_planes, 8, 8, n_shards=2)
    tel = tsym.new_telemetry([1, 2], device="cpu")
    assert tsym.new_scheduler(p_state, p_planes, 8, 8,
                              telemetry=tel).telemetry is tel
    wide = tsym.new_telemetry(range(tsym.MAX_TEL_SLOTS + 1), device="cpu")
    sched = tsym.new_scheduler(p_state, p_planes, 8, 8, telemetry=wide)
    with pytest.raises(ValueError):
        tsym.sym_step(p_state, p_planes, to_port("arena", arena), sched)


def _drain_totals(run, state, planes, arena, sched, zero_escapes, chunk=32):
    """Chunks until no lane runs and the DFS stack is empty, draining the
    escape buffer after each chunk as the frontier does."""
    escapes = 0
    for _ in range(40):
        state, planes, arena, sched = run(state, planes, arena, sched, chunk)
        escapes += int(sched.esc_count)
        sched = zero_escapes(sched)
        status = np.asarray(state.status)
        if not np.isin(status, [0, 5, 6]).any() and int(sched.stack_top) == 0:
            break
    return {"escapes": escapes, "forks": int(sched.forks),
            "pushes": int(sched.pushes), "pops": int(sched.pops),
            "executed": int(sched.executed), "arena_n": int(arena.n)}


def test_drained_escapes_count_paths():
    """chip_smoke pins the JAX reference's totals for dispatcher(branchy(12))
    at the default geometry: one escape per path plus the dispatcher's
    fallback STOP. The same drain at branchy(3) gives 2^3 + 1 escapes on
    both sides, with every other total equal."""
    import chip_smoke

    assert chip_smoke.EXPECTED["escapes"] == 2 ** chip_smoke.N_BRANCHES + 1
    assert chip_smoke.EXPECTED["forks"] == 2 ** chip_smoke.N_BRANCHES
    code = assemble(dispatcher({"stress()": chip_smoke.branchy_contract(3)}))
    state, planes, arena = seed_frontier([code], 4, max_conds=16)
    sched = jsym.new_scheduler(state, planes, 6, 4)
    port = [to_port(k, t) for k, t in zip(("state", "planes", "arena", "sched"),
                                          (state, planes, arena, sched))]
    ref = _drain_totals(
        jsym.run_chunk, state, planes, arena, sched,
        lambda s: s._replace(esc_count=jnp.zeros_like(s.esc_count)))

    def zero(s):
        s.esc_count.zero_()
        return s

    got = _drain_totals(tsym.run_chunk, *port, zero)
    assert got == ref
    assert ref["escapes"] == 2 ** 3 + 1 and ref["pushes"] > 0
