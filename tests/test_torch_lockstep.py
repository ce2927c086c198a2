"""The port's concrete lockstep step (mythril_tpu_torch.parallel.lockstep)
against the JAX package's, lane for lane and exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, np_tree, to_port
from mythril_tpu.frontends.asm import assemble
from mythril_tpu.parallel import batch as jbatch
from mythril_tpu.parallel import lockstep as jlock
from mythril_tpu_torch.parallel import batch as tbatch
from mythril_tpu_torch.parallel import convert
from mythril_tpu_torch.parallel import lockstep as tlock

from chip_smoke import BENCH_GEOMETRY, BENCH_LOOP, mixed_specs

M = (1 << 256) - 1


def _mixed_specs(n_lanes):
    """chip_smoke's mixed program lanes, as the JAX package's LaneSpecs."""
    return [jbatch.LaneSpec(**vars(spec)) for spec in mixed_specs(n_lanes)]


def _port_specs(specs):
    return [tbatch.LaneSpec(**vars(spec)) for spec in specs]


@pytest.mark.parametrize("geometry", [{}, BENCH_GEOMETRY])
def test_build_batch_byte_identical(geometry):
    specs = _mixed_specs(4) + [jbatch.LaneSpec(
        code=BENCH_LOOP, storage={1: 2, 3: M}, gas_limit=2 ** 70)]
    ref = jbatch.build_batch(specs, **geometry)
    got = tbatch.build_batch(_port_specs(specs), device="cpu", **geometry)
    assert_same(ref, got)


def test_mixed_program_matches_jax():
    specs = _mixed_specs(16)
    ref = jlock.run(jbatch.build_batch(specs), max_steps=256, chunk=32)
    got = tlock.run(tbatch.build_batch(_port_specs(specs), device="cpu"),
                    max_steps=256, chunk=32)
    assert_same(ref, got)
    status = np.asarray(ref.status)
    assert np.all(status == jbatch.RETURNED), status
    assert int(np.asarray(ref.retdata_len)[0]) == 0x24
    for lane in (0, 1, 5):
        assert tbatch.extract_storage(got, lane) == \
            jbatch.extract_storage(ref, lane)
        assert tbatch.extract_stack(got, lane) == jbatch.extract_stack(ref, lane)
        assert tbatch.extract_retdata(got, lane) == \
            jbatch.extract_retdata(ref, lane)


@pytest.mark.parametrize("lanes,requested", [(8, 1), (8, 2), (8, 3), (8, 16)])
def test_shard_count_matches_jax(lanes, requested):
    assert tbatch.shard_count(lanes, requested) == \
        jbatch.shard_count(lanes, requested)


def test_bench_loop_matches_jax_every_chunk():
    specs = [jbatch.LaneSpec(BENCH_LOOP, gas_limit=2 ** 60 + lane * 997)
             for lane in range(8)]
    ref = jbatch.build_batch(specs, **BENCH_GEOMETRY)
    got = to_port("state", ref)
    for _ in range(3):
        ref = jlock.step_many(ref, 20)
        got = tlock.step_many(got, 20)
        assert_same(ref, got)


def test_out_of_gas_and_capacity_escapes_match_jax():
    """Lanes that run out of gas, overflow the memory capacity or the
    return buffer, and an invalid jump: statuses and untouched state."""
    programs = [
        assemble("PUSH1 0x01\nPUSH2 0x1000\nMSTORE\nSTOP"),      # mem escape
        assemble("PUSH1 0x01\nPUSH1 0x00\nMSTORE\nSTOP"),        # fine
        assemble("PUSH2 0x0300\nPUSH1 0x00\nRETURN"),            # ret escape
        assemble("PUSH1 0x03\nJUMP\nSTOP"),                      # bad jump
        assemble("PUSH4 0xffffffff\nMLOAD"),                     # mem oog
        BENCH_LOOP,
    ]
    specs = [jbatch.LaneSpec(code, gas_limit=40 if i == 5 else 10_000)
             for i, code in enumerate(programs)]
    ref = jlock.run(jbatch.build_batch(specs, retdata_bytes=512),
                    max_steps=64, chunk=8)
    got = tlock.run(tbatch.build_batch(_port_specs(specs), device="cpu",
                                       retdata_bytes=512),
                    max_steps=64, chunk=8)
    assert_same(ref, got)
    assert set(np.asarray(ref.status).tolist()) >= {
        jbatch.ESCAPED, jbatch.ERRORED, jbatch.STOPPED}


def test_force_escape_and_force_fork_freeze_lanes():
    specs = _mixed_specs(6)
    ref = jlock.run(jbatch.build_batch(specs), max_steps=24, chunk=24,
                    escape_on_budget=False)
    got = to_port("state", ref)
    force_escape = np.array([1, 0, 0, 1, 0, 0], dtype=bool)
    force_fork = np.array([0, 1, 0, 0, 0, 1], dtype=bool)
    ref_next = jax.jit(jlock.step)(ref, jnp.asarray(force_escape),
                                   jnp.asarray(force_fork))
    got_next = tlock.step(got, torch.from_numpy(force_escape),
                          torch.from_numpy(force_fork))
    assert_same(ref_next, got_next)
    status = np.asarray(ref_next.status)
    assert status[0] == jbatch.ESCAPED and status[1] == jbatch.FORKING


@pytest.mark.parametrize("case", [
    ([4, 6], [True, True], [4, 4]),     # ends exactly at capacity / past it
    ([0, 0], [False, True], None),      # masked-off lane writes nothing
    ([-2, 7], [True, True], [3, 1]),    # negative offset, one byte left
])
def test_mem_write_capacity_boundary(case):
    """Masked and out-of-capacity bytes are dropped, never clipped onto the
    last cell (the JAX package's capacity-boundary case)."""
    offsets, mask, size = case
    memory = np.full((2, 8), 0xAA, dtype=np.uint8)
    data = np.tile(np.arange(1, 5, dtype=np.uint8), (2, 1))
    ref = jlock._mem_write(jnp.asarray(memory), jnp.asarray(mask),
                           jnp.asarray(offsets), jnp.asarray(data),
                           size=None if size is None else jnp.asarray(size))
    got = tlock.mem_write(torch.from_numpy(memory), torch.tensor(mask),
                          torch.tensor(offsets), torch.from_numpy(data),
                          size=None if size is None else torch.tensor(size))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_state_round_trip_keeps_dtypes():
    ref = jbatch.build_batch(_mixed_specs(3))
    back = convert.to_numpy(to_port("state", ref))
    for name, leaf in convert.leaves(np_tree(ref)):
        got = getattr(back, name)
        assert got.dtype == leaf.dtype and got.tobytes() == leaf.tobytes()
