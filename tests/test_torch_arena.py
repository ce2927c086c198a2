"""The port's arena allocation twins against the JAX package's: the same
allocation sequence, up to and past capacity, gives identical leaves and
ids."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, to_port
from mythril_tpu.parallel import arena as ja
from mythril_tpu_torch.parallel import arena as ta


@pytest.mark.parametrize("capacity,const_capacity", [(64, 16), (1 << 10, 64)])
def test_allocation_sequence_matches_jax(capacity, const_capacity):
    rng = np.random.default_rng(capacity)
    batch = 16
    jar = ja.new_arena(capacity, const_capacity)
    tar = to_port("arena", jar)
    overflowed = False
    for round_ in range(12):
        want = rng.random(batch) < 0.6
        if round_ % 3 == 0:
            values = rng.integers(0, 1 << 16, (batch, 16), dtype=np.uint32)
            jar, jids, jovf = ja.alloc_consts(jar, jnp.asarray(want),
                                              jnp.asarray(values))
            tar, tids, tovf = ta.alloc_consts(
                tar, torch.from_numpy(want),
                torch.from_numpy(values.astype(np.int32)))
        else:
            n = int(np.asarray(jar.n))
            op = rng.choice([0x01, 0x10, 0x14, ja.VAR, ja.CONST], batch)
            kids = [rng.integers(0, max(n, 1), batch) for _ in range(3)]
            imm = rng.integers(0, 40, batch)
            imm2 = rng.integers(-5, 1 << 20, batch)
            args = [op, *kids, imm, imm2]
            jar, jids, jovf = ja.alloc_rows(jar, jnp.asarray(want),
                                            *[jnp.asarray(v, dtype=jnp.int32)
                                              for v in args])
            tar, tids, tovf = ta.alloc_rows(
                tar, torch.from_numpy(want),
                *[torch.from_numpy(v.astype(np.int32)) for v in args])
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(tovf.numpy(), np.asarray(jovf))
        assert_same(jar, tar, f"round {round_}: ")
        overflowed |= bool(np.asarray(jovf).any())
    assert overflowed == (capacity == 64)


def test_new_arena_defaults_and_device():
    jar = ja.new_arena(256, 8)
    assert_same(jar, ta.new_arena(256, 8, device="cpu"))
    with pytest.raises(RuntimeError):
        ta.new_arena(256, 8)  # the card is the default; there is none here
