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


def _allocate(rng, jar, tar, rounds, batch=16):
    """The same random allocation rounds on both arenas."""
    for round_ in range(rounds):
        want = rng.random(batch) < 0.6
        if round_ % 3 == 0:
            values = rng.integers(0, 1 << 16, (batch, 16), dtype=np.uint32)
            jar, *_ = ja.alloc_consts(jar, jnp.asarray(want),
                                      jnp.asarray(values))
            tar, *_ = ta.alloc_consts(tar, torch.from_numpy(want),
                                      torch.from_numpy(values.astype(np.int32)))
        else:
            n = int(np.asarray(jar.n))
            args = [rng.choice([0x01, 0x14, ja.VAR, ja.CONST], batch),
                    *[rng.integers(0, max(n, 1), batch) for _ in range(3)],
                    rng.integers(0, 40, batch), rng.integers(0, 1 << 20, batch)]
            jar, *_ = ja.alloc_rows(jar, jnp.asarray(want),
                                    *[jnp.asarray(v, dtype=jnp.int32)
                                      for v in args])
            tar, *_ = ta.alloc_rows(tar, torch.from_numpy(want),
                                    *[torch.from_numpy(v.astype(np.int32))
                                      for v in args])
    return jar, tar


@pytest.mark.parametrize("start,cstart,bucket,cbucket",
                         [(0, 0, 16, 16), (5, 3, 16, 4), (40, 10, 32, 8),
                          (63, 15, 16, 16)])  # the last two clamp their starts
def test_fetch_delta_matches_jax(start, cstart, bucket, cbucket):
    rng = np.random.default_rng(11)
    jar, tar = _allocate(rng, ja.new_arena(64, 16),
                         ta.new_arena(64, 16, device="cpu"), 5)
    rows, consts = ja._fetch_delta(jar, jnp.int32(start), jnp.int32(cstart),
                                   bucket, cbucket)
    t_rows, t_consts = ta.fetch_delta_reference(tar, start, cstart, bucket,
                                                cbucket)
    np.testing.assert_array_equal(t_rows.numpy(), np.asarray(rows))
    np.testing.assert_array_equal(t_consts.numpy().view(np.uint32),
                                  np.asarray(consts))
    assert t_rows.dtype == torch.int32 and tuple(t_rows.shape) == (6, bucket)


@pytest.mark.parametrize("capacity,const_capacity", [(64, 16), (1 << 10, 64)])
def test_host_arena_mirror_matches_jax(capacity, const_capacity):
    """Incremental refreshes after each allocation round, up to capacity
    (where the bucket's start must clamp), mirror what JAX mirrors; the
    first mirror starts empty, as the frontier's first drain makes it."""
    rng = np.random.default_rng(capacity + 1)
    jar = ja.new_arena(capacity, const_capacity)
    tar = ta.new_arena(capacity, const_capacity, device="cpu")
    j_mirror = ja.HostArena(jar, 1, 0)
    t_mirror = ta.HostArena(tar, 1, 0)
    for round_ in range(8):
        jar, tar = _allocate(rng, jar, tar, 2)
        if round_ % 2:
            j_mirror.refresh(jar)
            t_mirror.refresh(tar)
        else:  # the drain's way: launch now, land later
            j_handle = j_mirror.refresh_async(jar, int(np.asarray(jar.n)),
                                              int(np.asarray(jar.n_const)))
            t_handle = t_mirror.refresh_async(tar, int(tar.n),
                                              int(tar.n_const))
            j_mirror.refresh_apply(j_handle)
            t_mirror.refresh_apply(t_handle)
        assert (t_mirror.n, t_mirror.n_const) == (j_mirror.n,
                                                  j_mirror.n_const)
        for col in ta.ROW_COLS + ("const_vals",):
            ref, got = getattr(j_mirror, col), getattr(t_mirror, col)
            assert got.dtype == ref.dtype and np.array_equal(got, ref), col
    assert t_mirror.n == int(tar.n)
    node = t_mirror.n - 1
    assert t_mirror.var_classes(node) == j_mirror.var_classes(node)


def test_host_arena_refuses_stale_handles():
    rng = np.random.default_rng(5)
    jar, tar = _allocate(rng, ja.new_arena(1 << 10, 64),
                         ta.new_arena(1 << 10, 64, device="cpu"), 2)
    mirror = ta.HostArena(tar)
    _, tar = _allocate(rng, jar, tar, 1)
    stale = mirror.refresh_async(tar)
    _, tar = _allocate(rng, jar, tar, 2)
    mirror.refresh(tar)
    with pytest.raises(ValueError, match="out of order"):
        mirror.refresh_apply(stale)
