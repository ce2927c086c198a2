"""Shared helpers for the tests that hold mythril_tpu_torch against mythril_tpu.

The JAX side runs on the CPU as the JAX package's own tests run it; the
port side runs its plain PyTorch twins with device="cpu". State crosses
between the two as numpy arrays (`convert.from_numpy` / `to_numpy`), and
every comparison is exact: every leaf, dtype and shape included."""

import jax
import numpy as np

import mythril_tpu.parallel  # noqa: F401  (switches on x64 before any jnp use)
from mythril_tpu.parallel import arena as jarena
from mythril_tpu.parallel import batch as jbatch
from mythril_tpu.parallel import symstep as jsym
from mythril_tpu_torch.parallel import convert

#: small frontier geometry for CPU tests (the default is 96/4096/512/512/64/8)
SMALL = dict(stack_slots=16, memory_bytes=256, calldata_bytes=256,
             retdata_bytes=64, storage_slots=8, tstore_slots=2)


def np_tree(tree):
    """JAX pytree -> the same pytree with numpy leaves."""
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_same(jax_tree, port_tree, what=""):
    """Every leaf of the JAX tree equals the port's, dtype and shape too."""
    expected = np_tree(jax_tree)
    got = convert.to_numpy(port_tree)
    names = list(convert.leaves(got))
    exp = dict(convert.leaves(expected))
    assert set(exp) == {n for n, _ in names}, what
    for name, leaf in names:
        ref = exp[name]
        assert leaf.dtype == ref.dtype, f"{what}{name}: {leaf.dtype} != {ref.dtype}"
        assert leaf.shape == ref.shape, f"{what}{name}: {leaf.shape} != {ref.shape}"
        if not np.array_equal(leaf, ref):
            diff = np.argwhere(leaf != ref)[:5]
            raise AssertionError(f"{what}{name} differs at {diff.tolist()}")


def seed_frontier(codes, n_lanes, base_sym=(), max_conds=8,
                  arena_capacity=1 << 12, const_capacity=1 << 8, **geometry):
    """JAX-side frontier seeding as frontier.seed does it: one RUNNING lane
    per code with symbolic env, the other lanes DEAD fillers."""
    geometry = {**SMALL, **geometry}
    specs = [jbatch.LaneSpec(code=code, gas_limit=10_000_000) for code in codes]
    specs += [jbatch.LaneSpec(code=b"\x00")] * (n_lanes - len(codes))
    state = jbatch.build_batch(specs, **geometry)
    status = np.full(n_lanes, jbatch.DEAD, dtype=np.int32)
    status[:len(codes)] = jbatch.RUNNING
    state = state._replace(status=np.asarray(status))
    planes = jsym.SymPlanes.empty(n_lanes, geometry["stack_slots"],
                                  geometry["memory_bytes"],
                                  geometry["storage_slots"], max_conds)
    storage_base_sym = np.zeros(n_lanes, dtype=bool)
    storage_base_sym[list(base_sym)] = True
    ctx_id = np.full(n_lanes, -1, dtype=np.int32)
    ctx_id[:len(codes)] = np.arange(len(codes))
    planes = planes._replace(storage_base_sym=np.asarray(storage_base_sym),
                             ctx_id=np.asarray(ctx_id))
    arena = jarena.new_arena(arena_capacity, const_capacity)
    return state, planes, arena


def to_port(kind, tree):
    return convert.from_numpy(kind, np_tree(tree), device="cpu")


def jax_static_tables(codes):
    """The static tables the JAX frontier builds for contexts running
    `codes` from the CFA / absint / taint analysis of `Disassembly(code)`:
    (tag_pcs, tag_names) as `_Frontier._collect_tag_pcs` and (merge_pcs,
    merge_names, mem_pcs, mem_words) as `_Frontier._merge_pc_table`."""
    from types import SimpleNamespace

    from mythril_tpu.frontends.disassembler import Disassembly
    from mythril_tpu.parallel import frontier as jf

    frontier = jf._Frontier(laser_evm=None, n_lanes=2)
    frontier.contexts = [SimpleNamespace(template=SimpleNamespace(
        environment=SimpleNamespace(code=Disassembly(code.hex()))))
        for code in codes]
    return frontier._collect_tag_pcs(), frontier._merge_pc_table()
