"""The port stands alone: no module of mythril_tpu_torch, nothing that
chip_smoke.py imports and no tool of the port (tools/torch_*.py) loads jax
or anything of mythril_tpu (the SMT façade, the host solver stack, the host
engine, the plugins, detectors, analyzer and CLI, the superoptimizer, the
concolic driver, the extension discovery, the serving tier, the JSON-RPC
client and the Solidity front end included); its entry points run on the
card unless asked for the CPU."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

_CHECK = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
import mythril_tpu_torch
for info in pkgutil.walk_packages(mythril_tpu_torch.__path__,
                                  "mythril_tpu_torch."):
    importlib.import_module(info.name)
import chip_smoke  # its imports only: main() runs under __main__
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "mythril_tpu" or m.startswith("mythril_tpu."))
print("LOADED", len([m for m in sys.modules
                     if m.startswith("mythril_tpu_torch")]))
print("FRONTIER", "mythril_tpu_torch.parallel.frontier" in sys.modules)
print("SAT", all(m in sys.modules for m in (
    "mythril_tpu_torch.parallel.device_solver", "mythril_tpu_torch.smt.terms",
    "mythril_tpu_torch.smt.smtlib", "mythril_tpu_torch.smt.solver.simplify",
    "mythril_tpu_torch.smt.solver.preprocess",
    "mythril_tpu_torch.smt.solver.bitblast",
    "mythril_tpu_torch.smt.solver.solver_statistics")))
print("SOLVER", all(m in sys.modules for m in (
    "mythril_tpu_torch.smt.solver.solver",
    "mythril_tpu_torch.smt.solver.incremental",
    "mythril_tpu_torch.smt.solver.sat",
    "mythril_tpu_torch.smt.solver.independence_solver",
    "mythril_tpu_torch.support.model", "mythril_tpu_torch.support.resilience",
    "mythril_tpu_torch.observe.trace", "mythril_tpu_torch.native")))
print("CORE", all(m in sys.modules for m in (
    "mythril_tpu_torch.core.svm", "mythril_tpu_torch.core.instructions",
    "mythril_tpu_torch.core.natives", "mythril_tpu_torch.core.call",
    "mythril_tpu_torch.core.cheat_code", "mythril_tpu_torch.core.node",
    "mythril_tpu_torch.core.util", "mythril_tpu_torch.core.state.global_state",
    "mythril_tpu_torch.core.state.world_state",
    "mythril_tpu_torch.core.state.machine_state",
    "mythril_tpu_torch.core.state.calldata",
    "mythril_tpu_torch.core.state.transient_storage",
    "mythril_tpu_torch.core.function_managers.keccak_function_manager",
    "mythril_tpu_torch.core.transaction.symbolic",
    "mythril_tpu_torch.core.transaction.concolic",
    "mythril_tpu_torch.core.strategy.bounded_loops",
    "mythril_tpu_torch.core.strategy.beam",
    "mythril_tpu_torch.core.strategy.constraint_strategy",
    "mythril_tpu_torch.core.plugin.signals",
    "mythril_tpu_torch.support.loader", "mythril_tpu_torch.utils.helpers",
    "mythril_tpu_torch.utils.secp256k1")))
print("ANALYSIS", all(m in sys.modules for m in (
    "mythril_tpu_torch.__main__", "mythril_tpu_torch.interfaces.cli",
    "mythril_tpu_torch.mythril.mythril_analyzer",
    "mythril_tpu_torch.mythril.mythril_disassembler",
    "mythril_tpu_torch.mythril.mythril_config",
    "mythril_tpu_torch.analysis.symbolic", "mythril_tpu_torch.analysis.report",
    "mythril_tpu_torch.analysis.solver", "mythril_tpu_torch.analysis.security",
    "mythril_tpu_torch.analysis.callgraph",
    "mythril_tpu_torch.analysis.traceexplore",
    "mythril_tpu_torch.analysis.module.loader",
    "mythril_tpu_torch.analysis.modules.suicide",
    "mythril_tpu_torch.analysis.modules.integer",
    "mythril_tpu_torch.core.plugin.loader",
    "mythril_tpu_torch.core.plugin.plugins.summary",
    "mythril_tpu_torch.core.plugin.plugins.state_merge",
    "mythril_tpu_torch.core.strategy.concolic",
    "mythril_tpu_torch.core.tx_prioritiser",
    "mythril_tpu_torch.frontends.features",
    "mythril_tpu_torch.observe.metrics",
    "mythril_tpu_torch.superopt.engine", "mythril_tpu_torch.superopt.rules",
    "mythril_tpu_torch.concolic.find_trace",
    "mythril_tpu_torch.concolic.concolic_execution",
    "mythril_tpu_torch.plugin.loader", "mythril_tpu_torch.plugin.discovery",
    "mythril_tpu_torch.ethereum", "mythril_tpu_torch.ethereum.rpc",
    "mythril_tpu_torch.frontends.solidity")))
print("SERVE", all(m in sys.modules for m in (
    "mythril_tpu_torch.serve", "mythril_tpu_torch.serve.protocol",
    "mythril_tpu_torch.serve.admission", "mythril_tpu_torch.serve.autoscale",
    "mythril_tpu_torch.serve.client", "mythril_tpu_torch.serve.daemon",
    "mythril_tpu_torch.serve.http_shim", "mythril_tpu_torch.serve.quarantine",
    "mythril_tpu_torch.serve.result_store", "mythril_tpu_torch.serve.service",
    "mythril_tpu_torch.serve.supervisor", "mythril_tpu_torch.serve.warmset",
    "mythril_tpu_torch.serve.worker", "mythril_tpu_torch.serve.forkserver")))
print("BAD", bad)
"""


def test_port_and_smoke_import_no_jax():
    proc = subprocess.run([sys.executable, "-c", _CHECK.format(repo=REPO)],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout
    loaded = int(proc.stdout.split("LOADED")[1].split()[0])
    assert loaded >= 16 and "FRONTIER True" in proc.stdout
    assert "SAT True" in proc.stdout
    assert "SOLVER True" in proc.stdout
    assert "CORE True" in proc.stdout
    assert "ANALYSIS True" in proc.stdout
    assert "SERVE True" in proc.stdout


#: the port's tools beside the JAX package's: each imports only the port
PORT_TOOLS = ("tools.torch_cfaview", "tools.torch_loadgen",
              "tools.torch_load_smoke", "tools.torch_serve_smoke",
              "tools.torch_chaos_smoke", "tools.torch_warm_smoke")

_BLOCKED = r"""
import importlib, sys
sys.path.insert(0, {repo!r})


class Blocked:
    def find_spec(self, name, path=None, target=None):
        if name in ("jax", "jaxlib", "mythril_tpu") \
                or name.startswith(("jax.", "jaxlib.", "mythril_tpu.")):
            raise ImportError(f"blocked: {{name}}")
        return None


sys.meta_path.insert(0, Blocked())
for name in {tools!r}:
    importlib.import_module(name)
print("IMPORTED", len({tools!r}))
"""


def test_port_tools_import_with_jax_blocked():
    """The tools/torch_*.py files import with jax and mythril_tpu blocked
    in the process."""
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED.format(repo=REPO, tools=PORT_TOOLS)],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"IMPORTED {len(PORT_TOOLS)}" in proc.stdout


def test_entry_points_default_to_cuda():
    from mythril_tpu_torch import device
    from mythril_tpu_torch.parallel import (arena, batch, device_solver,
                                            frontier, symstep)

    assert device.resolve("cpu").type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    spec = batch.LaneSpec(code=b"\x00")
    with pytest.raises(RuntimeError):
        batch.build_batch([spec])
    with pytest.raises(RuntimeError):
        arena.new_arena(16, 4)
    with pytest.raises(RuntimeError):
        symstep.SymPlanes.empty(1, 4, 32, 2)
    with pytest.raises(RuntimeError):
        frontier.DeviceFrontier(4)
    with pytest.raises(RuntimeError):
        frontier.DeviceFrontier(4, n_shards=2)
    with pytest.raises(RuntimeError):
        device_solver.solve_cnf_device([[1, 2], [-1]], 2)
    with pytest.raises(RuntimeError):
        device_solver.solve_cnf_device_batch([([[1, 2], [-1]], 2)])
    # the optimizer's proofs under --solver jax: refused before any block
    from mythril_tpu_torch.superopt import optimize_bytecode

    with pytest.raises(RuntimeError):
        optimize_bytecode("600035600202", solver="jax")
    # the K11 twin is many small ops: on one thread, as beside other test
    # processes a pool of threads per op costs it more than it gives
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert device_solver.solve_cnf_device(
            [[1, 2], [-1]], 2, device="cpu")[0] == device_solver.SAT
    finally:
        torch.set_num_threads(threads)
    assert batch.build_batch([spec], device="cpu").stack.device.type == "cpu"
    # the steal pass takes the twin for CPU tensors (K12 for CUDA ones)
    pair = batch.build_batch([spec] * 2, device="cpu")
    sched = symstep.new_scheduler(
        pair, symstep.SymPlanes.empty(2, 96, 4096, 64, device="cpu"), 2, 2,
        n_shards=2)
    assert frontier.steal_pass(pair, sched, 1, 4) is sched
