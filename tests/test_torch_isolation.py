"""The port stands alone: no module of mythril_tpu_torch, and nothing that
chip_smoke.py imports, loads jax or anything of mythril_tpu; its entry
points run on the card unless asked for the CPU."""

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
    assert device_solver.solve_cnf_device([[1, 2], [-1]], 2,
                                          device="cpu")[0] == device_solver.SAT
    assert batch.build_batch([spec], device="cpu").stack.device.type == "cpu"
    # the steal pass takes the twin for CPU tensors (K12 for CUDA ones)
    pair = batch.build_batch([spec] * 2, device="cpu")
    sched = symstep.new_scheduler(
        pair, symstep.SymPlanes.empty(2, 96, 4096, 64, device="cpu"), 2, 2,
        n_shards=2)
    assert frontier.steal_pass(pair, sched, 1, 4) is sched
