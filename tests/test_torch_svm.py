"""The port's LaserEVM (mythril_tpu_torch/core/svm.py) against the JAX
package's: the same worklist symbolic execution, from the same numbering,
gives the same statespace.

For KILLBILLY (tests/test_analysis.py) in a dispatcher, in creation mode
(`sym_exec(creation_code=)`) and runtime mode (the world state
SymExecWrapper builds), with 1 and 2 transactions, under DFS and BFS:
total_states, the nodes by uid with their start address, function name
and flags, the edges, the open states after each transaction, and for
each open state in order its storage writes (symbolic values as sorted
tokens), constraint count, `is_possible()` verdict and `get_model`'s
caller and calldata values (equal where the two packages blasted the same
clause pool, as they do in a fresh process; after other tests in the same
process the pools' order can differ, and each model is then held to its
own path constraints). Budgets are ones neither side reaches
(`timed_out` is False on both). tests/test_torch_statespace.py does the
same for branchy(6); this file also holds chip_smoke.py's
EXPECTED_HOST_ENGINE, `engine="tpu"` through the device driver on the
CPU configuration (and its refusal without a card), and the seams that
raise."""

import pytest

from _torch_engine import (BUDGET_S, CONTRACTS, JAX, PORT, check_statespace,
                           fresh, run_on, statespace_counts)
from chip_smoke import EXPECTED_HOST_ENGINE, HOST_ENGINE_RUNS, host_engine_run



@pytest.mark.parametrize("strategy", ["dfs", "bfs"])
@pytest.mark.parametrize("transaction_count", [1, 2])
@pytest.mark.parametrize("mode", ["creation", "runtime"])
def test_killbilly_statespace(mode, transaction_count, strategy):
    check_statespace("killbilly", mode, transaction_count, strategy)


def test_chip_smoke_constants_are_the_jax_statespace():
    """chip_smoke.py's host_engine phase holds the port's runs to
    EXPECTED_HOST_ENGINE: the JAX package's LaserEVM gives those counts,
    and the phase's own run of the port's (`host_engine_run`, which raises
    on a difference) gives them too."""
    for contract, transaction_count in HOST_ENGINE_RUNS:
        for mode in ("creation", "runtime"):
            want = run_on(JAX, statespace_counts, contract, mode,
                          transaction_count)
            assert want == EXPECTED_HOST_ENGINE[contract][mode]
            got = run_on(PORT, lambda _side: host_engine_run(
                contract, mode, transaction_count))
            assert got["states"] == want["states"]


def tpu_explore(side) -> dict:
    """KILLBILLY's creation and two transactions through
    `LaserEVM(engine="tpu")` (the device driver at 16 lanes)."""
    runtime = side.asm.assemble(side.asm.dispatcher(CONTRACTS["killbilly"]))
    laser = side.svm.LaserEVM(max_depth=128, execution_timeout=BUDGET_S,
                              create_timeout=BUDGET_S, transaction_count=2,
                              engine="tpu")
    laser.sym_exec(creation_code=side.asm.creation_wrapper(runtime).hex(),
                   contract_name="killbilly")
    return {"states": laser.total_states, "nodes": len(laser.nodes),
            "open": len(laser.open_states), "forks": laser.frontier_forks,
            "lane_steps": laser.frontier_lane_steps,
            "timed_out": laser.timed_out}


def test_tpu_engine_explores_on_the_cpu_configuration(monkeypatch):
    """engine="tpu" hands each message call to the device driver; with
    `frontier.configure(device="cpu")` it runs the plain twins and explores
    as the JAX package's LaserEVM(engine="tpu") does."""
    from mythril_tpu_torch.parallel import frontier

    monkeypatch.setenv("MYTHRIL_TPU_LANES", "16")
    frontier.configure(lanes=16, device="cpu")
    try:
        got = run_on(PORT, tpu_explore)
    finally:
        frontier.reset()
    assert got == run_on(JAX, tpu_explore)
    assert got["forks"] > 0 and got["open"] > 0 and not got["timed_out"]


def test_tpu_engine_without_a_card_raises():
    """Without a card and without `frontier.configure`, sym_exec raises
    `device.resolve`'s error before it explores anything: never a run on
    the host or the CPU in its place."""
    import torch

    from mythril_tpu_torch.exceptions import DeviceUnavailable

    if torch.cuda.is_available():
        pytest.skip("a card is present: the device driver runs on it")
    fresh(PORT)
    laser = PORT.svm.LaserEVM(engine="tpu")
    world_state = PORT.state.WorldState()
    account = world_state.create_account(balance=1, address=None)
    with pytest.raises(DeviceUnavailable, match="CUDA"):
        laser.sym_exec(world_state=world_state,
                       target_address=account.address.value)
    with pytest.raises(DeviceUnavailable, match="CUDA"):
        laser.sym_exec(creation_code="00", contract_name="x")
    assert laser.total_states == 0 and laser.nodes == {}
    assert laser.open_states == []


def test_fleet_gate_seam_stays():
    """A fleet member's laser (engine "tpu" with a `fleet_gate`) hands
    each transaction to the gate, as the reference's does."""
    fresh(PORT)
    laser = PORT.svm.LaserEVM(engine="tpu", transaction_count=2)
    calls = []
    laser.fleet_gate = lambda evm, address, func_hashes: calls.append(
        (evm, address.value, func_hashes))
    world_state = PORT.state.WorldState()
    account = world_state.create_account(balance=1, address=None)
    laser.sym_exec(world_state=world_state,
                   target_address=account.address.value)
    assert calls == [(laser, account.address.value, None)] * 2
    fresh(PORT)


@pytest.mark.parametrize("path", ["checkpoint_path", "resume_path"])
def test_checkpoints_raise_until_the_detectors_are_ported(path):
    """support/checkpoint.py pickles the worklist beside the device
    frontier's checkpoint (ROADMAP A 7b): a checkpoint or resume path
    raises instead of running without one."""
    with pytest.raises(NotImplementedError, match="ROADMAP A 7b"):
        PORT.svm.LaserEVM(**{path: "/nonexistent/checkpoint.pkl"})
