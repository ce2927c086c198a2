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
EXPECTED_HOST_ENGINE and the seams that raise."""

import pytest

from _torch_engine import (JAX, PORT, check_statespace, fresh, run_on,
                           statespace_counts)
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


def test_tpu_engine_raises_until_the_device_driver_is_ported():
    """engine="tpu" without a fleet gate needs execute_message_call_tpu
    (ROADMAP A 7): sym_exec raises before it explores anything."""
    fresh(PORT)
    laser = PORT.svm.LaserEVM(engine="tpu")
    world_state = PORT.state.WorldState()
    account = world_state.create_account(balance=1, address=None)
    with pytest.raises(NotImplementedError, match="A 7"):
        laser.sym_exec(world_state=world_state,
                       target_address=account.address.value)
    with pytest.raises(NotImplementedError, match="A 7"):
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
    frontier's checkpoint (ROADMAP A 7): a checkpoint or resume path raises
    instead of running without one."""
    with pytest.raises(NotImplementedError, match="ROADMAP A 7"):
        PORT.svm.LaserEVM(**{path: "/nonexistent/checkpoint.pkl"})
