"""The fleet driver: several contracts' analyses as one device workload
(port of mythril_tpu/parallel/frontier.py:2582-3001, `FleetMember`,
`FleetDriver`, `_member_env`'s driver half).

Every member's per-transaction seeds land in one shared `frontier.Frontier`
(each lane's context id keeps its owner, and K10 never merges lanes of two
contexts), the chunk loop runs once for all of them, and drained rows go
back into each member's own worklist. Host turns are strictly serial: one
member thread holds the token at a time, and the process-wide singletons
the engine leans on (the transaction id counter, the keccak function
manager, the detection modules' issues and caches, the dispatch's query
origin) are swapped a turn, so each member sees the namespace a solo run
would and its detections are a solo run's.

The coordinator (the thread that calls `FleetDriver.run`) runs every device
phase, graph captures included; a member's turn starts only after the
phase has returned, so no member thread launches a kernel while a graph is
being captured, and no thread changes the current stream. `run` resolves
the configured device (`frontier.resolve_device`) before any member's turn:
without a card it raises, and nothing explores on the host or the CPU in
its place.

The JAX driver's metrics and structured log events are counters here: on
the driver `phases`, `lane_steps`, `forks`, `chunks`, `steal_passes`,
`steal_rows`, `drained`, `device_s` and `occupancy` (lane-steps by
contract id, the JAX `frontier.fleet.lane_steps` labels); on each member
`drained` (its lanes killed by a deadline drain)."""

from __future__ import annotations

import logging
import threading
import time
import traceback
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np

from . import frontier
from .batch import DEAD, ESCAPED, FORKING, RUNNING

log = logging.getLogger(__name__)


class FleetMember:
    """One contract's analysis job inside a fleet (frontier.py:2619)."""

    def __init__(self, index: int, contract_id: str, work=None,
                 execution_timeout: int = 0, preempt=None):
        self.index = index
        self.contract_id = contract_id
        #: the whole analysis of the contract (SymExecWrapper and the
        #: detectors' harvest), run on this member's thread
        self.work = work
        self.execution_timeout = execution_timeout
        #: an optional threading.Event: once set, this member's budget
        #: reads as spent and the next deadline drain abandons it
        self.preempt = preempt
        self.driver: Optional["FleetDriver"] = None
        self.laser = None        # set by SymExecWrapper(fleet=member)
        self.gate_laser = None   # the laser parked at the device gate
        self.gate_seeds: Optional[list] = None
        self.result = None       # work()'s return (the member's issues)
        self.error: Optional[BaseException] = None
        self.traceback_str = ""
        self.done = False
        #: drained on the device: lanes freed, rows skipped and counted
        self.abandoned = False
        #: lanes the deadline drains killed
        self.drained = 0
        self._pending_feeder = None
        self.thread: Optional[threading.Thread] = None
        self._grant = threading.Event()
        self._yield = threading.Event()
        # this member's snapshots of the process-wide singletons
        self.tx_counter = 0
        self.keccak_state: Dict[str, object] = {}
        self.module_state: Dict[str, Dict[str, object]] = {}

    def install(self, laser_evm) -> None:
        """Attach this member to its new laser (SymExecWrapper, on the
        member's thread): its transactions go through the fleet's gate."""
        self.laser = laser_evm
        laser_evm.contract_id = self.contract_id
        laser_evm.fleet_gate = self._gate

    def _gate(self, laser_evm, callee_address, func_hashes=None) -> None:
        self.driver.gate(self, laser_evm, callee_address, func_hashes)

    def budget_remaining(self) -> float:
        """Seconds left in this member's budget: inf untimed, 0 preempted;
        else the wall since its transaction phase began against its
        execution timeout (svm's own check)."""
        if self.preempt is not None and self.preempt.is_set():
            return 0.0
        laser = self.gate_laser or self.laser
        timeout = getattr(laser, "execution_timeout", 0) if laser \
            else self.execution_timeout
        if not timeout:
            return float("inf")
        started = getattr(laser, "time", None)
        if started is None:
            return float(timeout)
        from datetime import datetime

        return timeout - (datetime.now() - started).total_seconds()

    def count_dropped(self, n: int) -> None:
        """`n` of this member's states were dropped (a deadline drain or a
        skipped row): its report becomes incomplete."""
        laser = self.gate_laser or self.laser
        if laser is None or not n:
            return
        laser.timed_out = True
        laser.dropped_states = getattr(laser, "dropped_states", 0) + n


class FleetDriver:
    """Seed, step, merge and drain several contracts in one frontier
    (frontier.py:2693).

    Each member runs its unchanged engine loop on its own thread, and one
    thread holds the token at a time. A member's turn ends when it parks
    at the device gate (its next transaction's seeds built) or finishes.
    When every live member is parked, the coordinator packs all their
    seeds into one `Frontier`, runs the device phase once, hands each a
    shared feeder and resumes the turns. A member whose budget runs out
    in a phase is drained on the device (its lanes freed, its report
    incomplete), never a global abort."""

    def __init__(self, members: List[FleetMember], modules=None):
        self.members = members
        for member in members:
            member.driver = self
        self.modules = modules
        self.aborted = False
        self.frontier: Optional[frontier.Frontier] = None
        #: cumulative device counters over the phases
        self.phases = 0
        self.lane_steps = 0
        self.forks = 0
        self.chunks = 0
        self.steal_passes = 0
        self.steal_rows = 0
        self.drained = 0
        self.device_s = 0.0
        #: running lane-steps by contract id (the telemetry's fleet block)
        self.occupancy: Dict[str, int] = {}
        self._active: Optional[FleetMember] = None
        self._all_modules = None

    # -- the singletons' swap ---------------------------------------------------------

    def _module_list(self):
        if self._all_modules is None:
            from ..analysis.module import ModuleLoader
            from ..analysis.module.base import EntryPoint

            loader = ModuleLoader()
            self._all_modules = (
                loader.get_detection_modules(entry_point=EntryPoint.CALLBACK)
                + loader.get_detection_modules(entry_point=EntryPoint.POST))
        return self._all_modules

    def _swap_in(self, member: FleetMember) -> None:
        """Install `member`'s view of the process-wide singletons: the
        transaction id counter, the keccak function manager, every
        detection module's issues and cache, and the query origin. A
        member's first snapshot is a fresh reset, as a solo run's."""
        from ..core.function_managers import keccak_function_manager
        from ..core.transaction.transaction_models import tx_id_manager
        from ..smt.solver import dispatch

        tx_id_manager.set_counter(member.tx_counter)
        if not member.keccak_state:
            fresh = type(keccak_function_manager)()
            member.keccak_state = dict(fresh.__dict__)
        keccak_function_manager.__dict__.clear()
        keccak_function_manager.__dict__.update(member.keccak_state)
        for module in self._module_list():
            saved = member.module_state.setdefault(
                module.name, {"issues": [], "cache": set()})
            module.issues = saved["issues"]
            module.cache = saved["cache"]
        dispatch.set_query_origin(member.contract_id)
        self._active = member

    def _swap_out(self, member: FleetMember) -> None:
        from ..core.function_managers import keccak_function_manager
        from ..core.transaction.transaction_models import tx_id_manager
        from ..smt.solver import dispatch

        member.tx_counter = tx_id_manager._next_transaction_id
        member.keccak_state = dict(keccak_function_manager.__dict__)
        for module in self._module_list():
            member.module_state[module.name] = {
                "issues": module.issues, "cache": module.cache}
        dispatch.set_query_origin(None)
        self._active = None

    @contextmanager
    def member_env(self, member: FleetMember):
        """A solver call during a device phase in `member`'s symbol
        namespace and query origin, restored on exit; a no-op for the
        member that holds the token (its live state must not be replaced
        by its own stale snapshot)."""
        if member is self._active:
            yield
            return
        from ..core.function_managers import keccak_function_manager
        from ..core.transaction.transaction_models import tx_id_manager
        from ..smt.solver import dispatch

        saved_tx = tx_id_manager._next_transaction_id
        saved_keccak = dict(keccak_function_manager.__dict__)
        saved_origin = dispatch.get_query_origin()
        tx_id_manager.set_counter(member.tx_counter)
        if not member.keccak_state:
            fresh = type(keccak_function_manager)()
            member.keccak_state = dict(fresh.__dict__)
        keccak_function_manager.__dict__.clear()
        keccak_function_manager.__dict__.update(member.keccak_state)
        dispatch.set_query_origin(member.contract_id)
        try:
            yield
        finally:
            member.tx_counter = tx_id_manager._next_transaction_id
            member.keccak_state = dict(keccak_function_manager.__dict__)
            keccak_function_manager.__dict__.clear()
            keccak_function_manager.__dict__.update(saved_keccak)
            tx_id_manager.set_counter(saved_tx)
            dispatch.set_query_origin(saved_origin)

    # -- the token and the clock --------------------------------------------------------

    def _arm_clock(self, seconds: float) -> None:
        from ..core.time_handler import time_handler

        if seconds == float("inf"):
            time_handler.reset()
        else:
            time_handler.start_execution(max(int(seconds), 1))

    def _run_turn(self, member: FleetMember) -> None:
        """Grant the token: the member runs to its next gate or its end,
        the global clock armed with its remaining budget."""
        self._swap_in(member)
        self._arm_clock(member.budget_remaining())
        member._yield.clear()
        member._grant.set()
        member._yield.wait()
        self._swap_out(member)

    # -- the member threads ---------------------------------------------------------------

    def _member_main(self, member: FleetMember) -> None:
        member._grant.wait()
        member._grant.clear()
        try:
            member.result = member.work()
        except BaseException as error:  # noqa: BLE001 (reported a member)
            member.error = error
            member.traceback_str = traceback.format_exc()
            log.warning("fleet member %r failed: %r", member.contract_id,
                        error)
        finally:
            member.done = True
            member._yield.set()

    def gate(self, member: FleetMember, laser_evm, callee_address,
             func_hashes=None) -> None:
        """A member's device gate for one transaction (in place of
        `execute_message_call_tpu`): build its seeds, park until the
        coordinator has run the shared device phase, then drain the shared
        feeder through the member's own exec loop."""
        seeds = frontier.build_seed_templates(laser_evm, callee_address,
                                              func_hashes)
        if not seeds:
            laser_evm.exec()
            return
        member.gate_seeds = seeds
        member.gate_laser = laser_evm
        member._yield.set()
        member._grant.wait()
        member._grant.clear()
        if self.aborted:
            raise RuntimeError("fleet driver aborted")
        member.gate_seeds = None
        feeder = member._pending_feeder
        member._pending_feeder = None
        laser_evm.frontier_feeder = feeder
        try:
            laser_evm.exec()
        finally:
            laser_evm.frontier_feeder = None

    # -- the coordinator ------------------------------------------------------------------

    def run(self) -> List[FleetMember]:
        """Run every member to its end; raises without the configured
        device before any member's turn."""
        frontier.resolve_device()
        for member in self.members:
            member.thread = threading.Thread(
                target=self._member_main, args=(member,),
                name=f"fleet-{member.index}", daemon=True)
            member.thread.start()
        try:
            # first turns: construction and the creation transaction, up
            # to the first gate
            for member in self.members:
                if not member.done:
                    self._run_turn(member)
            while True:
                gated = [m for m in self.members
                         if not m.done and m.gate_seeds is not None]
                if not gated:
                    break
                self._device_phase(gated)
                for member in gated:
                    if not member.done:
                        self._run_turn(member)
        except BaseException:
            self.aborted = True
            for member in self.members:
                member._grant.set()  # let parked threads fail out
            raise
        finally:
            self._drain_frontier()
            from ..core.time_handler import time_handler

            time_handler.reset()
            for member in self.members:
                if member.thread is not None:
                    member.thread.join(timeout=60)
        return self.members

    def _drain_frontier(self) -> None:
        """Materialize every row the last phase's frontier still defers
        into its owner's worklist (a drained member's are counted): a
        member whose turn timed out must not strand the others' rows."""
        fr, self.frontier = self.frontier, None
        if fr is None:
            return
        try:
            feeder = fr.make_feeder(batch_rows=1024)
            while feeder():
                pass
        except Exception as error:  # noqa: BLE001
            log.warning("fleet: draining leftover deferred rows failed "
                        "(%r)", error)

    def _device_phase(self, gated: List[FleetMember]) -> None:
        """Pack every parked member's seeds into one frontier and run the
        drain loop once for all of them, each member's seeds in the shard
        block of its position."""
        self._drain_frontier()
        seeds: list = []
        owners: List[FleetMember] = []
        for member in gated:
            seeds.extend(member.gate_seeds)
            owners.extend([member] * len(member.gate_seeds))
        setting = frontier._settings
        lanes = setting["fleet_lanes"] or setting["lanes"]
        fr = frontier.new_frontier(gated[0].gate_laser,
                                   max(lanes, 2 * len(seeds)))
        fr.fleet = self
        fr.seed_owner_index = [gated.index(owner) for owner in owners]
        state, planes = fr.seed(seeds, owners)
        self._arm_clock(max(m.budget_remaining() for m in gated))
        self.phases += 1
        start = time.perf_counter()
        fr.run(state, planes)
        device_s = time.perf_counter() - start
        self.device_s += device_s
        self.lane_steps += fr.lane_steps
        self.forks += fr.forks
        self.chunks += fr.chunks
        self.steal_passes += fr.steal_passes
        self.steal_rows += fr.steal_rows
        for name, count in zip(fr.fleet_names, fr.fleet_occupancy):
            self.occupancy[name] = self.occupancy.get(name, 0) + int(count)
        log.info("fleet phase %d: %d contracts, %d seeds, %d lanes in %d "
                 "shards, %d lane-steps in %d chunks, %d forks, %d steal "
                 "passes moving %d rows, device phase %.6f s", self.phases,
                 len(gated), len(seeds), fr.n_lanes, fr.n_shards,
                 fr.lane_steps, fr.chunks, fr.forks, fr.steal_passes,
                 fr.steal_rows, device_s)
        self.frontier = fr
        feeder = fr.make_feeder()
        for member in gated:
            member._pending_feeder = feeder

    def deadline_drain(self, fr: "frontier.Frontier", status: np.ndarray,
                       lane_ctx: np.ndarray) -> bool:
        """Once a chunk, from the frontier's loop: the live lanes of every
        member past its budget are killed in place (freed for the others)
        and counted on its own laser. True when `status` changed (the
        frontier writes it back to the device)."""
        changed = False
        live = ((status == RUNNING) | (status == FORKING)
                | (status == ESCAPED))
        for member in self.members:
            if not member.abandoned:
                if member.budget_remaining() > 1.0:
                    continue
                member.abandoned = True
                log.info("fleet member %r exhausted its budget; draining "
                         "its lanes (others continue)", member.contract_id)
            indices = fr.fleet_ctx_of.get(id(member))
            if not indices:
                continue
            mask = live & np.isin(lane_ctx, indices)
            count = int(np.sum(mask))
            if count:
                status[mask] = DEAD
                member.count_dropped(count)
                member.drained += count
                self.drained += count
                changed = True
        return changed

    def counters(self) -> dict:
        """The driver's device counters, as one dict."""
        return {"phases": self.phases, "lane_steps": self.lane_steps,
                "forks": self.forks, "chunks": self.chunks,
                "steal_passes": self.steal_passes,
                "steal_rows": self.steal_rows, "drained": self.drained,
                "device_s": self.device_s,
                "occupancy": dict(self.occupancy)}
