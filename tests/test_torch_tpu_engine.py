"""The port's single-contract device driver (mythril_tpu_torch/parallel/
frontier.py `execute_message_call_tpu`, `Frontier`) against the JAX
package's (`mythril_tpu.parallel.frontier`), at 16 lanes, the port on its
plain twins (`frontier.configure(device="cpu")`) and the JAX package on the
CPU (`MYTHRIL_TPU_LANES=16`), every counter reset on both sides
(tests/_torch_engine.py `fresh`).

- The seven cases of tests/test_tpu_engine.py, each through `analyze`'s
  MythrilAnalyzer and `SymExecWrapper(engine="tpu")` of each package: the
  reports by `report_parity` (and the cases' own assertions), and each
  transaction's `frontier: ...` log line, word for word.
- `LaserEVM(engine="tpu")` on branchy(4) with the device's step budget
  at two chunks: the hand-over's statespace (node numbering, edges, open
  states in order) and frontier lines.
- `HostArena.to_term` on a mirror that holds every op class and every
  variable class, with its annotations, the operands of commutative
  operators sorted.
- `storage_entries` on a concrete store chain, a symbolic base and a
  symbolic key.
- One cold-SLOAD service (`Frontier._service_cold`: K7's gather and
  scatter, here their twins) on paused rows, against the JAX
  `_cold_sload_lane` on the same rows: a Select fault-in, a known value, a
  full table and an annotated host term.
- Escape-time pruning (`configure(check_escapes=True)`) and the host-drain
  skip (`configure(skip_host_drain=True)`) against the JAX package with
  MYTHRIL_TPU_CHECK_ESCAPES=1 and MYTHRIL_TPU_SKIP_HOST_DRAIN=1.
- `frontier.configure`'s defaults against the JAX knobs'."""

import logging
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_engine import (BUDGET_S, JAX, PORT, analyze_report, canonical,
                           report_parity, run_on, value_of)
from _torch_parity import np_tree
from chip_smoke import KILLBILLY, SAFE_KILL, branchy_contract
from mythril_tpu.analysis.modules import dependence_on_origin as jorigin
from mythril_tpu.parallel import arena as jarena
from mythril_tpu.parallel import frontier as jf
from mythril_tpu.parallel import words as jwords
from mythril_tpu_torch.analysis.modules import dependence_on_origin as porigin
from mythril_tpu_torch.parallel import arena as parena
from mythril_tpu_torch.parallel import convert
from mythril_tpu_torch.parallel import frontier as pf

N_LANES = 16
PACKAGES = {"jax": "mythril_tpu", "port": "mythril_tpu_torch"}
ARENA = {"jax": jarena, "port": parena}
FRONTIER = {"jax": jf, "port": pf}
STORAGE_ENTRIES = {"jax": jf._storage_entries, "port": pf.storage_entries}
ORIGIN = {"jax": jorigin, "port": porigin}

#: tests/test_tpu_engine.py's tx.origin and symbolic-key contracts
ORIGIN_AUTH = {
    "auth()": "ORIGIN\nPUSH1 0x42\nEQ\nPUSH @ok\nJUMPI\nSTOP\n"
              "ok:\nJUMPDEST\nPUSH1 0x01\nPUSH1 0x00\nSSTORE\nSTOP",
}
SYMBOLIC_KEY = {
    "setup()": "PUSH1 0x01\nCALLER\nSSTORE\n"
               "PUSH1 0x07\nPUSH1 0x03\nSSTORE\nSTOP",
    "drain()": "PUSH1 0x03\nSLOAD\nPUSH1 0x07\nEQ\nPUSH @kill\nJUMPI\n"
               "STOP\nkill:\nJUMPDEST\nCALLER\nSELFDESTRUCT",
}


@pytest.fixture(scope="module", autouse=True)
def _sixteen_lanes():
    """Both drivers at 16 lanes, the port's on the CPU; the twins on one
    torch thread (beside other test processes a pool of threads per small
    op costs more than it gives)."""
    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("MYTHRIL_TPU_LANES", str(N_LANES))
        pf.configure(lanes=N_LANES, device="cpu")
        torch.set_num_threads(1)
        try:
            yield
        finally:
            torch.set_num_threads(threads)
            pf.reset()


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def tpu_analysis(side, contract, modules, transaction_count,
                 bin_runtime=False, **options) -> dict:
    """`analyze --engine tpu` of a dispatcher of `contract` on one side
    (creation code, or runtime code with `bin_runtime`): the report as
    analyze_report gives it, and the driver's `frontier: ...` lines."""
    runtime = side.asm.assemble(side.asm.dispatcher(contract))
    code = runtime if bin_runtime else side.asm.creation_wrapper(runtime)
    handler = _Lines()
    logger = logging.getLogger(PACKAGES[side.name] + ".parallel.frontier")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        report = analyze_report(side, code, modules.split(","),
                                transaction_count, bin_runtime,
                                engine="tpu", **options)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    report["frontier"] = [line for line in handler.lines
                          if line.startswith("frontier: ")]
    return report


def both(contract, modules, transaction_count, bin_runtime=False,
         **options) -> dict:
    """One analysis on each package: the reports by `report_parity`, the
    frontier lines word for word; returns the port's."""
    jax, port = (run_on(side, lambda side: tpu_analysis(
                     side, contract, modules, transaction_count, bin_runtime,
                     **options)) for side in (JAX, PORT))
    assert port["exceptions"] == jax["exceptions"] == []
    report_parity(port["json"], jax["json"], port["pool"] == jax["pool"])
    assert port["frontier"] == jax["frontier"]
    assert len(port["frontier"]) == transaction_count
    return port


def swc_ids(report: dict) -> list:
    return sorted(issue["swc-id"] for issue in report["json"]["issues"])


def counter(lines, name: str) -> int:
    """The sum over the frontier lines of the count before `name`."""
    total = 0
    for line in lines:
        words = line.replace(",", "").split()
        total += int(words[words.index(name) - 1])
    return total


@pytest.fixture(scope="module")
def killbilly():
    return both(KILLBILLY, "AccidentallyKillable", 2)


# ---- tests/test_tpu_engine.py's cases ---------------------------------------------

def test_killbilly_parity(killbilly):
    from mythril_tpu_torch.frontends.asm import selector

    assert swc_ids(killbilly) == ["106"]
    steps = killbilly["json"]["issues"][0]["tx_sequence"]["steps"]
    assert steps[-1]["input"].startswith(
        "0x%08x" % selector("commencekilling()"))


def test_safe_contract_stays_clean():
    assert swc_ids(both(SAFE_KILL, "AccidentallyKillable", 2)) == []


def test_origin_dependence_parity():
    """An origin-tainted JUMPI escapes to the host, where TxOrigin fires."""
    assert swc_ids(both(ORIGIN_AUTH, "TxOrigin", 1)) == ["115"]


def test_transaction_sequences_respected_by_tpu_engine():
    from mythril_tpu_torch.frontends.asm import selector

    activate, kill = (selector("activatekillability()"),
                      selector("commencekilling()"))
    found = both(KILLBILLY, "AccidentallyKillable", 2,
                 transaction_sequences=[[activate], [kill]])
    not_found = both(KILLBILLY, "AccidentallyKillable", 2,
                     transaction_sequences=[[kill], [kill]])
    assert swc_ids(found) == ["106"]
    assert swc_ids(not_found) == []


def test_runtime_code_engages_device():
    """A symbolic storage base: cold SLOADs fault in on the device."""
    port = both(KILLBILLY, "AccidentallyKillable", 2, bin_runtime=True)
    assert swc_ids(port) == ["106"]
    assert counter(port["frontier"], "forks") > 0
    assert counter(port["frontier"], "storage") > 0  # fault-ins


def test_symbolic_storage_key_stays_on_device():
    """A symbolic-key store stops the chain walk; tx 2 stays on the
    device."""
    port = both(SYMBOLIC_KEY, "AccidentallyKillable", 2)
    assert swc_ids(port) == ["106"]
    assert len(port["frontier"]) == 2


def test_frontier_forks_on_device(killbilly):
    assert counter(killbilly["frontier"], "forks") >= 2


# ---- the hand-over at the step budget ----------------------------------------------

def statespace(side, contract) -> dict:
    """LaserEVM(engine="tpu") on a dispatcher of `contract`, one
    transaction: its states, node numbering, edges, open states in order
    and frontier lines."""
    handler = _Lines()
    logger = logging.getLogger(PACKAGES[side.name] + ".parallel.frontier")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    runtime = side.asm.assemble(side.asm.dispatcher(contract))
    laser = side.svm.LaserEVM(
        max_depth=128, execution_timeout=BUDGET_S, create_timeout=BUDGET_S,
        strategy=side.strategy.BreadthFirstSearchStrategy,
        transaction_count=1, engine="tpu")
    try:
        laser.sym_exec(creation_code=side.asm.creation_wrapper(runtime).hex(),
                       contract_name="MAIN")
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    return {"total_states": laser.total_states,
            "nodes": {uid: (node.start_addr, node.function_name)
                      for uid, node in laser.nodes.items()},
            "edges": [(edge.node_from, edge.node_to) for edge in laser.edges],
            "open": [(len(ws.constraints), sorted(
                (repr(value_of(k)), repr(value_of(v))) for k, v in
                ws.accounts[address].storage.printable_storage.items()))
                for ws in laser.open_states for address in sorted(ws.accounts)],
            "frontier": [line for line in handler.lines
                         if line.startswith("frontier: ")]}


def test_step_budget_hands_over_in_the_jax_order():
    """branchy(4) with the device's step budget at two chunks of 8: the
    live lanes are materialized straight into the worklist and the pools'
    rows deferred, in the JAX order, which the node numbering and the
    open states' order show."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("MYTHRIL_TPU_CHUNK", "8")
        patch.setenv("MYTHRIL_TPU_MAX_STEPS", "16")
        pf.configure(lanes=N_LANES, chunk=8, max_steps=16, device="cpu")
        try:
            jax, port = (run_on(side, lambda side: statespace(
                side, {"stress()": branchy_contract(4)}))
                for side in (JAX, PORT))
        finally:
            pf.configure(lanes=N_LANES, device="cpu")
    assert port == jax
    # the budget ended the device phase with live lanes to materialize
    assert counter(port["frontier"], "states") > 0


# ---- the knobs that are off by default ----------------------------------------------

#: a second check of the calldata word that contradicts the first: the
#: device forks both sides, the host finds one infeasible
CONTRADICTION = {
    "pick()": "PUSH1 0x04\nCALLDATALOAD\nPUSH1 0x05\nEQ\nPUSH @five\n"
              "JUMPI\nSTOP\nfive:\nJUMPDEST\nPUSH1 0x04\nCALLDATALOAD\n"
              "PUSH1 0x06\nEQ\nPUSH @six\nJUMPI\nSTOP\nsix:\nJUMPDEST\n"
              "CALLER\nSELFDESTRUCT",
}


def knob_run(knob: str, run):
    """`run()` with the JAX knob MYTHRIL_TPU_<knob> set and the port's
    `configure` setting of the same name on."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("MYTHRIL_TPU_" + knob.upper(), "1")
        pf.configure(lanes=N_LANES, device="cpu", **{knob: True})
        try:
            return run()
        finally:
            pf.configure(lanes=N_LANES, device="cpu")


def both_statespaces(contract) -> dict:
    """`statespace` of each package, equal; returns the port's."""
    jax, port = (run_on(side, lambda side: statespace(side, contract))
                 for side in (JAX, PORT))
    assert port == jax
    return port


def test_check_escapes_prunes_as_the_jax_knob():
    """Escape-time pruning drops the rows whose path conditions are
    unsatisfiable before they materialize (`_prefetch_feasibility`,
    `_feasible`), the same rows on both sides: the transaction ends with
    fewer open states than without it."""
    pruned = knob_run("check_escapes",
                      lambda: both_statespaces(CONTRADICTION))
    default = both_statespaces(CONTRADICTION)
    assert pruned["frontier"] == default["frontier"]
    assert len(pruned["open"]) < len(default["open"])


def test_skip_host_drain_drops_the_continuation_as_the_jax_knob():
    """With the host drain skipped the device phase runs and its rows
    never reach the detectors: no issue where the default run finds
    SWC-115."""
    port = knob_run("skip_host_drain",
                    lambda: both(ORIGIN_AUTH, "TxOrigin", 1))
    assert counter(port["frontier"], "forks") > 0
    assert swc_ids(port) == []


# ---- term conversion ------------------------------------------------------------------

V = parena
#: (op, a, b, c, imm, imm2) of nodes 1.., over every op and var class
NODES = [
    (V.CONST, 0, 0, 0, 0, 0),                      # 1: 5
    (V.CONST, 0, 0, 0, 1, 0),                      # 2: 0
    (V.CONST, 0, 0, 0, 2, 0),                      # 3: 40
    (V.VAR, 0, 0, 0, V.V_CALLDATA_WORD, 4),        # 4
    (V.VAR, 0, 0, 0, V.V_CALLDATASIZE, 0),         # 5
    (V.VAR, 0, 0, 0, V.V_CALLER, 0),               # 6
    (V.VAR, 0, 0, 0, V.V_ORIGIN, 0),               # 7
    (V.VAR, 0, 0, 0, V.V_CALLVALUE, 0),            # 8
    (V.VAR, 0, 0, 0, V.V_GASPRICE, 0),             # 9
    (V.VAR, 0, 0, 0, V.V_TIMESTAMP, 0),            # 10
    (V.VAR, 0, 0, 0, V.V_NUMBER, 0),               # 11
    (V.VAR, 0, 0, 0, V.V_COINBASE, 0),             # 12
    (V.VAR, 0, 0, 0, V.V_PREVRANDAO, 0),           # 13
    (V.VAR, 0, 0, 0, V.V_BASEFEE, 0),              # 14
    (V.VAR, 0, 0, 0, V.V_HOST_TERM, 0),            # 15
    (V.VAR, 0, 0, 0, V.V_HOST_TERM, 1),            # 16
] + [(op, 4, 6, 0, 0, 0x40 + op) for op in
     (0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x16, 0x17, 0x18)] + [
    (0x01, 1, 1, 0, 0, 0x50),                      # concrete: no marker
    (0x02, 2, 4, 0, 0, 0x51),                      # x * 0: no marker
    (0x02, 1, 4, 0, 0, 0x52),
    (0x03, 7, 10, 0, 0, 0x53),                     # taint flows through
    (0x04, 4, 2, 0, 0, 0), (0x06, 4, 2, 0, 0, 0),  # by a zero constant
    (0x05, 8, 2, 0, 0, 0), (0x07, 8, 2, 0, 0, 0),
] + [(op, 1, 4, 0, 0, 0) for op in (0x1B, 0x1C, 0x1D)] + [
    (op, 4, 7, 0, 0, 0) for op in (0x10, 0x11, 0x12, 0x13, 0x14)] + [
    (0x15, 11, 0, 0, 0, 0),                        # ISZERO
    (0x19, 12, 0, 0, 0, 0),                        # NOT
    (0x1A, 1, 4, 0, 0, 0),                         # BYTE
    (0x0B, 2, 4, 0, 0, 0),                         # SIGNEXTEND, size 0
    (0x0B, 1, 8, 0, 0, 0),                         # size 5
    (0x0B, 3, 4, 0, 0, 0),                         # size 40: unchanged
    (0x0B, 5, 4, 0, 0, 0),                         # symbolic size
    (0x0A, 4, 6, 0, 0, 0x60),                      # EXP
    (0x0A, 2, 6, 0, 0, 0x61),                      # 0 ** x: no marker
    (0x0F, 13, 15, 16, 0, 0),                      # internal ITE
    (0x01, 15, 16, 0, 0, 0x62),                    # host terms
]
CONSTS = [5, 0, 40]


def environment(side):
    """An environment of symbolic words, as a message call's."""
    s, sym = side.state, side.smt.symbol_factory.BitVecSym
    world_state = s.WorldState()
    account = world_state.create_account(balance=1, address=0x1AAF)
    account.code = side.Disassembly("0x00")
    return s.Environment(
        active_account=account, sender=sym("sender_1", 256),
        calldata=side.calldata.SymbolicCalldata("1"),
        gasprice=sym("gas_price1", 256), callvalue=sym("call_value1", 256),
        origin=sym("sender_1", 256), basefee=sym("basefee", 256))


def annotation_view(term) -> list:
    out = []
    for annotation in term.annotations:
        name = type(annotation).__name__
        if name == "OverUnderflowAnnotation":
            site = annotation.overflowing_state
            out.append((name, annotation.operator,
                        canonical(str(annotation.constraint.raw)),
                        site.get_current_instruction()["address"],
                        site.environment.active_account.address.value))
        else:
            out.append((name, getattr(annotation, "operation", None)))
    return sorted(out)


def converted(side) -> list:
    """Every node of NODES through one side's HostArena.to_term."""
    A = ARENA[side.name]
    arena = (A.new_arena(64, 8, device="cpu") if side is PORT
             else A.new_arena(64, 8))
    mirror = A.HostArena(arena)
    for node, row in enumerate(NODES, start=1):
        for col, value in zip(("op", "a", "b", "c", "imm", "imm2"), row):
            getattr(mirror, col)[node] = value
    for index, value in enumerate(CONSTS):
        mirror.const_vals[index] = jwords.from_int(value)
    mirror.n, mirror.n_const = len(NODES) + 1, len(CONSTS)
    env = environment(side)
    ctx = A.TxContext("1", env.calldata, env)
    host = side.smt.symbol_factory.BitVecSym("host_0", 256)
    host.annotate(ORIGIN[side.name].OriginAnnotation())
    ctx.host_terms += [host, side.smt.symbol_factory.BitVecSym("host_1", 256)]
    out = []
    for node in range(1, len(NODES) + 1):
        term = mirror.to_term(node, ctx)
        out.append((node, canonical(str(term.raw)), annotation_view(term)))
    # the memo: a second conversion is the same object
    assert mirror.to_term(len(NODES), ctx) is term
    return out


def test_to_term_every_op_and_var_class():
    jax, port = (run_on(side, converted) for side in (JAX, PORT))
    for got, want in zip(port, jax):
        assert got == want
    assert len(port) == len(NODES)


# ---- the storage chain walk -----------------------------------------------------------

def chains(side) -> dict:
    sym, val = (side.smt.symbol_factory.BitVecSym,
                side.smt.symbol_factory.BitVecVal)
    out = {}
    for name, concrete in (("concrete", True), ("symbolic_base", False),
                           ("symbolic_key", True)):
        account = side.state.WorldState().create_account(
            balance=1, address=0x1AAF, concrete_storage=concrete)
        storage = account.storage
        storage[val(1, 256)] = val(5, 256)
        if name == "symbolic_key":
            storage[sym("caller_key", 256)] = val(2, 256)
        storage[val(2, 256)] = sym("stored", 256)
        storage[val(1, 256)] = val(7, 256)
        entries, base_sym = STORAGE_ENTRIES[side.name](storage)
        out[name] = ([(key, value_of(value)) for key, value in entries],
                     base_sym)
    return out


def test_storage_entries():
    got = run_on(PORT, chains)
    assert got == run_on(JAX, chains)
    assert got["concrete"] == ([(1, 7), (2, ["stored"])], False)
    assert got["symbolic_base"][1] is True
    # the walk stops at the symbolic key: only the stores above it
    assert got["symbolic_key"] == ([(1, 7), (2, ["stored"])], True)


# ---- the cold-SLOAD service -------------------------------------------------------------

#: lanes paused at an SLOAD: the key each reads, and whether its table is
#: full, or misses the seeded slot of its key
COLD = [(7, "select"), (5, "known"), (9, "full"), (6, "annotated")]


def cold_template(side):
    """A seed template over a symbolic-base account holding slot 5 = 42
    and slot 6 = an origin-annotated symbol."""
    world_state = side.state.WorldState()
    account = world_state.create_account(balance=1, address=0xACE,
                                         concrete_storage=False)
    account.code = side.Disassembly(
        side.asm.assemble(side.asm.dispatcher(KILLBILLY)).hex())
    val = side.smt.symbol_factory.BitVecVal
    tainted = side.smt.symbol_factory.BitVecSym("tainted", 256)
    tainted.annotate(ORIGIN[side.name].OriginAnnotation())
    account.storage[val(5, 256)] = val(42, 256)
    account.storage[val(6, 256)] = tainted
    laser = SimpleNamespace(open_states=[world_state], work_list=[],
                            requires_statespace=False)
    templates = FRONTIER[side.name].build_seed_templates(laser,
                                                         account.address)
    return laser, templates


def paused_rows(state, planes):
    """Numpy rows of four lanes copied from seed lane 0, each paused at an
    SLOAD of its COLD key."""
    state = {f: np.array(v) for f, v in np_tree(state)._asdict().items()}
    planes = {f: np.array(v) for f, v in np_tree(planes)._asdict().items()}
    for rows in (state, planes):
        for field, leaf in rows.items():
            if leaf.ndim:
                leaf[1:len(COLD)] = leaf[0]
    for lane, (key, kind) in enumerate(COLD):
        state["sp"][lane] = 1
        state["stack"][lane, 0] = jwords.from_int(key)
        keys = jwords.to_ints(state["storage_keys"][lane])
        if kind == "full":
            state["storage_used"][lane] = True
        elif kind in ("known", "annotated"):
            slot = [i for i, k in enumerate(keys) if k == key][0]
            state["storage_used"][lane, slot] = False
    return state, planes


def cold_service(side):
    laser, templates = cold_template(side)
    if side is JAX:
        frontier = jf._Frontier(laser, n_lanes=len(COLD))
        frontier.arena = jarena.new_arena(1 << 10, 1 << 6)
    else:
        frontier = pf.Frontier(laser, n_lanes=len(COLD), device="cpu")
        frontier.arena = parena.new_arena(1 << 10, 1 << 6, device="cpu")
    state, planes = frontier.seed(templates)
    if side is PORT:
        state, planes = convert.to_numpy(state), convert.to_numpy(planes)
    seeded_sym = np.array(np_tree(planes).storage_sym[0])
    state_np, planes_np = paused_rows(state, planes)
    status = np.full(len(COLD), pf.FORKING, dtype=np.int32)
    lanes = list(range(len(COLD)))
    if side is JAX:
        harena = frontier._harena()
        for lane in lanes:
            frontier._cold_sload_lane(state_np, planes_np, harena, status,
                                      lane, lane)
        arena = np_tree(frontier.arena)
    else:
        frontier._harena()
        state_t, planes_t = frontier._service_cold(
            convert.from_numpy("state", SimpleNamespace(**state_np),
                               device="cpu"),
            convert.from_numpy("planes", SimpleNamespace(**planes_np),
                               device="cpu"),
            status, lanes)
        state_np = convert.to_numpy(state_t)._asdict()
        planes_np = convert.to_numpy(planes_t)._asdict()
        arena = convert.to_numpy(frontier.arena)
    n = int(arena.n)
    work = [(state.mstate.pc, [value_of(v) for v in state.mstate.stack],
             state.mstate.min_gas_used) for state in laser.work_list]
    return {"state": state_np, "planes": planes_np, "status": status.tolist(),
            "faults": frontier.faults, "seeded_sym": seeded_sym.tolist(),
            "arena": {col: np.asarray(getattr(arena, col))[:n].tolist()
                      for col in ("op", "imm", "imm2", "cls")},
            "host_terms": [[value_of(term) for term in ctx.host_terms]
                           for ctx in frontier.contexts],
            "work": work}


def test_cold_sload_service():
    jax, port = (run_on(side, cold_service) for side in (JAX, PORT))
    for part in ("state", "planes"):
        assert set(port[part]) == set(jax[part])
        for field, want in jax[part].items():
            got = np.asarray(port[part][field])
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                (part, field)
    for key in ("status", "faults", "seeded_sym", "arena", "host_terms",
                "work"):
        assert port[key] == jax[key], key
    # a Select and an annotated leaf faulted in, a known value read, a full
    # table handed to the host (materialized, its lane freed)
    assert port["status"] == [0, 0, 7, 0] and port["faults"] == 3
    assert len(port["work"]) == 1
    assert port["arena"]["cls"][-1] & (1 << parena.V_ORIGIN)


def test_settings_follow_the_jax_knobs():
    """`frontier.configure`'s defaults are the JAX knobs' defaults, and
    `reset` restores them; the device phase's budget share is the JAX
    default."""
    from mythril_tpu.support.tpu_config import REGISTRY

    knobs = {"lanes": "LANES", "chunk": "CHUNK", "max_steps": "MAX_STEPS",
             "check_escapes": "CHECK_ESCAPES",
             "skip_host_drain": "SKIP_HOST_DRAIN",
             "fleet_shard": "FLEET_SHARD", "fleet_lanes": "FLEET_LANES",
             "steal_cadence": "STEAL_CADENCE",
             "steal_min_imbalance": "STEAL_MIN_IMBALANCE"}
    assert pf.DEVICE_FRAC == REGISTRY["MYTHRIL_TPU_DEVICE_FRAC"].default
    pf.reset()
    try:
        assert pf._settings == {
            **{key: REGISTRY["MYTHRIL_TPU_" + name].default
               for key, name in knobs.items()}, "device": None}
    finally:
        pf.configure(lanes=N_LANES, device="cpu")
