"""Shared harness for the tests that hold the port's host engine
(mythril_tpu_torch/core: state, instructions, transactions, strategies,
LaserEVM) against the JAX package's.

A case is written once over a `Side` (one package's modules) and runs on
both packages from the same plain data: hex code, calldata bytes, storage
dicts. Before each run `fresh(side)` resets every process-wide counter
that names symbols (node uids, transaction ids, the keccak and exponent
function managers) and the solver's backend and caches, so both sides
number their symbols alike. Expression text depends on the process
(terms.py orders commutative operands by an id-based hash, ROADMAP C):
symbolic values are compared as sorted tokens, never as exact text.

`fresh` also resets what an analysis leaves behind: the metric registry
and the span tracer (each package has its own), the detection
modules' issues and caches, the laser plugin loader, the `args` fields
the analyzer writes, and the JAX package's signature database, which
persists to a file under HOME (the port's is in memory): each case points
it at a fresh temporary file. The report helpers below compare two
analyses' `-o json` reports by the rule of `report_parity`."""

import atexit
import hashlib
import json
import os
import re
import shutil
import tempfile
from types import SimpleNamespace

from chip_smoke import HOST_ENGINE_CONTRACTS, branchy_contract
from mythril_tpu import exceptions as jexceptions
from mythril_tpu import smt as jsmt
from mythril_tpu import mythril as jmythril
from mythril_tpu.analysis import module_screen as jmodule_screen
from mythril_tpu.analysis import security as jsecurity
from mythril_tpu.core import plugin as jplugin
from mythril_tpu.core import cheat_code as jcheat_code
from mythril_tpu.core import function_managers as jfunction_managers
from mythril_tpu.core import instructions as jinstructions
from mythril_tpu.core import natives as jnatives
from mythril_tpu.core import node as jnode
from mythril_tpu.core import state as jstate
from mythril_tpu.core import svm as jsvm
from mythril_tpu.core import util as jutil
from mythril_tpu.core.state import calldata as jcalldata
from mythril_tpu.core.strategy import basic as jbasic
from mythril_tpu.core.strategy import bounded_loops as jbounded_loops
from mythril_tpu.core.time_handler import time_handler as jtime_handler
from mythril_tpu.core.transaction import concolic as jconcolic
from mythril_tpu.core.transaction import transaction_models as jtx
from mythril_tpu.frontends import asm as jasm
from mythril_tpu.frontends.disassembler import Disassembly as JDisassembly
from mythril_tpu.observe import metrics as jmetrics
from mythril_tpu.observe import trace as jtrace
from mythril_tpu.smt.solver import simplify as jsimplify
from mythril_tpu.smt.solver import solver as jsolver
from mythril_tpu.smt.solver import solver_statistics as jstatistics
from mythril_tpu.support import model as jmodel
from mythril_tpu.support import signatures as jsignatures
from mythril_tpu.support import support_args as jsupport_args
from mythril_tpu.utils import keccak as jkeccak
from mythril_tpu_torch import exceptions as pexceptions
from mythril_tpu_torch import smt as psmt
from mythril_tpu_torch import mythril as pmythril
from mythril_tpu_torch.analysis import module_screen as pmodule_screen
from mythril_tpu_torch.analysis import security as psecurity
from mythril_tpu_torch.core import plugin as pplugin
from mythril_tpu_torch.core import cheat_code as pcheat_code
from mythril_tpu_torch.core import function_managers as pfunction_managers
from mythril_tpu_torch.core import instructions as pinstructions
from mythril_tpu_torch.core import natives as pnatives
from mythril_tpu_torch.core import node as pnode
from mythril_tpu_torch.core import state as pstate
from mythril_tpu_torch.core import svm as psvm
from mythril_tpu_torch.core import util as putil
from mythril_tpu_torch.core.state import calldata as pcalldata
from mythril_tpu_torch.core.strategy import basic as pbasic
from mythril_tpu_torch.core.strategy import bounded_loops as pbounded_loops
from mythril_tpu_torch.core.time_handler import time_handler as ptime_handler
from mythril_tpu_torch.core.transaction import concolic as pconcolic
from mythril_tpu_torch.core.transaction import transaction_models as ptx
from mythril_tpu_torch.frontends import asm as pasm
from mythril_tpu_torch.frontends.disassembler import Disassembly as PDisassembly
from mythril_tpu_torch.observe import metrics as pmetrics
from mythril_tpu_torch.observe import trace as ptrace
from mythril_tpu_torch.smt.solver import simplify as psimplify
from mythril_tpu_torch.smt.solver import solver as psolver
from mythril_tpu_torch.smt.solver import solver_statistics as pstatistics
from mythril_tpu_torch.support import model as pmodel
from mythril_tpu_torch.support import signatures as psignatures
from mythril_tpu_torch.support import support_args as psupport_args
from mythril_tpu_torch.utils import keccak as pkeccak

JAX = SimpleNamespace(
    name="jax", smt=jsmt, state=jstate, calldata=jcalldata, tx=jtx,
    util=jutil, Disassembly=JDisassembly, instructions=jinstructions,
    natives=jnatives, cheat_code=jcheat_code, fm=jfunction_managers,
    node=jnode, svm=jsvm, strategy=jbasic, bounded_loops=jbounded_loops,
    concolic=jconcolic, asm=jasm, module_screen=jmodule_screen,
    solver=jsolver, simplify=jsimplify, stats=jstatistics.SolverStatistics,
    model=jmodel, keccak=jkeccak, exceptions=jexceptions,
    time_handler=jtime_handler, mythril=jmythril, security=jsecurity,
    plugin=jplugin, args=jsupport_args.args, signatures=jsignatures,
    metrics=jmetrics, trace=jtrace)
PORT = SimpleNamespace(
    name="port", smt=psmt, state=pstate, calldata=pcalldata, tx=ptx,
    util=putil, Disassembly=PDisassembly, instructions=pinstructions,
    natives=pnatives, cheat_code=pcheat_code, fm=pfunction_managers,
    node=pnode, svm=psvm, strategy=pbasic, bounded_loops=pbounded_loops,
    concolic=pconcolic, asm=pasm, module_screen=pmodule_screen,
    solver=psolver, simplify=psimplify, stats=pstatistics.SolverStatistics,
    model=pmodel, keccak=pkeccak, exceptions=pexceptions,
    time_handler=ptime_handler, mythril=pmythril, security=psecurity,
    plugin=pplugin, args=psupport_args.args, signatures=psignatures,
    metrics=pmetrics, trace=ptrace)
SIDES = (JAX, PORT)

#: the statespace contracts, by name: chip_smoke.py's KILLBILLY (tests/
#: test_analysis.py's) and branchy(8), and branchy(6)
CONTRACTS = {**HOST_ENGINE_CONTRACTS,
             "branchy6": {"stress()": branchy_contract(6)}}


#: the directory of the JAX side's per-case signature databases
_SIGNATURE_DIR = []


def _fresh_signature_db(side) -> None:
    """Point the JAX package's signature database at a fresh file (the
    port's is an in-memory store that nothing in an analysis adds to)."""
    if side is not JAX:
        return
    if not _SIGNATURE_DIR:
        _SIGNATURE_DIR.append(tempfile.mkdtemp(prefix="jax-signatures-"))
        atexit.register(shutil.rmtree, _SIGNATURE_DIR[0], True)
    path = os.path.join(_SIGNATURE_DIR[0], "signatures.db")
    if os.path.exists(path):
        os.remove(path)
    database = side.signatures.SignatureDB(path=path)
    side.signatures.SignatureDB._instance = database


def fresh(side) -> None:
    """Reset what numbers symbols and what caches verdicts, process-wide,
    and what an analysis leaves behind."""
    side.node.Node._uid_counter = 0
    side.tx.tx_id_manager.restart_counter()
    side.fm.keccak_function_manager.reset()
    side.fm.exponent_function_manager.__init__()
    side.solver.reset_solver_backend()
    side.stats().reset()
    side.metrics.reset()
    side.trace.reset()
    side.simplify.reset_simplify_memo()
    side.security.reset_callback_modules()
    side.plugin.LaserPluginLoader().reset()
    side.args._init_defaults()
    _fresh_signature_db(side)


def run_on(side, case, *args):
    """One case on one side from a fresh engine; the side's wall-clock
    budget and signature database are left as they were found."""
    saved = (side.time_handler._start_time, side.time_handler._execution_time)
    database = side.signatures.SignatureDB._instance
    fresh(side)
    try:
        return case(side, *args)
    finally:
        fresh(side)
        (side.time_handler._start_time,
         side.time_handler._execution_time) = saved
        side.signatures.SignatureDB._instance = database


def run_both(case, *args):
    """{side name: observation} of one case on each package."""
    return {side.name: run_on(side, case, *args) for side in SIDES}


def assert_parity(case, *args):
    observed = run_both(case, *args)
    assert observed["port"] == observed["jax"]
    return observed["port"]


def tokens(text: str) -> list:
    """An expression's text as sorted tokens: the text up to the order of
    commutative operands, which depends on the process (ROADMAP C)."""
    return sorted(re.findall(r"[()]|[^\s()]+", text))


#: the operators whose operand order depends on the process (terms.py
#: orders commutative operands by an id-based hash, ROADMAP C)
COMMUTATIVE = frozenset({"bvadd", "bvmul", "bvand", "bvor", "bvxor", "eq",
                         "and", "or", "xor"})


def canonical(text: str) -> str:
    """An expression's text with the operands of commutative operators
    sorted, and everything else in its order: equal for two packages'
    terms exactly when they agree up to that order."""
    items = re.findall(r"[()]|[^\s()]+", text)
    position = 0

    def parse():
        nonlocal position
        item = items[position]
        position += 1
        if item != "(":
            return item
        node = []
        while items[position] != ")":
            node.append(parse())
        position += 1
        head, args = node[0], node[1:]
        if head in COMMUTATIVE:
            args.sort()
        return "(" + " ".join([head] + args) + ")"

    return parse()


def value_of(expression):
    """A BitVec as its value when concrete, else as sorted tokens."""
    raw = expression.raw
    return raw.value if raw.is_const else tokens(str(raw))


def bv(side, value, width=256):
    return side.smt.symbol_factory.BitVecVal(value, width)


def push(side, state, *values):
    for value in values:
        state.mstate.stack.append(bv(side, value))


def make_state(side, code_hex: str = "", static: bool = False,
               calldata=None):
    """tests/test_instructions.py's hand-built GlobalState, on one side."""
    s = side.state
    world_state = s.WorldState()
    account = world_state.create_account(balance=10 ** 18, address=0x1AAF)
    account.code = side.Disassembly(code_hex or "0x60")
    environment = s.Environment(
        active_account=account, sender=bv(side, 0xCAFE),
        calldata=calldata or side.calldata.ConcreteCalldata("1", []),
        gasprice=bv(side, 1), callvalue=bv(side, 0), origin=bv(side, 0xCAFE),
        basefee=bv(side, 7), static=static)
    state = s.GlobalState(world_state, environment, None,
                          s.MachineState(gas_limit=8000000))
    transaction = side.tx.MessageCallTransaction(
        world_state=world_state, callee_account=account,
        caller=environment.sender, identifier="1", gas_limit=8000000)
    state.transaction_stack.append((transaction, None))
    return state


def run_op(side, state, op):
    return side.instructions.Instruction(op).evaluate(state)


# ---- the statespace ----------------------------------------------------------------

#: budgets neither side reaches on these contracts
BUDGET_S = 600


def laser_for(side, transaction_count: int, strategy: str):
    search = {"dfs": side.strategy.DepthFirstSearchStrategy,
              "bfs": side.strategy.BreadthFirstSearchStrategy}[strategy]
    return side.svm.LaserEVM(max_depth=128, execution_timeout=BUDGET_S,
                             create_timeout=BUDGET_S, strategy=search,
                             transaction_count=transaction_count)


def runtime_world(side, runtime: bytes, name: str):
    """The world state SymExecWrapper builds for runtime code
    (mythril_tpu/analysis/symbolic.py:144-156)."""
    world_state = side.state.WorldState()
    account = world_state.create_account(balance=10 ** 18, address=None,
                                         concrete_storage=False)
    account.code = side.Disassembly(runtime.hex())
    account.contract_name = name
    return world_state, account


def explore(side, contract: str, mode: str, transaction_count: int,
            strategy: str):
    """Run `LaserEVM(engine="host").sym_exec` on one contract; returns the
    laser and the open-state count after each transaction."""
    runtime = side.asm.assemble(side.asm.dispatcher(CONTRACTS[contract]))
    laser = laser_for(side, transaction_count, strategy)
    after_tx = []
    laser.register_laser_hooks(
        "stop_sym_trans", lambda: after_tx.append(len(laser.open_states)))
    if mode == "creation":
        laser.sym_exec(creation_code=side.asm.creation_wrapper(runtime).hex(),
                       contract_name=contract)
    else:
        world_state, account = runtime_world(side, runtime, contract)
        laser.sym_exec(world_state=world_state,
                       target_address=account.address.value)
    return laser, after_tx


def open_state_record(side, world_state) -> dict:
    """One open world state: its storage writes, constraint count,
    feasibility, the model's caller and calldata values, and whether the
    model satisfies every path constraint."""
    storage = []
    for address in sorted(world_state.accounts):
        account = world_state.accounts[address]
        writes = sorted((repr(value_of(key)), repr(value_of(value)))
                        for key, value in
                        account.storage.printable_storage.items())
        storage.append((address, account.deleted, writes))
    constraints = world_state.constraints
    possible = constraints.is_possible()
    models, holds = [], None
    if possible:
        model = side.model.get_model(tuple(constraints.get_all_constraints()))
        holds = all(model.eval(c) is True for c in constraints)
        for transaction in world_state.transaction_sequence:
            calldata = transaction.call_data
            size = calldata.size
            size = size if isinstance(size, int) else model.eval(size)
            models.append((transaction.id, model.eval(transaction.caller),
                           size, [model.eval(calldata[i])
                                  if not isinstance(calldata[i], int)
                                  else calldata[i]
                                  for i in range(min(size, 68))]))
    return {"storage": storage, "constraints": len(constraints),
            "possible": possible, "model_holds": holds, "models": models}


def statespace(side, contract: str, mode: str, transaction_count: int,
               strategy: str, detail_limit=None) -> dict:
    """What must be equal between the packages' statespaces. Open states
    past `detail_limit` are counted but not examined one by one."""
    laser, after_tx = explore(side, contract, mode, transaction_count,
                              strategy)
    nodes = {uid: (node.contract_name, node.start_addr, node.function_name,
                   [flag.name for flag in node.flags])
             for uid, node in laser.nodes.items()}
    edges = [(edge.node_from, edge.node_to, edge.type.name)
             for edge in laser.edges]
    open_states = laser.open_states[:detail_limit]
    states = [open_state_record(side, ws) for ws in open_states]
    pipeline = side.solver._pipeline
    pool = [] if pipeline is None else pipeline.blaster.clauses
    return {"total_states": laser.total_states, "timed_out": laser.timed_out,
            "nodes": nodes, "edges": edges, "after_tx": after_tx,
            "open_states": len(laser.open_states), "states": states,
            "pool": hashlib.sha256(repr(pool).encode()).hexdigest()}


def first_difference(space, want, keys):
    """The first differing element of the first differing key."""
    got, expected = space[keys[0]], want[keys[0]]
    if isinstance(got, list) and isinstance(expected, list):
        for index, (a, b) in enumerate(zip(got, expected)):
            if a != b:
                return keys[0], index, a, b
    return keys[0], got, expected


def check_statespace(contract, mode, transaction_count, strategy,
                     detail=None):
    """The statespace on both packages; returns the port's. The CDCL's
    models are held equal where the two packages blasted the same clause
    pool (one C++ source on the same clauses); where the pools' order
    differs (it depends on the process, ROADMAP C), each model is held to
    its own path constraints instead."""
    observed = run_both(statespace, contract, mode, transaction_count,
                        strategy, detail)
    space, want = observed["port"], observed["jax"]
    if space.pop("pool") != want.pop("pool"):
        for state in space["states"] + want["states"]:
            del state["models"]
    differ = sorted(key for key in space if space[key] != want[key])
    assert not differ, (differ, first_difference(space, want, differ))
    assert all(state["model_holds"] in (True, None)
               for state in space["states"])
    assert space["timed_out"] is False
    assert len(space["after_tx"]) == transaction_count
    assert space["open_states"] == space["after_tx"][-1] > 0
    # the last transaction's open states are not pruned: some may be
    # infeasible, as in the reference
    assert any(state["possible"] for state in space["states"])
    return space


def statespace_counts(side, contract: str, mode: str, transaction_count: int,
                      strategy: str = "dfs") -> dict:
    """The counts chip_smoke.py's host_engine phase holds to
    EXPECTED_HOST_ENGINE."""
    laser, after_tx = explore(side, contract, mode, transaction_count,
                              strategy)
    assert not laser.timed_out
    return {"states": laser.total_states, "nodes": len(laser.nodes),
            "edges": len(laser.edges), "open_after_tx": after_tx}


# ---- concrete message calls ----------------------------------------------------------

#: the callee of a concrete call, and its caller
CALLEE = 0x0ACE000000000000000000000000000000000001
CALLER = 0xCAFE


def concrete_call(side, code: bytes, calldata: bytes = b"",
                  storage=None, caller: int = CALLER,
                  gas_limit: int = 10_000_000, gas_binding: bool = False):
    """Run one concrete message call through the host interpreter
    (core/transaction/concolic.execute_message_call). Returns the laser,
    the outer transaction's end (None when it raised) and, with
    `gas_binding`, {GAS symbol: the lower-bound gas left} for every GAS it
    executed: the host models GAS as a fresh symbol, the step kernels push
    the gas limit less the lower-bound gas used, and the host accounts the
    same lower bound in `min_gas_used`."""
    world_state = side.state.WorldState()
    account = world_state.create_account(balance=10 ** 18, address=CALLEE,
                                         concrete_storage=True)
    account.code = side.Disassembly(code.hex())
    for slot, value in (storage or {}).items():
        account.storage[bv(side, slot)] = bv(side, value)
    world_state.create_account(balance=2 ** 128, address=caller)
    laser = side.svm.LaserEVM(max_depth=8000, execution_timeout=BUDGET_S,
                              requires_statespace=False)
    laser.open_states = [world_state]
    ends = []

    def on_end(global_state, transaction, return_global_state, revert):
        if return_global_state is None:
            data = transaction.return_data
            ends.append({"revert": revert, "data": None if data is None else
                         [value_of(byte) if not isinstance(byte, int) else byte
                          for byte in data.return_data]})

    laser.register_laser_hooks("transaction_end", on_end)
    gas = {}
    if gas_binding:
        def on_gas(state):
            symbol = state.mstate.stack[-1]
            gas[symbol.raw] = state.mstate.gas_limit - state.mstate.min_gas_used

        laser.register_instr_hooks("post", "GAS", on_gas)
    side.concolic.execute_message_call(
        laser, callee_address=CALLEE, caller_address=caller,
        origin_address=caller, value=0, data=list(calldata),
        gas_limit=gas_limit, gas_price=1)
    return laser, (ends[0] if ends else None), gas


def post_storage(side, laser, gas=None) -> dict:
    """The callee's storage writes after a concrete call, as {slot: value};
    a GAS symbol in a value is bound to its lower-bound reading."""
    if not laser.open_states:
        return {}
    storage = laser.open_states[0].accounts[CALLEE].storage
    return {bound(side, key, gas): bound(side, value, gas)
            for key, value in storage.printable_storage.items()}


def post_transient(side, laser, slots, gas=None) -> dict:
    """The callee's transient storage at `slots` after a concrete call."""
    if not laser.open_states:
        return {}
    world_state = laser.open_states[0]
    address = world_state.accounts[CALLEE].address
    return {slot: bound(side, world_state.transient_storage.get(
                address, bv(side, slot)), gas)
            for slot in slots}


def bound(side, expression, gas=None):
    """A BitVec's value, with the GAS symbols of `gas` bound; an
    expression that stays symbolic comes back as sorted tokens."""
    raw = expression.raw
    if raw.is_const:
        return raw.value
    if gas:
        try:
            return side.smt.terms.evaluate(raw, gas)
        except KeyError:  # a symbol other than GAS's
            pass
    return tokens(str(raw))


# ---- analyses and their reports -----------------------------------------------------

#: the CLI's strategy and budgets neither side reaches; the analyzer's
#: own defaults are the CLI's (mythril_tpu/interfaces/cli.py:22-173)
ANALYZE_DEFAULTS = dict(strategy="bfs", execution_timeout=BUDGET_S,
                        create_timeout=BUDGET_S)

#: the fields of an issue compared exactly
ISSUE_FIELDS = ("swc-id", "title", "severity", "contract", "function",
                "address", "min_gas_used", "max_gas_used", "sourceMap")


def analyze_report(side, code: bytes, modules=None, transaction_count=2,
                   bin_runtime=False, **options) -> dict:
    """`analyze` through one side's MythrilAnalyzer, as its CLI runs it:
    the `-o json` report as a dict, the blast pool's digest, the
    analyzer's own objects for the tests that read them and the side's
    metric snapshot (the run starts from a reset registry: `fresh`)."""
    disassembler = side.mythril.MythrilDisassembler()
    address, _ = disassembler.load_from_bytecode(code.hex(), bin_runtime)
    cmd = SimpleNamespace(**{**ANALYZE_DEFAULTS, **options})
    analyzer = side.mythril.MythrilAnalyzer(
        disassembler, cmd_args=cmd, strategy=cmd.strategy, address=address)
    report = analyzer.fire_lasers(modules=modules,
                                  transaction_count=transaction_count)
    pipeline = side.solver._pipeline
    pool = [] if pipeline is None else pipeline.blaster.clauses
    plugins = dict(side.plugin.LaserPluginLoader().plugin_list)
    return {"json": json.loads(report.as_json()),
            "exceptions": list(report.exceptions),
            "pool": hashlib.sha256(repr(pool).encode()).hexdigest(),
            "plugins": plugins, "metrics": side.metrics.snapshot()}


def report_view(report: dict) -> dict:
    """What two reports must share exactly: every issue's identity fields,
    in order, its description as sorted tokens (symbolic text depends on
    the process), its steps and their callees and the accounts of its
    initial state; and whether the analysis was complete."""
    issues = []
    for issue in report["issues"]:
        sequence = issue["tx_sequence"] or {"steps": [], "initialState": {}}
        accounts = sequence["initialState"].get("accounts", {})
        issues.append({
            **{field: issue[field] for field in ISSUE_FIELDS},
            "description": tokens(issue["description"]),
            "steps": [step["address"] for step in sequence["steps"]],
            "accounts": {address: (account["nonce"], account["code"],
                                   account["storage"])
                         for address, account in accounts.items()}})
    return {"success": report["success"], "error": report["error"],
            "issues": issues, "incomplete": report.get("incomplete", False),
            "coverage": report.get("coverage")}


def witness(report: dict) -> list:
    """The model-dependent part of a report: every step's input, value,
    origin and gas price, and the initial balances."""
    out = []
    for issue in report["issues"]:
        sequence = issue["tx_sequence"] or {"steps": [], "initialState": {}}
        out.append((
            [(step["input"], step["value"], step["origin"], step["gasPrice"])
             for step in sequence["steps"]],
            {address: account["balance"] for address, account in
             sequence["initialState"].get("accounts", {}).items()}))
    return out


def replay_reaches(steps, initial_accounts, address: int) -> bool:
    """Replay a witness concretely on the port's host engine
    (core/transaction/concolic) and say whether its last step executes
    the instruction at `address`. A witness that starts with a creation
    runs it on an empty world; one that starts with a call runs on the
    initial state's accounts, their storage symbolic as the analyzer
    leaves a deployed contract's."""
    side = PORT
    world_state = side.state.WorldState()
    if steps and steps[0]["address"] != "":
        for key, account in initial_accounts.items():
            created = world_state.create_account(
                balance=int(account["balance"], 16), address=int(key, 16),
                concrete_storage=False)
            created.code = side.Disassembly(account["code"][2:])
            created.nonce = account["nonce"]
    laser = side.svm.LaserEVM(max_depth=8000, execution_timeout=BUDGET_S,
                              requires_statespace=False)
    laser.open_states = [world_state]
    reached = []
    laser.register_laser_hooks(
        "execute_state",
        lambda state: reached[-1].add(
            state.get_current_instruction()["address"]))
    for step in steps:
        reached.append(set())
        data = bytes.fromhex(step["input"][2:])
        value, origin = int(step["value"], 16), int(step["origin"], 16)
        gas = dict(gas_limit=int(step["gasLimit"], 16),
                   gas_price=int(step["gasPrice"], 16))
        if step["address"] == "":
            side.concolic.execute_contract_creation(
                laser, None, origin, value, [], code=data.hex(),
                origin_address=origin, **gas)
        else:
            side.concolic.execute_message_call(
                laser, int(step["address"], 16), origin, value, list(data),
                origin_address=origin, **gas)
    return bool(reached) and address in reached[-1]


def report_parity(port: dict, jax: dict, same_pool: bool) -> None:
    """The port's report against the JAX package's: `report_view` exactly;
    the witness exactly where both sides blasted the same clause pool (one
    CDCL on the same clauses), else each of the port's witnesses replayed
    concretely on the port's engine must reach its issue's address (the
    CNF, and so the model, depends on the process: ROADMAP C)."""
    assert report_view(port) == report_view(jax)
    if same_pool:
        assert witness(port) == witness(jax)
        return
    for issue in port["issues"]:
        sequence = issue["tx_sequence"]
        assert replay_reaches(sequence["steps"],
                              sequence["initialState"]["accounts"],
                              issue["address"]), issue
