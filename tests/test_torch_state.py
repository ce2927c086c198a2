"""The port's state model and instruction interpreter
(mythril_tpu_torch/core/{state,instructions,natives,call,cheat_code,
transaction,strategy/bounded_loops}) against the JAX package's: every
case of tests/test_instructions.py and tests/test_bounded_loops.py,
`module_screen.should_skip_site` on GlobalStates, the ten precompiles,
concrete message calls, and the host interpreter against the K2 twin
(`lockstep.step_many` on the CPU) on chip_smoke.py's mixed program.

Each case is written once over a side (tests/_torch_engine.py) and runs on
both packages from fresh counters and solver caches, with the reference
test's own assertions inside; the observations must be equal."""

import hashlib
from types import SimpleNamespace

import numpy as np
import pytest

from _torch_engine import (JAX, PORT, assert_parity, bv, concrete_call,
                           make_state, post_storage, post_transient, push,
                           run_both, run_op, value_of)
from chip_smoke import (MIXED_SOURCE, MIXED_TRANSIENT_SLOTS, host_lane as
                        smoke_host_lane, lane_tables, mixed_specs)
from mythril_tpu.parallel.frontier import LoopHintAnnotation as JLoopHint
from mythril_tpu_torch.frontends.asm import assemble
from mythril_tpu_torch.parallel import batch as tb
from mythril_tpu_torch.parallel import lockstep
from mythril_tpu_torch.parallel.frontier import LoopHintAnnotation as PLoopHint

M = 2 ** 256


# ---- tests/test_instructions.py --------------------------------------------------

BINARY_OPS = [
    ("ADD", [3, 5], (3 + 5)),
    ("ADD", [M - 1, 2], 1),
    ("SUB", [3, 5], 5 - 3 + M),
    ("MUL", [7, 9], 63),
    ("DIV", [2, 10], 5),
    ("DIV", [0, 10], 0),
    ("SDIV", [M - 2, 10], M - 5),
    ("MOD", [3, 10], 1),
    ("MOD", [0, 10], 0),
    ("SMOD", [3, M - 10], M - 1),
    ("ADDMOD", [5, M - 1, M - 1], (((M - 1) + (M - 1)) % 5)),
    ("MULMOD", [5, M - 1, M - 1], (((M - 1) * (M - 1)) % 5)),
    ("EXP", [3, 2], 8),
    ("SIGNEXTEND", [0xFF, 0], M - 1),
    ("SIGNEXTEND", [0x7F, 0], 0x7F),
    ("LT", [5, 3], 1),
    ("GT", [5, 3], 0),
    ("SLT", [1, M - 1], 1),
    ("SGT", [1, M - 1], 0),
    ("EQ", [4, 4], 1),
    ("ISZERO", [0], 1),
    ("AND", [0b1100, 0b1010], 0b1000),
    ("OR", [0b1100, 0b1010], 0b1110),
    ("XOR", [0b1100, 0b1010], 0b0110),
    ("NOT", [0], M - 1),
    ("BYTE", [0xAABB, 31], 0xBB),
    ("BYTE", [0xAABB, 30], 0xAA),
    ("BYTE", [0xAABB, 32], 0),
    ("SHL", [1, 4], 16),
    ("SHR", [16, 4], 1),
    ("SAR", [M - 16, 4], M - 1),
    ("SHL", [1, 256], 0),
]


def binary_op(s, op, inputs, expected):
    state = make_state(s)
    push(s, state, *inputs)
    result = run_op(s, state, op)
    assert len(result) == 1
    top = result[0].mstate.stack[-1]
    assert top.raw.is_const, f"{op} result symbolic: {top}"
    assert top.value == expected % M
    return [top.value, result[0].mstate.pc, result[0].mstate.min_gas_used]


@pytest.mark.parametrize("op,inputs,expected", BINARY_OPS)
def test_binary_ops(op, inputs, expected):
    assert_parity(binary_op, op, inputs, expected)


def ins_stack_ops(s):
    state = make_state(s)
    push(s, state, 1, 2, 3)
    state = run_op(s, state, "DUP2")[0]
    assert state.mstate.stack[-1].value == 2
    state = run_op(s, state, "SWAP3")[0]
    assert state.mstate.stack[-1].value == 1
    state = run_op(s, state, "POP")[0]
    assert len(state.mstate.stack) == 3
    return [value_of(v) for v in state.mstate.stack]


def ins_memory_roundtrip(s):
    state = make_state(s)
    push(s, state, 0xDEADBEEF, 64)
    state = run_op(s, state, "MSTORE")[0]
    push(s, state, 64)
    state = run_op(s, state, "MLOAD")[0]
    assert state.mstate.stack[-1].value == 0xDEADBEEF
    assert state.mstate.memory_size >= 96
    return [state.mstate.memory_size, state.mstate.min_gas_used,
            state.mstate.max_gas_used]


def ins_mstore8(s):
    state = make_state(s)
    push(s, state, 0x1234, 10)
    state = run_op(s, state, "MSTORE8")[0]
    assert state.mstate.memory[10].value == 0x34
    return [state.mstate.memory_size, state.mstate.min_gas_used]


def ins_storage_roundtrip(s):
    state = make_state(s)
    push(s, state, 99, 5)
    state = run_op(s, state, "SSTORE")[0]
    push(s, state, 5)
    state = run_op(s, state, "SLOAD")[0]
    assert state.mstate.stack[-1].value == 99
    storage = state.environment.active_account.storage
    return sorted((value_of(k), value_of(v))
                  for k, v in storage.printable_storage.items())


def ins_sstore_static_protection(s):
    state = make_state(s, static=True)
    push(s, state, 99, 5)
    with pytest.raises(s.util.WriteProtection):
        run_op(s, state, "SSTORE")
    return "WriteProtection"


def ins_transient_storage(s):
    state = make_state(s)
    push(s, state, 77, 3)
    state = run_op(s, state, "TSTORE")[0]
    push(s, state, 3)
    state = run_op(s, state, "TLOAD")[0]
    assert state.mstate.stack[-1].value == 77
    return value_of(state.mstate.stack[-1])


def ins_call_to_cheat_address_succeeds(s):
    state = make_state(s)
    push(s, state, 0, 0, 0, 0, 0, s.cheat_code.hevm_cheat_code.address, 50000)
    successors = run_op(s, state, "CALL")
    assert len(successors) == 1
    retval = successors[0].mstate.stack[-1]
    constraints = successors[0].world_state.constraints
    assert any(c.raw.op == "eq"
               and retval.raw in c.raw.args
               and any(a.is_const and a.value == 1 for a in c.raw.args)
               for c in constraints), "retval must be pinned to success"
    assert not retval.raw.is_const
    return [len(successors), len(constraints), value_of(retval)]


def ins_jumpi_forks_two_ways(s):
    state = make_state(s, "0x6001600657005b00")
    condition = s.smt.symbol_factory.BitVecSym("cond", 256)
    state.mstate.stack.append(condition)
    state.mstate.stack.append(bv(s, 6))
    states = run_op(s, state, "JUMPI")
    assert len(states) == 2
    fallthrough, taken = states
    assert fallthrough.mstate.pc == state.mstate.pc + 1
    jumpdest_index = state.environment.code.index_of_address(6)
    assert taken.mstate.pc == jumpdest_index
    assert len(taken.world_state.constraints) == 1
    return [[st.mstate.pc, len(st.world_state.constraints),
             [value_of(c) for c in st.world_state.constraints]]
            for st in states]


def ins_jumpi_concrete_condition_single_branch(s):
    state = make_state(s, "0x6001600657005b00")
    push(s, state, 1, 6)
    states = run_op(s, state, "JUMPI")
    assert len(states) == 1
    assert states[0].mstate.pc == state.environment.code.index_of_address(6)
    return states[0].mstate.pc


def ins_invalid_jump_rejected(s):
    state = make_state(s, "0x600456005b00")
    push(s, state, 3)
    with pytest.raises(s.util.InvalidJumpDestination):
        run_op(s, state, "JUMP")
    return "InvalidJumpDestination"


def ins_sha3_concrete(s):
    state = make_state(s)
    push(s, state, 0xAB, 0)
    state = run_op(s, state, "MSTORE8")[0]
    push(s, state, 1, 0)
    state = run_op(s, state, "SHA3")[0]
    assert state.mstate.stack[-1].value == int.from_bytes(
        s.keccak.keccak256(b"\xab"), "big")
    return [state.mstate.stack[-1].value, state.mstate.min_gas_used]


def ins_sha3_symbolic_goes_through_uf(s):
    """The hash is an uninterpreted function of a fresh symbol: the digest
    and its axioms are compared as sorted tokens, not as text (deciding
    the axioms takes seconds a side)."""
    state = make_state(s)
    state.mstate.memory[0] = s.smt.symbol_factory.BitVecSym("mystery", 8)
    push(s, state, 1, 0)
    state = run_op(s, state, "SHA3")[0]
    digest = state.mstate.stack[-1]
    assert not digest.raw.is_const
    conditions = s.fm.keccak_function_manager.create_conditions()
    assert conditions
    return {"digest": value_of(digest),
            "conditions": [value_of(c) for c in conditions]}


def ins_calldata_ops(s):
    state = make_state(s, calldata=s.calldata.ConcreteCalldata("1", [0xAA, 0xBB]))
    push(s, state, 0)
    state = run_op(s, state, "CALLDATALOAD")[0]
    assert state.mstate.stack[-1].value >> 240 == 0xAABB
    state = run_op(s, state, "CALLDATASIZE")[0]
    assert state.mstate.stack[-1].value == 2
    return [value_of(v) for v in state.mstate.stack]


def ins_env_ops(s):
    state = make_state(s)
    seen = []
    for op, expected in [("ADDRESS", 0x1AAF), ("CALLER", 0xCAFE),
                         ("ORIGIN", 0xCAFE), ("CALLVALUE", 0),
                         ("BASEFEE", 7), ("CHAINID", 1)]:
        result = run_op(s, state, op)[0]
        value = result.mstate.stack.pop().value
        assert value == expected, op
        seen.append(value)
    return seen


def ins_selfbalance_and_balance(s):
    state = make_state(s)
    state = run_op(s, state, "SELFBALANCE")[0]
    assert state.mstate.stack[-1].value == 10 ** 18
    return state.mstate.stack[-1].value


def ins_invalid_opcode(s):
    state = make_state(s)
    with pytest.raises(s.util.InvalidInstruction):
        run_op(s, state, "INVALID")
    return "InvalidInstruction"


def ins_stop_raises_end_signal(s):
    state = make_state(s)
    with pytest.raises(s.tx.TransactionEndSignal) as signal:
        run_op(s, state, "STOP")
    return signal.value.revert


def ins_push_truncated_immediate(s):
    state = make_state(s)
    code = s.Disassembly("0x61aa")
    state.environment.code = code
    state.environment.active_account.code = code
    states = s.instructions.Instruction("PUSH2").evaluate(state)
    assert states[0].mstate.stack[-1].value == 0xAA00
    return states[0].mstate.stack[-1].value


INSTRUCTION_CASES = [ins_stack_ops, ins_memory_roundtrip, ins_mstore8,
                     ins_storage_roundtrip, ins_sstore_static_protection,
                     ins_transient_storage, ins_call_to_cheat_address_succeeds,
                     ins_jumpi_forks_two_ways,
                     ins_jumpi_concrete_condition_single_branch,
                     ins_invalid_jump_rejected, ins_sha3_concrete,
                     ins_sha3_symbolic_goes_through_uf, ins_calldata_ops,
                     ins_env_ops, ins_selfbalance_and_balance,
                     ins_invalid_opcode, ins_stop_raises_end_signal,
                     ins_push_truncated_immediate]


@pytest.mark.parametrize("case", INSTRUCTION_CASES, ids=lambda c: c.__name__[4:])
def test_instruction_case(case):
    """A test of tests/test_instructions.py on both packages."""
    assert_parity(case)


# ---- tests/test_bounded_loops.py ---------------------------------------------------

HEADER = 10


class FakeState:
    """Just enough GlobalState surface for the strategy decorator."""

    def __init__(self, address, prev_pc, annotations):
        self._instruction = {"opcode": "JUMPDEST", "address": address}
        self.annotations = annotations
        self.mstate = SimpleNamespace(prev_pc=prev_pc)
        self.environment = SimpleNamespace(code="FAKECODE")

    def get_current_instruction(self):
        return self._instruction

    def get_annotations(self, cls):
        return [a for a in self.annotations if isinstance(a, cls)]

    def annotate(self, annotation):
        self.annotations.append(annotation)


class FakeSuper:
    def __init__(self, states):
        self.states = list(states)
        self.work_list = []
        self.max_depth = 128

    def __next__(self):
        if not self.states:
            raise StopIteration
        return self.states.pop(0)


def drain(strategy):
    out = []
    while True:
        try:
            out.append(next(strategy))
        except StopIteration:
            return out


LOOP_HINT = {"jax": JLoopHint, "port": PLoopHint}


def loops_multi_back_edge(s):
    path = [s.bounded_loops.JumpdestCountAnnotation()]
    states = [FakeState(HEADER, prev_pc=20 if i % 2 else 30, annotations=path)
              for i in range(6)]
    strategy = s.bounded_loops.BoundedLoopsStrategy(FakeSuper(states),
                                                    loop_bound=3)
    admitted = len(drain(strategy))
    assert admitted == 3
    return admitted


def loops_hint_seeds_device_spent_unroll(s):
    path = [s.bounded_loops.JumpdestCountAnnotation(),
            LOOP_HINT[s.name](HEADER)]
    states = [FakeState(HEADER, prev_pc=20, annotations=path)
              for _ in range(6)]
    strategy = s.bounded_loops.BoundedLoopsStrategy(FakeSuper(states),
                                                    loop_bound=3)
    admitted = len(drain(strategy))
    assert admitted == 2
    return admitted


def loops_edge_fallback(s):
    path = [s.bounded_loops.JumpdestCountAnnotation()]
    states = [FakeState(50, prev_pc=60 if i % 2 else 70, annotations=path)
              for i in range(6)]
    strategy = s.bounded_loops.BoundedLoopsStrategy(FakeSuper(states),
                                                    loop_bound=2)
    admitted = len(drain(strategy))
    assert admitted == 4
    return admitted


def loops_non_header_body_jumpdest(s):
    path = [s.bounded_loops.JumpdestCountAnnotation()]
    states = [FakeState(20, prev_pc=15, annotations=path) for _ in range(4)]
    strategy = s.bounded_loops.BoundedLoopsStrategy(FakeSuper(states),
                                                    loop_bound=3)
    admitted = len(drain(strategy))
    assert admitted == 3
    return admitted


LOOP_CASES = [loops_multi_back_edge, loops_hint_seeds_device_spent_unroll,
              loops_edge_fallback, loops_non_header_body_jumpdest]


@pytest.mark.parametrize("case", LOOP_CASES, ids=lambda c: c.__name__[6:])
def test_bounded_loops_case(case, monkeypatch):
    """A test of tests/test_bounded_loops.py on both packages, each with
    its own module_screen's loop table patched as the reference's fixture
    patches it, and its own LoopHintAnnotation."""
    for side in (JAX, PORT):
        monkeypatch.setattr(
            side.module_screen, "loop_header_at",
            lambda code, pc: HEADER if HEADER <= pc < 40 else None)
    assert_parity(case)


# ---- module_screen.should_skip_site --------------------------------------------------

#: a constant JUMP, then a JUMP whose destination is calldata's first word
#: and a JUMPI on a constant destination with a calldata condition
SITES = """
PUSH @a
JUMP
a:
JUMPDEST
PUSH1 0x00
CALLDATALOAD
PUSH @b
JUMPI
PUSH1 0x04
CALLDATALOAD
JUMP
b:
JUMPDEST
STOP
"""


class ArbitraryJumpSinks:
    """A detection module's declared sinks: a jump's destination
    (mythril_tpu/analysis/modules/arbitrary_jump.py:32)."""

    taint_sinks = {"JUMP": (0,), "JUMPI": (0,)}


def skip_sites(s):
    code = s.asm.assemble(SITES)
    state = make_state(s, "0x" + code.hex())
    verdicts = []
    for index, instruction in enumerate(state.environment.code.instruction_list):
        if instruction.op_code not in ("JUMP", "JUMPI"):
            continue
        state.mstate.pc = index
        verdicts.append((instruction.address, instruction.op_code,
                         s.module_screen.should_skip_site(
                             ArbitraryJumpSinks(), instruction.op_code, state)))
    # an undeclared op and a state without code run the hook
    state.mstate.pc = 0
    verdicts.append(s.module_screen.should_skip_site(
        ArbitraryJumpSinks(), "SSTORE", state))
    verdicts.append(s.module_screen.should_skip_site(
        ArbitraryJumpSinks(), "JUMP", SimpleNamespace()))
    return verdicts


def test_should_skip_site_on_global_states():
    """The constant jumps are screened out, the calldata jump is not."""
    verdicts = assert_parity(skip_sites)
    jumps = [v for v in verdicts if isinstance(v, tuple)]
    assert [v[2] for v in jumps] == [True, True, False]
    assert verdicts[-2:] == [False, False]


# ---- the precompiles ------------------------------------------------------------------

def word(value: int) -> bytes:
    return value.to_bytes(32, "big")


#: go-ethereum's ecrecover vector (core/vm/contracts_test.go)
ECRECOVER = bytes.fromhex(
    "456e9aea5e197a1f1af7a3e85a3212fa4049a3ba34c2289b4c860fc0b0c64ef3"
    "000000000000000000000000000000000000000000000000000000000000001c"
    "9242685bf161793cc25603c231bc2f568eb630ea16aa137d2664ac8038825608"
    "4f8ae3bd7535248d0bd448298cc2e2071e56992d0774dc340c368ae950852ada")
BN_G1 = word(1) + word(2)
BN_G2 = bytes.fromhex(
    "198e9393920d483a7260bfb731fb5d25f1aa493335a9e71297e485b7aef312c2"
    "1800deef121f1e76426a00665e5c4479674322d4f75edadd46debd5cd992f6ed"
    "090689d0585ff075ec9e99ad690c3395bc4b313370b38ef355acdadcd122975b"
    "12c85ea5db8c6deb4aab71808dcb408fe3d1e7690c43d37b4ce6cc0166fa7daa")
BN_P = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47


def blake2_input(rng) -> bytes:
    return ((12).to_bytes(4, "big") + rng.bytes(64) + rng.bytes(128)
            + rng.bytes(16) + b"\x01")


PRECOMPILE_INPUTS = {
    "ecrecover": (1, ECRECOVER),
    "ecrecover_invalid_v": (1, ECRECOVER[:32] + word(29) + ECRECOVER[64:]),
    "ecrecover_zero_r": (1, ECRECOVER[:64] + word(0) + ECRECOVER[96:]),
    "sha256": (2, b"mythril"),
    "ripemd160": (3, b"mythril"),
    "identity": (4, bytes(range(40))),
    "mod_exp": (5, word(1) + word(1) + word(1) + b"\x03\xff\x07"),
    "mod_exp_wide": (5, word(32) + word(32) + word(32) + word(BN_P - 2)
                     + word(BN_P - 1) + word(BN_P)),
    "ec_add": (6, BN_G1 + BN_G1),
    "ec_add_off_curve": (6, word(1) + word(3) + BN_G1),
    "ec_mul": (7, BN_G1 + word(2)),
    "ec_mul_off_curve": (7, word(1) + word(3) + word(2)),
    "ec_pair_empty": (8, b""),
    "ec_pair_one": (8, BN_G1 + BN_G2),
    "blake2b_fcompress": (9, blake2_input(np.random.default_rng(15))),
    "blake2b_bad_length": (9, b"\x00" * 10),
    "point_evaluation": (10, b"\x00" * 192),
}


def precompile(s, name):
    address, data = PRECOMPILE_INPUTS[name]
    try:
        return list(s.natives.native_contract(address, data))
    except Exception as error:  # the two packages' classes of one name
        return type(error).__name__


@pytest.mark.parametrize("name", sorted(PRECOMPILE_INPUTS))
def test_precompile(name):
    """Each precompile (natives.py:252-255) on fixed inputs, an invalid
    ecrecover signature and bn128 points off the curve included."""
    out = assert_parity(precompile, name)
    if name == "ecrecover":
        assert out[-20:] == list(bytes.fromhex(
            "7156526fbd7a3c72969b54f64e42c10fbb768c8a"))
    if name == "sha256":
        assert out == list(hashlib.sha256(b"mythril").digest())


def test_ripemd160_matches_hashlib():
    """The port keeps the reference's hashlib ripemd160: where this
    Python has it, both give the hashlib digest."""
    digest = hashlib.new("ripemd160", b"mythril").digest()
    out = PORT.natives.native_contract(3, b"mythril")
    assert out == [0] * 12 + list(digest)


# ---- concrete message calls ------------------------------------------------------------

CONCRETE_PROGRAMS = {
    "arithmetic": ("PUSH1 0x07\nPUSH1 0x05\nMUL\nPUSH1 0x03\nSWAP1\nSUB\n"
                   "PUSH1 0x00\nSSTORE\nPUSH1 0x02\nPUSH1 0x00\nCALLDATALOAD\n"
                   "EXP\nPUSH1 0x01\nSSTORE\nSTOP", word(10)),
    "memory_sha3": ("PUSH1 0x00\nCALLDATALOAD\nPUSH1 0x20\nMSTORE\n"
                    "PUSH1 0x40\nPUSH1 0x00\nSHA3\nPUSH1 0x02\nSSTORE\n"
                    "PUSH1 0x20\nMLOAD\nPUSH1 0x03\nSSTORE\nSTOP",
                    word(0xDEADBEEF)),
    "storage_update": ("PUSH1 0x00\nSLOAD\nPUSH1 0x01\nADD\nDUP1\n"
                       "PUSH1 0x00\nSSTORE\nPUSH1 0x00\nMSTORE\n"
                       "PUSH1 0x20\nPUSH1 0x00\nRETURN", b""),
    "transient": ("PUSH1 0x2a\nPUSH1 0x05\nTSTORE\nPUSH1 0x05\nTLOAD\n"
                  "PUSH1 0x06\nTLOAD\nADD\nPUSH1 0x04\nSSTORE\nSTOP", b""),
    "call_sha256": ("PUSH1 0x00\nCALLDATALOAD\nPUSH1 0x00\nMSTORE\n"
                    "PUSH1 0x20\nPUSH1 0x40\nPUSH1 0x20\nPUSH1 0x00\n"
                    "PUSH1 0x00\nPUSH1 0x02\nPUSH2 0xffff\nCALL\n"
                    "PUSH1 0x05\nSSTORE\nPUSH1 0x40\nMLOAD\nPUSH1 0x06\n"
                    "SSTORE\nRETURNDATASIZE\nPUSH1 0x07\nSSTORE\nSTOP",
                    word(12345)),
    "revert": ("PUSH1 0x01\nPUSH1 0x00\nSSTORE\nPUSH1 0xee\nPUSH1 0x00\n"
               "MSTORE8\nPUSH1 0x01\nPUSH1 0x00\nREVERT", b""),
    "invalid": ("PUSH1 0x01\nPUSH1 0x00\nSSTORE\nINVALID", b""),
}


def concrete_program(s, name):
    source, calldata = CONCRETE_PROGRAMS[name]
    code = s.asm.assemble(source)
    laser, end, _ = concrete_call(s, code, calldata, storage={0: 41})
    return {"storage": post_storage(s, laser),
            "transient": post_transient(s, laser, [5, 6]),
            "end": end, "open_states": len(laser.open_states)}


@pytest.mark.parametrize("name", sorted(CONCRETE_PROGRAMS))
def test_concrete_message_call(name):
    """core/transaction/concolic.execute_message_call on both packages:
    post-storage, transient storage, return data and how the call ended."""
    out = assert_parity(concrete_program, name)
    if name in ("revert", "invalid"):
        assert out["open_states"] == 0
    else:
        assert out["open_states"] == 1 and out["storage"]
    if name == "call_sha256":
        assert out["storage"][6] == int.from_bytes(
            hashlib.sha256(word(12345)).digest(), "big")


# ---- the host interpreter against the K2 twin ------------------------------------------

def host_lane(side, spec):
    """One LaneSpec through the side's host interpreter: the callee's
    storage and transient storage, GAS bound to its lower-bound reading."""
    laser, end, gas = concrete_call(side, spec.code, spec.calldata,
                                    storage=spec.storage, caller=spec.caller,
                                    gas_limit=spec.gas_limit,
                                    gas_binding=True)
    return {"storage": post_storage(side, laser, gas),
            "transient": post_transient(side, laser, MIXED_TRANSIENT_SLOTS, gas),
            "end": None if end is None else end["revert"]}


def test_host_interpreter_matches_the_step_twin():
    """chip_smoke.py's mixed program at 8 lanes: every lane the step does
    not escape ends with the same storage and transient storage in the
    port's host interpreter as in `lockstep.step_many` on the CPU twin,
    and the JAX package's host interpreter agrees with the port's, and
    chip_smoke.py's `host_lane` (phase host_engine) with both."""
    specs = mixed_specs(8)
    assert specs[0].code == assemble(MIXED_SOURCE)
    state = lockstep.step_many(tb.build_batch(specs, device="cpu"), 256)
    status = state.status.tolist()
    assert set(status) <= {tb.RETURNED, tb.ESCAPED}
    compared = 0
    for lane, spec in enumerate(specs):
        observed = run_both(host_lane, spec)
        assert observed["port"] == observed["jax"], lane
        if status[lane] == tb.ESCAPED:
            continue
        host = observed["port"]
        assert host["end"] is False, lane
        tables = {"storage": host["storage"], "transient": host["transient"]}
        assert tables == lane_tables(state, lane) == smoke_host_lane(spec), lane
        compared += 1
    assert compared >= 6
