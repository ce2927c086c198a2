"""The port's static analysis (mythril_tpu_torch: staticanalysis/,
frontends/disassembler.py and evmcontract.py, support/signatures.py and
support_args.py, analysis/module_screen.py, smt/solver/cfa_screen.py)
against the JAX package's, and the JAX package's pure-analysis cases run
against the port's copies.

Parity: on the same bytecode the port's disassembly, `CfaResult`
(`dataclasses.asdict`, blocks included), `TaintResult` (every field, the
sink sites by `SinkSite.to_json`), `ContractSummary.to_json` (after a JSON
round trip) and `AbsintResult.to_json` equal the JAX package's exactly.
Inputs: the fixed programs of tests/test_cfa.py, test_absint.py and
test_taint.py; their random program generators (imported, at a few
seeds); chip_smoke.py's contracts; the vendored KILLBILLY and BECTOKEN
dispatchers; and the corpus contracts when the reference corpus is on
disk (`test_cfa._corpus_bytecodes`).

Reference cases: tests/test_cfa.py :69-354, test_absint.py :213-448 and
test_taint.py :162-340 and :485, with the JAX knobs replaced by the
port's keyword arguments and pass switches (`staticanalysis.ENABLED`).
The assertions on the JAX package's metric registry are left out (the
port has none yet); the cases that need the host engine, the cfaview CLI
or the serve warm set wait (ROADMAP A 6b, 12, 14)."""

import dataclasses
import json
import random

import pytest

import chip_smoke
import test_absint
import test_cfa
import test_taint
from mythril_tpu import staticanalysis as jsa
from mythril_tpu.frontends.asm import assemble, dispatcher
from mythril_tpu.frontends.disassembler import Disassembly as JDisassembly
from mythril_tpu.utils.helpers import sha3 as jax_sha3
from mythril_tpu_torch import staticanalysis as sa
from mythril_tpu_torch.analysis import module_screen
from mythril_tpu_torch.frontends.asm import assemble as port_assemble
from mythril_tpu_torch.frontends.asm import dispatcher as port_dispatcher
from mythril_tpu_torch.frontends.disassembler import (Disassembly,
                                                      find_op_code_sequence)
from mythril_tpu_torch.frontends.evmcontract import EVMContract
from mythril_tpu_torch.smt.solver import cfa_screen
from mythril_tpu_torch.staticanalysis.absint import AbsintResult, contains
from mythril_tpu_torch.staticanalysis.taint import (TAG_CALLER, TAG_STORAGE,
                                                    TAG_UNKNOWN)
from mythril_tpu_torch.support.signatures import SignatureDB
from mythril_tpu_torch.support.support_args import args
from tools.measure_headline import BECTOKEN, KILLBILLY


@pytest.fixture(autouse=True)
def _switches_restored():
    saved = (dict(sa.ENABLED), args.cfa, args.taint, args.absint)
    yield
    sa.ENABLED.update(saved[0])
    args.cfa, args.taint, args.absint = saved[1:]


# ---- the programs ---------------------------------------------------------------------

#: the inline programs of tests/test_cfa.py's synthetic cases
CFA_PROGRAMS = {
    "diamond": test_cfa.DIAMOND,
    "backedge": """
PUSH1 0x05
head:
JUMPDEST
PUSH1 0x01
SWAP1
SUB
DUP1
PUSH @head
JUMPI
POP
STOP
""",
    "dead_code": """
PUSH @end
JUMP
PUSH1 0xFF
PUSH1 0xEE
POP
POP
end:
JUMPDEST
STOP
""",
    "fan_out": """
PUSH1 0x00
CALLDATALOAD
JUMP
a:
JUMPDEST
STOP
b:
JUMPDEST
STOP
""",
    "dup_swap_mask": """
PUSH2 0x0FFF
PUSH @end
AND
PUSH1 0x2a
SWAP1
JUMP
end:
JUMPDEST
POP
STOP
""",
    "invalid_target": "PUSH1 0x01\nJUMP\nJUMPDEST\nSTOP",
    "pc_constant": """
PC
PUSH1 0x03
ADD
JUMP
JUMPDEST
STOP
""",
    "budget": "\n".join(["JUMPDEST"] * 40) + "\nSTOP",
}

CREATE_SOURCE = "PUSH1 0x00\nDUP1\nDUP1\nCREATE\nPOP\nSTOP"


def _programs():
    """name -> runtime bytecode of every parity input."""
    programs = {f"cfa_{name}": assemble(source)
                for name, source in CFA_PROGRAMS.items()}
    for name in ("UNBOUNDED_LOOP", "COUNTING_LOOP", "ALWAYS_TAKEN",
                 "NEVER_TAKEN", "DIAMOND_ASM"):
        programs[f"absint_{name.lower()}"] = assemble(
            getattr(test_absint, name))
    programs["absint_branchy_mem"] = assemble(dispatcher(
        test_absint.BRANCHY_MEM))
    programs["absint_diamond_bothwrite"] = test_absint.DIAMOND_BOTHWRITE
    programs["taint_mini"] = assemble(dispatcher(test_taint.MINI))
    programs["taint_loop"] = assemble(test_taint.LOOP)
    programs["taint_create"] = assemble(CREATE_SOURCE)
    rng = random.Random(0xab51)
    for trial in range(4):
        programs[f"absint_random{trial}"] = assemble(
            test_absint._random_program(rng))
    rng = random.Random(0x7A1)
    for trial in range(4):
        programs[f"taint_random{trial}"] = assemble(
            test_taint._random_program(rng)[0])
    stress = {"branchy12": chip_smoke.branchy_contract(chip_smoke.N_BRANCHES),
              "mem_branchy8": chip_smoke.mem_branchy_contract(
                  chip_smoke.MERGE_BRANCHES)}
    for name, body in stress.items():
        programs[f"smoke_{name}"] = assemble(dispatcher({"stress()": body}))
    programs["smoke_planes"] = assemble(dispatcher(
        {"planes()": chip_smoke.PLANES_SOURCE}))
    programs["smoke_mixed"] = assemble(chip_smoke.MIXED_SOURCE)
    programs["smoke_killbilly"] = assemble(dispatcher(chip_smoke.KILLBILLY))
    programs["smoke_bench_loop"] = chip_smoke.BENCH_LOOP
    programs["killbilly"] = assemble(dispatcher(KILLBILLY))
    programs["bectoken"] = assemble(dispatcher(BECTOKEN))
    for name, code_hex in test_cfa._corpus_bytecodes():
        programs[f"corpus_{name}"] = bytes.fromhex(
            code_hex[2:] if code_hex.startswith("0x") else code_hex)
    return programs


PROGRAMS = _programs()


def _json(doc):
    return json.loads(json.dumps(doc))


def _taint_fields(result):
    return {"sink_sites": {pc: site.to_json()
                           for pc, site in result.sink_sites.items()},
            "reachable_ops": result.reachable_ops, "rounds": result.rounds,
            "converged": result.converged}


# ---- parity with the JAX package --------------------------------------------------

@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_analyses_match_jax(name):
    """Disassembly, CFA, taint, summary and absint of one program equal
    the JAX package's exactly."""
    code = PROGRAMS[name]
    ref, dis = JDisassembly(code.hex()), Disassembly(code.hex())
    assert [ins.to_dict() for ins in dis.instruction_list] \
        == [ins.to_dict() for ins in ref.instruction_list]
    assert (dis.func_hashes, dis.function_name_to_address,
            dis.address_to_function_name, dis.function_name_to_hash) \
        == (ref.func_hashes, ref.function_name_to_address,
            ref.address_to_function_name, ref.function_name_to_hash)
    assert dis.valid_jump_destinations == ref.valid_jump_destinations
    ref_cfa, cfa = jsa.build_cfa(ref), sa.build_cfa(dis)
    assert (cfa is None) == (ref_cfa is None)
    if cfa is None:
        return
    assert dataclasses.asdict(cfa) == dataclasses.asdict(ref_cfa)
    ref_taint = jsa.build_taint(ref_cfa, ref.instruction_list)
    taint = sa.build_taint(cfa, dis.instruction_list)
    assert (taint is None) == (ref_taint is None)
    if taint is not None:
        assert _taint_fields(taint) == _taint_fields(ref_taint)
    ref_summary = jsa.build_summary(ref, ref_cfa)
    summary = sa.build_summary(dis, cfa)
    assert (summary is None) == (ref_summary is None)
    if summary is not None:
        assert _json(summary.to_json()) == _json(ref_summary.to_json())
    ref_absint = jsa.build_absint(ref, ref_cfa)
    absint = sa.build_absint(dis, cfa)
    assert _json(absint.to_json()) == _json(ref_absint.to_json())


@pytest.mark.parametrize("budget", [
    {"tracked_depth": 4}, {"max_blocks": 8}, {"max_iters": 1},
    {"slot_budget": 1}, {"absint_iters": 2, "mem_regions": 1}],
    ids=["depth", "blocks", "taint_rounds", "slots", "absint_budgets"])
def test_budgets_match_jax(budget):
    """The keyword budgets that replace the JAX knobs give what the JAX
    passes give at the same budgets."""
    def pick(*keys):
        return {key: budget[key] for key in keys if key in budget}

    cfa_args = pick("tracked_depth", "max_blocks")
    depth = pick("tracked_depth")
    for name in ("killbilly", "bectoken", "taint_mini", "absint_counting_loop",
                 "smoke_mem_branchy8", "cfa_budget"):
        code = PROGRAMS[name]
        ref, dis = JDisassembly(code.hex()), Disassembly(code.hex())
        ref_cfa = jsa.build_cfa(ref, **cfa_args)
        cfa = sa.build_cfa(dis, **cfa_args)
        assert (cfa is None) == (ref_cfa is None), name
        if cfa is None:
            continue
        assert dataclasses.asdict(cfa) == dataclasses.asdict(ref_cfa), name
        if "mem_regions" in budget:
            absint_args = {**depth, "max_iters": budget["absint_iters"],
                           "mem_regions": budget["mem_regions"]}
            ref_absint = jsa.build_absint(ref, ref_cfa, **absint_args)
            absint = sa.build_absint(dis, cfa, **absint_args)
            assert _json(absint.to_json()) == _json(ref_absint.to_json())
            continue
        taint_args = {**depth, **pick("max_iters", "slot_budget")}
        ref_taint = jsa.build_taint(ref_cfa, ref.instruction_list,
                                    **taint_args)
        taint = sa.build_taint(cfa, dis.instruction_list, **taint_args)
        assert (taint is None) == (ref_taint is None), name
        if taint is not None:
            assert _taint_fields(taint) == _taint_fields(ref_taint), name


def test_disassembler_surface_matches_jax():
    """Selector recovery names, `find_op_code_sequence`, the easm text and
    `get_function_info` on the vendored dispatchers."""
    from mythril_tpu.frontends import disassembler as jdis

    pattern = [["PUSH4"], ["EQ"]]
    for name in ("killbilly", "bectoken", "taint_mini"):
        code = PROGRAMS[name]
        ref, dis = JDisassembly("0x" + code.hex()), Disassembly(code)
        assert dis.get_easm() == ref.get_easm()
        got = list(find_op_code_sequence(pattern, dis.instruction_list))
        assert got == list(jdis.find_op_code_sequence(
            pattern, ref.instruction_list)) and got
        for index in got:
            assert dis.get_function_info(index) \
                == ref.get_function_info(index)
    assert SignatureDB.get_sighash("transfer(address,uint256)") \
        == "0xa9059cbb"
    assert SignatureDB().get("0xa9059cbb") == ["transfer(address,uint256)"]


# ---- the CFA (tests/test_cfa.py) ------------------------------------------------------

def _cfa(source: str):
    result = sa.build_cfa(Disassembly(port_assemble(source).hex()))
    assert result is not None
    return result


def test_diamond_merge_point():
    result = _cfa(CFA_PROGRAMS["diamond"])
    assert result.fully_resolved
    [merge_pc] = result.merge_points
    assert result.valid_target_bitmap[merge_pc] == 1
    assert set(result.branch_merge_pc.values()) == {merge_pc}
    for site, targets in result.jump_targets.items():
        assert all(t in result.valid_targets for t in targets)


@pytest.mark.parametrize("name", ["backedge", "dup_swap_mask"])
def test_single_target_resolution(name):
    """The loop's back edge and a target shuffled through DUP/SWAP and an
    AND mask each resolve to one valid target."""
    result = _cfa(CFA_PROGRAMS[name])
    assert result.fully_resolved
    [(site, targets)] = list(result.jump_targets.items())
    assert len(targets) == 1
    assert targets[0] in result.valid_targets
    if name == "backedge":
        assert targets[0] < site


def test_dead_code_past_unconditional_jump():
    result = _cfa(CFA_PROGRAMS["dead_code"])
    assert result.fully_resolved
    [(_, (target,))] = list(result.jump_targets.items())
    jump_end = 4
    assert all(result.dead_mask[pc] for pc in range(jump_end, target))
    assert result.dead_bytes == target - jump_end
    assert not result.is_dead(target)
    assert not any(result.dead_mask[:jump_end])


def test_unresolvable_dynamic_jump_fans_out():
    result = _cfa(CFA_PROGRAMS["fan_out"])
    assert not result.fully_resolved
    [site] = result.unresolved_jumps
    assert result.resolved_targets(site) is None
    assert len(result.valid_targets) == 2
    assert result.dead_bytes == 0


def test_constant_targets():
    """A jump into a PUSH immediate provably throws; PC is a known
    constant."""
    [(_, targets)] = list(_cfa(CFA_PROGRAMS["invalid_target"])
                          .jump_targets.items())
    assert targets == ()
    assert _cfa(CFA_PROGRAMS["pc_constant"]).fully_resolved


def test_bail_over_block_budget():
    dis = Disassembly(port_assemble(CFA_PROGRAMS["budget"]).hex())
    assert sa.build_cfa(dis, max_blocks=8) is None
    assert sa.build_cfa(dis) is not None


def test_table_shapes_and_memoization():
    dis = Disassembly(port_assemble(CFA_PROGRAMS["diamond"]).hex())
    result = sa.get_cfa(dis)
    assert result is sa.get_cfa(dis)
    n = result.code_length
    assert len(result.pc_to_block) == n
    assert len(result.valid_target_bitmap) == n
    assert len(result.dead_mask) == n
    assert len(result.block_merge_pc) == len(result.blocks)
    assert result.exit_id == len(result.blocks)
    for block in result.blocks:
        for pc in range(block.start_pc, block.end_pc):
            assert result.pc_to_block[pc] == block.block_id
    assert {pc for pc, bit in enumerate(result.valid_target_bitmap)
            if bit} == result.valid_targets
    assert result.valid_targets <= dis.valid_jump_destinations


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_idoms_match_brute_force_on_random_graphs(seed):
    rng = random.Random(seed)
    n = rng.randint(4, 12)
    succs = [[] for _ in range(n)]
    for node in range(n):
        for _ in range(rng.randint(0, 3)):
            succs[node].append(rng.randrange(n))
    fast = sa.compute_idoms(succs, entry=0)
    dom, reachable = test_cfa._dom_sets(succs, entry=0)
    ref = test_cfa._idom_from_sets(dom, reachable, entry=0, n=n)
    assert set(sa.postorder(succs, 0)) == reachable
    for node in range(n):
        if node in reachable:
            assert fast[node] == ref[node], (seed, node, succs)
        else:
            assert fast[node] is None


def test_postdom_is_idom_on_reversed_diamond():
    succs = [[1, 2], [3], [3], [4], []]
    reverse = [[] for _ in succs]
    for node, nexts in enumerate(succs):
        for nxt in nexts:
            reverse[nxt].append(node)
    ipostdom = sa.compute_idoms(reverse, entry=4)
    assert ipostdom[0] == 3
    assert ipostdom[1] == 3 and ipostdom[2] == 3
    assert ipostdom[3] == 4
    assert sa.dominator_depth(ipostdom, 4) == [2, 2, 2, 1, 0]


def test_screen_verdicts():
    dis = Disassembly(port_assemble(CFA_PROGRAMS["diamond"]).hex())
    [merge_pc] = sa.get_cfa(dis).merge_points
    assert cfa_screen.screen_jump_target(dis, merge_pc) is True
    assert cfa_screen.screen_jump_target(dis, 0) is False
    assert cfa_screen.screen_jump_target(dis, 10_000) is None


def test_screen_agrees_with_dynamic_check_everywhere():
    for source in (CFA_PROGRAMS["diamond"],
                   port_dispatcher({"f()": "JUMPDEST\nSTOP"})):
        dis = Disassembly(port_assemble(source).hex())
        result = sa.get_cfa(dis)
        assert result.fully_resolved
        for pc in range(result.code_length):
            dynamic = (dis.index_of_address(pc) is not None
                       and dis.instruction_list[
                           dis.index_of_address(pc)].op_code == "JUMPDEST")
            static = cfa_screen.screen_jump_target(dis, pc)
            if dynamic:
                assert static is True, pc
            else:
                assert static in (False, None), pc


def test_no_cfa_flag_disables_every_verdict():
    dis = Disassembly(port_assemble(CFA_PROGRAMS["diamond"]).hex())
    args.cfa = False
    assert not cfa_screen.enabled() and not cfa_screen.absint_enabled()
    assert cfa_screen.screen_jump_target(dis, 0) is None
    assert cfa_screen.resolved_jump_targets(dis, 0) is None
    assert cfa_screen.merge_point_at(dis, 0) is None
    assert not cfa_screen.statically_dead(dis, 0)
    assert cfa_screen.block_key(dis, 7) == 7


def test_block_key_and_merge_point_follow_the_blocks():
    dis = Disassembly(port_assemble(CFA_PROGRAMS["diamond"]).hex())
    result = sa.get_cfa(dis)
    for block in result.blocks:
        if block.block_id in result.reachable:
            assert cfa_screen.block_key(dis, block.start_pc) \
                == block.start_pc
    site = next(iter(result.branch_merge_pc))
    assert cfa_screen.merge_point_at(dis, site) == result.merge_pc_at(site)
    assert cfa_screen.resolved_jump_targets(dis, site) \
        == result.resolved_targets(site)


def test_corpus_smoke_resolution_rate():
    contracts = test_cfa._corpus_bytecodes()
    assert contracts
    resolved = 0
    for name, bytecode in contracts:
        result = sa.build_cfa(Disassembly(bytecode))
        assert result is not None, name
        assert result.n_jump_sites > 0, name
        assert len(result.valid_targets) > 0, name
        resolved += bool(result.fully_resolved)
    assert resolved / len(contracts) >= 0.8, (resolved, len(contracts))


# ---- the pass switches (the JAX knobs MYTHRIL_TPU_CFA / TAINT / ABSINT) ---------------

@pytest.mark.parametrize("switch", ["cfa", "taint", "absint"])
def test_switch_disables_the_pass(switch):
    sa.ENABLED[switch] = False
    dis = _mini()
    getter = {"cfa": sa.get_cfa, "taint": sa.get_summary,
              "absint": sa.get_absint}[switch]
    assert getter(dis) is None
    assert getter(dis) is None
    if switch == "cfa":
        assert not cfa_screen.enabled()
        assert sa.get_summary(dis) is None and sa.get_absint(dis) is None
    if switch == "taint":
        assert not module_screen.enabled()
        kept, skipped = module_screen.screen_modules([object()], dis)
        assert len(kept) == 1 and skipped == []
        assert sa.get_cfa(dis) is not None
    if switch == "absint":
        assert not cfa_screen.absint_enabled()
        assert cfa_screen.jumpi_verdict(dis, 0) is None
        assert cfa_screen.merge_mem_windows(dis, 0) is None
        assert sa.get_cfa(dis) is not None


# ---- absint (tests/test_absint.py) -----------------------------------------------------

def _build(source):
    disassembly = Disassembly(port_assemble(source).hex())
    cfa = sa.build_cfa(disassembly)
    assert cfa is not None
    result = sa.build_absint(disassembly, cfa)
    assert result is not None
    return disassembly, cfa, result


def test_random_programs_intervals_are_sound():
    """Every concrete stack cell at a block entry lies in its interval and
    every concrete write in its block's proven region (test_absint's
    generator and concrete runner)."""
    rng = random.Random(0xab51)
    for _ in range(40):
        disassembly, cfa, result = _build(test_absint._random_program(rng))
        for seed in (rng.getrandbits(64), rng.getrandbits(64) | 1):
            entries, writes = test_absint._run_concrete(disassembly, cfa,
                                                        seed)
            assert entries
            for block_id, stack in entries:
                assert block_id in result.entry_intervals
                height, vals = result.entry_intervals[block_id]
                if height is not None:
                    assert len(stack) == height
                for cell in range(min(len(vals), len(stack))):
                    assert contains(vals[-1 - cell], stack[-1 - cell])
            for block_id, offset, size in writes:
                regions = result.block_writes.get(block_id)
                assert regions is None or any(
                    start <= offset and offset + size <= end
                    for start, end in regions)


def _header_pc(disassembly):
    return next(ins.address for ins in disassembly.instruction_list
                if ins.op_code == "JUMPDEST")


def test_widening_converges_on_unbounded_loop():
    disassembly, cfa, result = _build(test_absint.UNBOUNDED_LOOP)
    assert result.widenings >= 1
    assert result.iterations < 256
    _height, vals = result.entry_intervals[cfa.block_at(
        _header_pc(disassembly))]
    for value in (0, 1, 2, 1000, 10 ** 9):
        assert contains(vals[-1], value)


def test_counting_loop_bound_is_proven():
    disassembly, _cfa, result = _build(test_absint.COUNTING_LOOP)
    header = _header_pc(disassembly)
    assert result.loop_bounds == {header: 6}
    assert result.loop_bound(header) == 6
    assert result.loop_bound(header + 1) is None
    fresh = Disassembly(port_assemble(test_absint.COUNTING_LOOP).hex())
    assert cfa_screen.loop_bound_at(fresh, header) == 6


@pytest.mark.parametrize("source, verdict", [
    (test_absint.ALWAYS_TAKEN, True), (test_absint.NEVER_TAKEN, False)],
    ids=["always", "never"])
def test_const_jumpi_verdicts(source, verdict):
    disassembly, _cfa, result = _build(source)
    site = next(ins.address for ins in disassembly.instruction_list
                if ins.op_code == "JUMPI")
    assert result.jumpi_verdict(site) is verdict
    assert result.jumpi_verdict(0) is None
    fresh = Disassembly(port_assemble(source).hex())
    assert cfa_screen.jumpi_verdict(fresh, site) is verdict


def test_diamond_join_region_and_windows():
    disassembly, cfa, result = _build(test_absint.DIAMOND_ASM)
    join_pc = next(iter(cfa.branch_merge_pc.values()))
    assert result.join_regions[join_pc] == ((0, 32),)
    assert result.word_windows(join_pc) == (0,)
    assert result.word_windows(join_pc + 1) is None
    assert result.regions_proven == 1
    fresh = Disassembly(port_assemble(test_absint.DIAMOND_ASM).hex())
    assert cfa_screen.merge_mem_windows(fresh, join_pc) == (0,)
    # the join block: JUMPDEST, POP, STOP (no memory writer)
    assert cfa_screen.merge_window_pcs(fresh, join_pc) \
        == (join_pc, join_pc + 1, join_pc + 2)


def _windows_only(join_regions, cap=8):
    return AbsintResult(
        code_length=0, entry_intervals={}, block_writes={},
        join_regions=join_regions, loop_bounds={}, const_jumpis={},
        mem_regions_cap=cap)


def test_word_windows_never_overlap_and_cap():
    assert _windows_only({7: ((0, 8), (16, 40))}).word_windows(7) == (0, 32)
    assert _windows_only({7: ((4, 40),)}).word_windows(7) == (4, 36)
    spread = tuple((64 * k, 64 * k + 8) for k in range(12))
    assert _windows_only({7: spread}, cap=8).word_windows(7) is None
    assert _windows_only({7: spread}, cap=16).word_windows(7) == \
        tuple(64 * k for k in range(12))


def test_absint_json_roundtrip():
    _disassembly, cfa, result = _build(test_absint.DIAMOND_ASM)
    join_pc = next(iter(cfa.branch_merge_pc.values()))
    clone = AbsintResult.from_json(result.to_json())
    assert clone is not None
    for field in ("entry_intervals", "block_writes", "join_regions",
                  "loop_bounds", "const_jumpis"):
        assert getattr(clone, field) == getattr(result, field), field
    assert clone.word_windows(join_pc) == result.word_windows(join_pc)


@pytest.mark.parametrize("kind", ["absint", "summary"])
def test_from_json_rejects_malformed_documents(kind):
    load = (AbsintResult if kind == "absint" else sa.ContractSummary).from_json
    for doc in (None, [], {"version": -1}, {"version": 999},
                {"not": "a summary"}):
        assert load(doc) is None


def test_absint_budgets():
    """A 6-arrival loop is not proven with a 2-arrival budget; one memory
    region a join caps the windows."""
    result = sa.build_absint(
        Disassembly(port_assemble(test_absint.COUNTING_LOOP).hex()),
        max_iters=2)
    assert result is not None and result.loop_bounds == {}
    result = sa.build_absint(
        Disassembly(port_assemble(test_absint.DIAMOND_ASM).hex()),
        mem_regions=1)
    assert result is not None and result.mem_regions_cap == 1


# ---- taint and the summary (tests/test_taint.py) ------------------------------------

def test_random_programs_taint_is_sound():
    """A sink operand that changes when a source is perturbed carries the
    source's tag (test_taint's generator and concrete runner)."""
    rng = random.Random(0x7A1)
    witnessed = 0
    for _ in range(60):
        source, ops = test_taint._random_program(rng)
        dis = Disassembly(port_assemble(source).hex())
        cfa = sa.build_cfa(dis)
        result = sa.build_taint(cfa, dis.instruction_list)
        sstore_pc = next(i.address for i in dis.instruction_list
                         if i.op_code == "SSTORE")
        site = result.sink_sites[sstore_pc]
        assert site.op == "SSTORE" and len(site.operand_taint) == 2
        base = test_taint._base_env(rng)
        base_operands = test_taint._concrete_sink_operands(ops, base)
        for tag, keys in test_taint._PERTURB.items():
            perturbed = dict(base)
            for key in keys:
                perturbed[key] = (perturbed[key] * 31 + 1) \
                    & test_taint._WORD
            got = test_taint._concrete_sink_operands(ops, perturbed)
            for index in range(2):
                if got[index] != base_operands[index]:
                    witnessed += 1
                    taints = site.operand_taint[index]
                    assert tag in taints or TAG_UNKNOWN in taints, source
    assert witnessed > 30


def _mini():
    return Disassembly(port_assemble(port_dispatcher(test_taint.MINI)).hex())


def test_function_recovery_on_dispatcher():
    summary = sa.get_summary(_mini())
    names = {f.name for f in summary.functions}
    assert {"activatekillability()", "commencekilling()"} <= names
    for fn in summary.functions:
        if fn.selector is not None:
            assert fn.selector.startswith("0x") and len(fn.selector) == 10
        assert fn.blocks
    order = summary.function_order()
    assert order == tuple(sorted(order))
    assert module_screen.function_order(_mini()) == order


def test_loop_detection_on_counting_loop():
    dis = Disassembly(port_assemble(test_taint.LOOP).hex())
    [loop] = sa.get_summary(dis).loops
    jumpdest_pc = next(i.address for i in dis.instruction_list
                       if i.op_code == "JUMPDEST")
    jumpi_pc = next(i.address for i in dis.instruction_list
                    if i.op_code == "JUMPI")
    assert loop.header_pc == jumpdest_pc and loop.depth == 1
    assert jumpi_pc in loop.back_edge_pcs
    assert module_screen.loop_header_at(dis, jumpi_pc) == jumpdest_pc


def test_sink_taints_on_mini():
    """The SELFDESTRUCT beneficiary carries the caller tag; the storage
    rounds surface the storage tag on the JUMPI guarding do_kill."""
    summary = sa.get_summary(_mini())
    [site] = [s for s in summary.sink_sites.values()
              if s.op == "SELFDESTRUCT"]
    assert TAG_CALLER in site.operand_taint[0]
    assert summary.rounds >= 2 and summary.converged
    assert [s for s in summary.sink_sites.values()
            if s.op == "JUMPI" and TAG_STORAGE in s.operand_taint[1]]


def test_summary_json_roundtrip():
    summary = sa.get_summary(_mini())
    doc = summary.to_json()
    restored = sa.ContractSummary.from_json(doc)
    assert restored.to_json() == doc
    assert restored.n_sink_sites == summary.n_sink_sites
    assert restored.loop_header_of == summary.loop_header_of
    assert restored.function_of == summary.function_of


def test_get_summary_is_memoized_and_installable():
    dis = _mini()
    first = sa.get_summary(dis)
    assert sa.get_summary(dis) is first
    other = _mini()
    sa.install_summary(other, first)
    assert sa.get_summary(other) is first


def test_no_taint_flag_disables_every_consumer():
    args.taint = False
    dis = _mini()
    assert not module_screen.enabled()
    assert module_screen.summary_for(dis) is None
    assert module_screen.loop_header_at(dis, 0) is None
    assert module_screen.function_order(dis) == ()


@pytest.mark.parametrize("name", ["killbilly", "bectoken", "taint_create"])
def test_module_screen_on_the_jax_modules(name):
    """The JAX package's detection modules (their hook lists) screened on
    the port's summaries: whole-module skips on the vendored contracts,
    none when CREATE is reachable."""
    modules = test_taint._loaded_modules()
    dis = Disassembly(PROGRAMS[name].hex())
    assert sa.get_summary(dis).sink_sites or name == "taint_create"
    kept, skipped = module_screen.screen_modules(modules, dis)
    assert len(kept) + len(skipped) == len(modules)
    names = {type(m).__name__ for m in skipped}
    expected, _ = test_taint.module_screen.screen_modules(
        modules, JDisassembly(PROGRAMS[name].hex()))
    assert [type(m).__name__ for m in kept] \
        == [type(m).__name__ for m in expected]
    if name == "killbilly":
        assert "ExternalCalls" in names
    elif name == "bectoken":
        assert "AccidentallyKillable" in names
    else:
        assert skipped == []


def test_evmcontract_disassembly_is_cached():
    contract = EVMContract(
        code=port_assemble(port_dispatcher(test_taint.MINI)).hex())
    assert contract.disassembly is contract.disassembly
    assert contract.matches_expression("func#commencekilling()#")
    assert not contract.matches_expression("func#transfer(address,uint256)#")
    assert contract.bytecode_hash \
        == "0x" + jax_sha3(bytes.fromhex(contract.code)).hex()
