"""The gas superoptimizer: CFA block walk -> candidate enumeration ->
batched equivalence proofs -> ranked, re-emitted runtime bytecode.

Per contract the engine walks the recovered basic blocks, asks
:mod:`.rules` for candidate rewrites of each eligible body, encodes
original-vs-candidate as a miter (:mod:`.encode`), and discharges every
obligation in one pass through the existing solver stack: with the jax
backend the blasted CNFs ride `smt/solver/dispatch.py` — one shared
flush, canonical-CNF verdict cache, breaker-gated ladder — and with the
host backend they run sequentially through `sat.solve_cnf` (that A/B is
exactly what `bench.py superopt_ab` measures). Accepted rewrites (UNSAT
miters only) are crosschecked on the host oracle at the sampled cadence,
self-checked on concrete random environments, ranked by static gas saved
weighted by absint-proven loop trip bounds, and patched back into the
runtime bytecode.

Emission is strictly in-place: total code length never changes. Blocks
ending in a no-fallthrough terminator (JUMP included) relocate the
terminator after the shorter body and pad the unreachable tail with
INVALID; JUMPI/fallthrough blocks must re-emit at the exact original
length (a PUSH immediate is zero-widened to restore it, or the rewrite
is rejected), so every byte address outside the block — jump targets
above all — keeps its meaning. Candidates never contain JUMPDEST, so no
new valid jump target can appear.

Eligibility is conservative: every body op whitelisted by the encoder,
a CFA-known entry height at least as deep as either side reads (a
shorter body must not mask a stack underflow the original would throw
on), and no increase in peak stack growth.

The port's copy of mythril_tpu/superopt/engine.py. The JAX knobs
MYTHRIL_TPU_SUPEROPT_MAX_BLOCK_LEN, _CANDIDATES and _CROSSCHECK are the
keyword defaults of `optimize_bytecode` (DEFAULT_MAX_BLOCK_LEN,
DEFAULT_CANDIDATES, DEFAULT_CROSSCHECK: 8, 256 and 8). Under
`solver="jax"` the flush runs on the dispatch's device (`dispatch.configure(device=...)`; None is
the CUDA card, whose absence raises `DeviceUnavailable` before any block
is read); a kernel that fails, or the card out of memory, raises through
the dispatch as it does for `analyze`, and only what the device answers
UNKNOWN goes to the host CDCL.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..frontends.disassembler import Disassembly, EvmInstruction
from ..observe import metrics, trace
from ..ops.opcodes import ADDRESS, OPCODES, push_width
from ..smt import terms
from ..smt.solver import dispatch, sat
from ..smt.solver.bitblast import Blaster
from ..smt.solver.preprocess import lower_constraints
from ..staticanalysis import TERMINATORS, get_absint, get_cfa
from ..staticanalysis.cfa import BasicBlock, push_immediate
from ..staticanalysis.summary import recover_loops
from . import rules
from .encode import BodyOp, build_miter, differ_concretely, is_encodable, \
    random_env, simulate
from .gas import sequence_gas

_MAX_CONFLICTS = 2_000_000
_SELFCHECK_ENVS = 4
_SELFCHECK_SEED = 0xD1FF
_INVALID_BYTE = 0xFE

#: the JAX knobs' defaults (mythril_tpu/support/tpu_config.py)
DEFAULT_MAX_BLOCK_LEN = 8        # MYTHRIL_TPU_SUPEROPT_MAX_BLOCK_LEN
DEFAULT_CANDIDATES = 256         # MYTHRIL_TPU_SUPEROPT_CANDIDATES
DEFAULT_CROSSCHECK = 8           # MYTHRIL_TPU_SUPEROPT_CROSSCHECK


@dataclass
class BlockRewrite:
    """One accepted, proven, emitted rewrite."""

    block_id: int
    start_pc: int                #: first rewritten byte
    rule: str
    before: Tuple[str, ...]      #: original body disassembly
    after: Tuple[str, ...]       #: replacement body disassembly
    gas_before: int
    gas_after: int
    weight: int                  #: absint loop trip bound, 1 outside loops
    proof: str                   #: "syntactic" | "device" | "host"

    @property
    def gas_saved(self) -> int:
        return self.gas_before - self.gas_after

    @property
    def weighted_saved(self) -> int:
        return self.gas_saved * self.weight

    def to_json(self) -> dict:
        return {"block_id": self.block_id, "start_pc": self.start_pc,
                "rule": self.rule, "before": list(self.before),
                "after": list(self.after), "gas_before": self.gas_before,
                "gas_after": self.gas_after, "gas_saved": self.gas_saved,
                "weight": self.weight,
                "weighted_saved": self.weighted_saved, "proof": self.proof}


@dataclass
class OptimizationReport:
    """Everything `myth-tpu optimize` / the serve `optimize` op returns."""

    code_in: str                 #: input runtime bytecode, hex
    code_out: str                #: rewritten runtime bytecode, hex
    blocks_scanned: int = 0
    candidates: int = 0
    rewrites: List[BlockRewrite] = field(default_factory=list)
    proof_stats: Dict[str, int] = field(default_factory=dict)
    wall_ms: float = 0.0
    note: str = ""               #: why the run was empty, when it was

    @property
    def gas_saved(self) -> int:
        return sum(r.gas_saved for r in self.rewrites)

    @property
    def weighted_gas_saved(self) -> int:
        return sum(r.weighted_saved for r in self.rewrites)

    def to_json(self) -> dict:
        return {"code_in": self.code_in, "code_out": self.code_out,
                "blocks_scanned": self.blocks_scanned,
                "candidates": self.candidates,
                "rewrites": [r.to_json() for r in self.rewrites],
                "gas_saved": self.gas_saved,
                "weighted_gas_saved": self.weighted_gas_saved,
                "proof_stats": dict(self.proof_stats),
                "wall_ms": round(self.wall_ms, 3), "note": self.note}


# ---------------------------------------------------------------------------------
# Block layout: what byte region may be rewritten, and how
# ---------------------------------------------------------------------------------

@dataclass
class _Layout:
    body: List[BodyOp]
    region_start: int
    region_len: int
    relocatable: bool            #: terminator may move up (no fallthrough)
    term_byte: Optional[int]     #: terminator opcode byte when relocatable


def _instr_size(ins: EvmInstruction) -> int:
    width = push_width(ins.op_code) if ins.op_code.startswith("PUSH") else 0
    return 1 + width


def _body_op(ins: EvmInstruction) -> BodyOp:
    if ins.argument is not None:
        return (ins.op_code, push_immediate(ins))
    return (ins.op_code, None)


def _block_layout(disassembly: Disassembly,
                  block: BasicBlock) -> Optional[_Layout]:
    instrs = disassembly.instruction_list[block.first_index:
                                          block.last_index + 1]
    if not instrs:
        return None
    relocatable = block.terminator in TERMINATORS or \
        block.terminator == "JUMP"
    has_term = relocatable or block.terminator == "JUMPI"
    term_instr = instrs[-1] if has_term else None
    body_instrs = instrs[:-1] if has_term else instrs
    if body_instrs and body_instrs[0].op_code == "JUMPDEST":
        body_instrs = body_instrs[1:]  # the jump target byte stays put
    if not body_instrs:
        return None
    for ins in body_instrs:
        if ins.op_code.startswith("PUSH") and ins.argument is not None:
            # a PUSH immediate truncated by end-of-code is trailing
            # garbage, not a rewritable instruction
            if len(ins.argument[2:]) != 2 * push_width(ins.op_code):
                return None
    region_start = body_instrs[0].address
    if relocatable:
        region_end = term_instr.address + 1   # terminator byte included
        term_byte = OPCODES[block.terminator][ADDRESS]
    else:
        region_end = term_instr.address if term_instr else \
            body_instrs[-1].address + _instr_size(body_instrs[-1])
        term_byte = None
    return _Layout(body=[_body_op(ins) for ins in body_instrs],
                   region_start=region_start,
                   region_len=region_end - region_start,
                   relocatable=relocatable, term_byte=term_byte)


def _assemble(body: Sequence[BodyOp]) -> bytes:
    out = bytearray()
    for name, imm in body:
        out.append(OPCODES[name][ADDRESS])
        if name.startswith("PUSH") and name != "PUSH0":
            out += (imm or 0).to_bytes(push_width(name), "big")
    return bytes(out)


def _fit_region(candidate: Sequence[BodyOp], layout: _Layout
                ) -> Optional[Tuple[Tuple[BodyOp, ...], bytes]]:
    """Emit `candidate` into the block's byte region, preserving total
    code length. Returns (final_body, region_bytes) or None when the
    candidate cannot fit."""
    raw = _assemble(candidate)
    if layout.relocatable:
        used = len(raw) + 1
        if used > layout.region_len:
            return None
        padding = bytes([_INVALID_BYTE]) * (layout.region_len - used)
        return tuple(candidate), raw + bytes([layout.term_byte]) + padding

    deficit = layout.region_len - len(raw)
    if deficit < 0:
        return None
    if deficit == 0:
        return tuple(candidate), raw
    # fallthrough/JUMPI: restore the exact length by zero-widening PUSH
    # immediates (PUSHk -> PUSH(k+m), same value, same static gas)
    widened: List[BodyOp] = []
    for name, imm in candidate:
        if deficit > 0 and name.startswith("PUSH") and name != "PUSH0":
            width = push_width(name)
            grow = min(32 - width, deficit)
            if grow:
                deficit -= grow
                widened.append((f"PUSH{width + grow}", imm))
                continue
        widened.append((name, imm))
    if deficit > 0:
        return None
    return tuple(widened), _assemble(widened)


def _disasm(body: Sequence[BodyOp]) -> Tuple[str, ...]:
    return tuple(name if imm is None else f"{name} 0x{imm:x}"
                 for name, imm in body)


# ---------------------------------------------------------------------------------
# Proof obligations
# ---------------------------------------------------------------------------------

@dataclass
class _Obligation:
    block_id: int
    body: Tuple[BodyOp, ...]
    emitted: bytes
    rule: str
    gas_after: int
    clauses: Optional[List[List[int]]] = None   # None => syntactic proof
    n_vars: int = 0
    future: Optional[object] = None
    status: int = sat.UNKNOWN
    proof: str = ""


def _blast(miter: terms.Term) -> Optional[Tuple[List[List[int]], int, str]]:
    """Lower + bit-blast one miter. Returns (clauses, n_vars, "") for a
    real query, (None, 0, verdict) when lowering decided it: verdict
    "unsat" means proven equivalent, "sat" means proven distinguishable.
    """
    lowered, _info = lower_constraints([miter], simplify=True)
    pending = []
    for term in lowered:
        if term is terms.FALSE:
            return None, 0, "unsat"
        if term is terms.TRUE:
            continue
        pending.append(term)
    if not pending:
        return None, 0, "sat"
    blaster = Blaster()
    for term in pending:
        blaster.assert_true(term)
    return blaster.clauses, blaster.n_vars, ""


# ---------------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------------

def optimize_bytecode(code, *, solver: str = "cdcl",
                      max_block_len: int = DEFAULT_MAX_BLOCK_LEN,
                      candidates_budget: int = DEFAULT_CANDIDATES,
                      crosscheck: int = DEFAULT_CROSSCHECK
                      ) -> OptimizationReport:
    """Superoptimize one runtime bytecode; returns the full report.

    `solver` selects the proof backend: "jax" batches every obligation
    through the dispatch queue (one flush, shared verdict cache,
    UNKNOWNs fall down the ladder to the host CDCL), anything else
    proves sequentially on the host oracle.
    """
    started = time.perf_counter()
    batched = solver == "jax" and dispatch.enabled()
    if batched:
        dispatch.resolve_device()  # no card: DeviceUnavailable, now

    disassembly = code if isinstance(code, Disassembly) else Disassembly(code)
    code_hex = disassembly.raw_code.hex()
    report = OptimizationReport(code_in=code_hex, code_out=code_hex)

    cfa = get_cfa(disassembly)
    if cfa is None:
        report.note = ("no CFA tables (staticanalysis.ENABLED['cfa'] off "
                       "or pass bailed)")
        report.wall_ms = (time.perf_counter() - started) * 1000.0
        return report
    absint = get_absint(disassembly)
    loops, loop_header_of = recover_loops(cfa, disassembly.instruction_list)

    def block_weight(block_id: int) -> int:
        header_pc = loop_header_of.get(block_id)
        if header_pc is None or absint is None:
            return 1
        bound = absint.loop_bound(header_pc)
        return bound if bound and bound > 0 else 1

    # -- enumerate: per block, every screened + fitted candidate ------------------
    pending: Dict[int, List[_Obligation]] = {}
    layouts: Dict[int, _Layout] = {}
    stats = {"obligations": 0, "syntactic": 0, "queries": 0, "sat": 0,
             "unsat": 0, "unknown": 0, "crosschecks": 0, "divergences": 0,
             "selfcheck_failures": 0, "batched": 0}

    for block in cfa.blocks:
        if block.block_id not in cfa.reachable:
            continue
        report.blocks_scanned += 1
        metrics.inc("superopt.blocks_scanned")
        layout = _block_layout(disassembly, block)
        if layout is None or not layout.body or not is_encodable(layout.body):
            continue
        if block.entry_height is None:
            continue
        tag = f"so{block.block_id}"
        original = simulate(layout.body, tag)
        if block.entry_height < original.consumed:
            continue  # the real machine underflows here; do not touch it
        gas_before = sequence_gas(name for name, _ in layout.body)

        candidates, tried = rules.enumerate_candidates(
            layout.body, max_block_len, candidates_budget)
        if tried:
            metrics.inc("superopt.search_sequences", tried)

        block_pending: List[_Obligation] = []
        seen_emitted = set()
        for cand_body, rule in candidates:
            fitted = _fit_region(cand_body, layout)
            if fitted is None:
                continue
            final_body, emitted = fitted
            gas_after = sequence_gas(name for name, _ in final_body)
            if gas_after >= gas_before:
                continue
            if emitted in seen_emitted:
                continue
            candidate = simulate(final_body, tag)
            if block.entry_height < candidate.consumed:
                continue
            if candidate.max_growth > original.max_growth:
                continue
            miter = build_miter(original, candidate, tag)
            if miter is None or miter is terms.TRUE:
                continue
            obligation = _Obligation(
                block_id=block.block_id, body=final_body, emitted=emitted,
                rule=rule, gas_after=gas_after)
            if miter is terms.FALSE:
                obligation.status = sat.UNSAT
                obligation.proof = "syntactic"
            else:
                clauses, n_vars, verdict = _blast(miter)
                if verdict == "unsat":
                    obligation.status = sat.UNSAT
                    obligation.proof = "syntactic"
                elif verdict == "sat":
                    obligation.status = sat.SAT
                else:
                    obligation.clauses = clauses
                    obligation.n_vars = n_vars
            if obligation.status == sat.SAT:
                stats["sat"] += 1
                metrics.inc("superopt.proofs_sat")
                continue
            seen_emitted.add(emitted)
            report.candidates += 1
            metrics.inc("superopt.candidates")
            stats["obligations"] += 1
            if obligation.proof == "syntactic":
                stats["syntactic"] += 1
                metrics.inc("superopt.proofs_syntactic")
            block_pending.append(obligation)
        if block_pending:
            pending[block.block_id] = block_pending
            layouts[block.block_id] = layout

    # -- discharge: one batched flush (jax) or sequential host proofs -------------
    queries = [ob for obs in pending.values() for ob in obs
               if ob.clauses is not None]
    stats["queries"] = len(queries)
    stats["batched"] = int(batched)
    with trace.span("superopt.prove", obligations=stats["obligations"],
                    queries=len(queries), batched=batched) as span:
        if batched and queries:
            dispatch.set_query_origin("superopt")
            try:
                for ob in queries:
                    ob.future = dispatch.submit(ob.clauses, ob.n_vars,
                                                _MAX_CONFLICTS)
                metrics.observe("superopt.proof_flush.occupancy",
                                len(queries))
                dispatch.flush()
            finally:
                dispatch.set_query_origin(None)
            for ob in queries:
                status, _model = ob.future.result()
                if status == sat.UNKNOWN:
                    # bottom of the ladder: the host CDCL decides
                    status, _model = sat.solve_cnf(ob.clauses, ob.n_vars,
                                                   max_conflicts=_MAX_CONFLICTS)
                    ob.proof = "host"
                else:
                    ob.proof = "device"
                ob.status = status
        else:
            for ob in queries:
                status, _model = sat.solve_cnf(ob.clauses, ob.n_vars,
                                               max_conflicts=_MAX_CONFLICTS)
                ob.status = status
                ob.proof = "host"

        accepted_queries = 0
        for ob in queries:
            if ob.status == sat.UNSAT:
                stats["unsat"] += 1
                metrics.inc("superopt.proofs_unsat")
                accepted_queries += 1
                # sampled crosscheck on the host oracle, divergence fatal
                # for the rewrite and loud in metrics
                if crosscheck and accepted_queries % crosscheck == 0:
                    stats["crosschecks"] += 1
                    metrics.inc("superopt.crosschecks")
                    host_status, _ = sat.solve_cnf(
                        ob.clauses, ob.n_vars, max_conflicts=_MAX_CONFLICTS)
                    if host_status == sat.SAT:
                        stats["divergences"] += 1
                        metrics.inc("superopt.crosscheck_divergence")
                        ob.status = sat.SAT
            elif ob.status == sat.SAT:
                stats["sat"] += 1
                metrics.inc("superopt.proofs_sat")
            else:
                stats["unknown"] += 1
                metrics.inc("superopt.proofs_unknown")
        span.set(unsat=stats["unsat"], sat=stats["sat"],
                 unknown=stats["unknown"])

    # -- rank, self-check, emit ---------------------------------------------------
    rng = random.Random(_SELFCHECK_SEED)
    out = bytearray(disassembly.raw_code)
    for block_id, obligations in sorted(pending.items()):
        layout = layouts[block_id]
        accepted = [ob for ob in obligations if ob.status == sat.UNSAT]
        accepted.sort(key=lambda ob: (ob.gas_after, ob.emitted))
        chosen = None
        depth = max(20, 17 + 2 * len(layout.body))
        for ob in accepted:
            envs = [random_env(rng, depth) for _ in range(_SELFCHECK_ENVS)]
            if any(differ_concretely(list(layout.body), list(ob.body), env)
                   for env in envs):
                # a proven rewrite failing concrete replay means the
                # encoding itself is wrong — refuse it and say so loudly
                stats["selfcheck_failures"] += 1
                continue
            chosen = ob
            break
        if chosen is None:
            continue
        out[layout.region_start:layout.region_start + layout.region_len] = \
            chosen.emitted
        gas_before = sequence_gas(name for name, _ in layout.body)
        report.rewrites.append(BlockRewrite(
            block_id=block_id, start_pc=layout.region_start,
            rule=chosen.rule, before=_disasm(layout.body),
            after=_disasm(chosen.body), gas_before=gas_before,
            gas_after=chosen.gas_after, weight=block_weight(block_id),
            proof=chosen.proof or "host"))

    if len(out) != len(disassembly.raw_code):  # pragma: no cover
        raise AssertionError("superopt emission changed the code length")
    report.code_out = bytes(out).hex()
    report.proof_stats = stats
    if report.weighted_gas_saved:
        metrics.inc("superopt.gas_saved", report.weighted_gas_saved)
    report.wall_ms = (time.perf_counter() - started) * 1000.0
    return report
