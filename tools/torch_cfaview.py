#!/usr/bin/env python
"""Static-CFA report CLI over the PyTorch/CUDA port's static analysis.

    python -m tools.torch_cfaview CONTRACT [--taint] [--absint] [--json]

The port's copy of tools/cfaview.py: the same arguments, report and exit
codes, computed by ``mythril_tpu_torch.staticanalysis`` (``build_cfa``,
``get_summary``, ``build_absint``) over the port's
``frontends/disassembler.py``, with the port's detection-module loader and
module screen. It imports only the port and the standard library.

CONTRACT is one of:

* a path to a file holding hex runtime bytecode (``*.sol.o``, ``.hex``,
  with or without a ``0x`` prefix / trailing whitespace);
* a raw hex string (``0x6080...`` or bare);
* a vendored contract name: ``killbilly`` or ``bectoken`` (the
  hand-assembled headline contracts, copied below).

Prints the cfa verdict: summary counters, the basic-block table (pc range,
terminator, successors, entry stack height, post-dominator merge pc),
resolved/unresolved jump sites, branch merge points, and statically-dead
code regions. ``--taint`` appends the source->sink taint summary
(recovered public functions, natural loops, per-sink operand taint
verdicts, the detection modules the module screen would skip wholesale);
``--absint`` appends the value-range/memory-region verdict (per-block
entry stride-intervals, write regions, join-point memory windows, proven
loop trip bounds, constant JUMPIs). ``--json`` dumps the raw tables
instead (with ``taint`` / ``absint`` keys under the matching flags).

The JAX tool's two knobs are the port's arguments: the block budget is
``build_cfa``'s ``max_blocks`` default, and the taint pass is switched by
``staticanalysis.ENABLED["taint"]`` (on). The tool reads no environment.
Exit codes: 0 on success, 2 when the input is missing/undecodable or the
pass bails (block budget).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

_VENDORED = ("killbilly", "bectoken")


#: mapping access: key = keccak256(pad32(k) ++ pad32(slot))
def _mapping_load(key_src: str, slot: int) -> str:
    return (f"{key_src}\nPUSH1 0x00\nMSTORE\n"
            f"PUSH1 {hex(slot)}\nPUSH1 0x20\nMSTORE\n"
            "PUSH1 0x40\nPUSH1 0x00\nSHA3")


#: The two vendored contracts' function tables, copied from
#: tools/measure_headline.py (KILLBILLY, BECTOKEN): killbilly's SWC-106
#: chain and BECToken's batchTransfer overflow, as assembler source.
KILLBILLY = {
    "killerize(address)":
        "PUSH1 0x01\n"
        + _mapping_load("PUSH1 0x04\nCALLDATALOAD", 1) + "\n"
        "SSTORE\nSTOP",
    "activatekillability()":
        _mapping_load("CALLER", 1) + "\n"
        "SLOAD\nPUSH @ok\nJUMPI\n"
        "PUSH1 0x00\nPUSH1 0x00\nREVERT\n"
        "ok:\nJUMPDEST\nPUSH1 0x01\nPUSH1 0x00\nSSTORE\nSTOP",
    "commencekilling()":
        "PUSH1 0x00\nSLOAD\nPUSH @kill\nJUMPI\n"
        "PUSH1 0x00\nPUSH1 0x00\nREVERT\n"
        "kill:\nJUMPDEST\nCALLER\nSELFDESTRUCT",
}

BECTOKEN = {
    "transfer(address,uint256)":
        "PUSH1 0x24\nCALLDATALOAD\n"
        + _mapping_load("CALLER", 0) + "\n"
        "DUP1\nSLOAD\n"
        "DUP3\nDUP2\nLT\nPUSH @bail\nJUMPI\n"
        "SUB\nSWAP1\nSSTORE\n"
        "PUSH1 0x24\nCALLDATALOAD\n"
        + _mapping_load("PUSH1 0x04\nCALLDATALOAD", 0) + "\n"
        "DUP1\nSLOAD\n"
        "DUP3\nADD\nSWAP1\nSSTORE\nSTOP\n"
        "bail:\nJUMPDEST\nPUSH1 0x00\nPUSH1 0x00\nREVERT",
    "batchTransfer(address[],uint256)":
        "PUSH1 0x04\nCALLDATALOAD\nPUSH1 0x04\nADD\nCALLDATALOAD\n"
        "DUP1\nISZERO\nPUSH @bail\nJUMPI\n"
        "DUP1\nPUSH1 0x14\nLT\nPUSH @bail\nJUMPI\n"
        "PUSH1 0x24\nCALLDATALOAD\n"
        "DUP1\nISZERO\nPUSH @bail\nJUMPI\n"
        "MUL\n"
        + _mapping_load("CALLER", 0) + "\n"
        "DUP1\nSLOAD\n"
        "DUP3\nDUP2\nLT\nPUSH @bail\nJUMPI\n"
        "SUB\nSWAP1\nSSTORE\n"
        "PUSH1 0x24\nCALLDATALOAD\n"
        + _mapping_load("PUSH1 0x24\nPUSH1 0x04\nCALLDATALOAD\nADD\n"
                        "CALLDATALOAD", 0) + "\n"
        "DUP1\nSLOAD\nDUP3\nADD\nSWAP1\nSSTORE\n"
        "PUSH1 0x01\nPUSH1 0x00\nMSTORE\nPUSH1 0x20\nPUSH1 0x00\nRETURN\n"
        "bail:\nJUMPDEST\nPUSH1 0x00\nPUSH1 0x00\nREVERT",
}


def _vendored_bytecode(name: str) -> str:
    from mythril_tpu_torch.frontends.asm import assemble, dispatcher

    functions = KILLBILLY if name == "killbilly" else BECTOKEN
    return assemble(dispatcher(functions)).hex()


def load_bytecode(spec: str) -> str:
    """Resolve CONTRACT to a hex bytecode string. Raises ValueError."""
    if spec.lower() in _VENDORED:
        return _vendored_bytecode(spec.lower())
    if os.path.exists(spec):
        with open(spec, "r", encoding="utf-8") as handle:
            text = handle.read().strip()
    else:
        text = spec.strip()
    if text.startswith(("0x", "0X")):
        text = text[2:]
    text = "".join(text.split())
    if not text:
        raise ValueError("empty bytecode")
    int(text, 16)  # raises ValueError on non-hex
    if len(text) % 2:
        raise ValueError("odd-length hex string")
    return text


def _succ_str(block, result) -> str:
    parts = []
    for succ in sorted(block.successors):
        parts.append("EXIT" if succ == result.exit_id
                     else f"B{succ}@{result.blocks[succ].start_pc:#x}")
    return ",".join(parts) if parts else "-"


def _dead_regions(result) -> List[tuple]:
    regions, start = [], None
    for pc, dead in enumerate(result.dead_mask):
        if dead and start is None:
            start = pc
        elif not dead and start is not None:
            regions.append((start, pc))
            start = None
    if start is not None:
        regions.append((start, len(result.dead_mask)))
    return regions


def report(result, instructions) -> str:
    lines: List[str] = []
    n_reach = len(result.reachable)
    lines.append("== summary ==")
    lines.append(f"  code: {result.code_length} bytes, "
                 f"{len(instructions)} instructions")
    lines.append(f"  blocks: {len(result.blocks)} "
                 f"({n_reach} reachable), edges: {result.n_edges}")
    lines.append(f"  jump sites: {result.n_jump_sites} "
                 f"({len(result.jump_targets)} resolved, "
                 f"{len(result.unresolved_jumps)} unresolved"
                 + (", fully resolved)" if result.fully_resolved else ")"))
    lines.append(f"  valid targets (reachable JUMPDESTs): "
                 f"{len(result.valid_targets)}")
    lines.append(f"  merge points: {len(result.merge_points)}, "
                 f"dead code: {result.dead_bytes} bytes")

    lines.append("")
    lines.append("== blocks ==")
    lines.append(f"  {'id':>4} {'pc range':>15} {'term':<10} {'h':>4} "
                 f"{'merge':>7}  successors")
    for block in result.blocks:
        dead = block.block_id not in result.reachable
        height = "?" if block.entry_height is None else block.entry_height
        merge = result.block_merge_pc[block.block_id]
        lines.append(
            f"  {block.block_id:>4} "
            f"{block.start_pc:#7x}..{block.end_pc:#6x} "
            f"{(block.terminator or 'fall'):<10} {height:>4} "
            f"{(f'{merge:#x}' if merge >= 0 else '-'):>7}  "
            + ("DEAD" if dead else _succ_str(block, result)))

    lines.append("")
    lines.append("== jump sites ==")
    if not result.jump_targets and not result.unresolved_jumps:
        lines.append("  (none reachable)")
    for site in sorted(result.jump_targets):
        targets = result.jump_targets[site]
        dest = ", ".join(f"{t:#x}" for t in targets) if targets \
            else "(provably throws)"
        lines.append(f"  {site:#6x} -> {dest}")
    for site in sorted(result.unresolved_jumps):
        lines.append(f"  {site:#6x} -> ?  (unresolved: conservative "
                     f"fan-out to every JUMPDEST)")

    lines.append("")
    lines.append("== merge points (branch site -> postdom pc) ==")
    if result.branch_merge_pc:
        for site in sorted(result.branch_merge_pc):
            lines.append(f"  {site:#6x} -> {result.branch_merge_pc[site]:#x}")
    else:
        lines.append("  (no branch reconverges before exit)")

    regions = _dead_regions(result)
    lines.append("")
    lines.append("== statically dead code ==")
    if regions:
        for start, end in regions:
            lines.append(f"  {start:#6x}..{end:#x}  ({end - start} bytes)")
    else:
        lines.append("  (none)")
    return "\n".join(lines)


def _screened_module_names(disassembly) -> List[str]:
    """Detection modules the module screen would skip wholesale for this
    contract (hook opcodes unreachable)."""
    from mythril_tpu_torch.analysis.module import ModuleLoader
    from mythril_tpu_torch.analysis.module.base import EntryPoint
    from mythril_tpu_torch.analysis.module_screen import screen_modules

    modules = ModuleLoader().get_detection_modules(EntryPoint.CALLBACK)
    _, skipped = screen_modules(modules, disassembly)
    return sorted(type(m).__name__ for m in skipped)


def _taints_str(taints) -> str:
    return ",".join(sorted(taints)) if taints else "-"


def taint_report(summary, disassembly) -> str:
    lines: List[str] = []
    lines.append("")
    lines.append("== taint: functions ==")
    if summary.functions:
        for fn in summary.functions:
            lines.append(f"  {fn.entry_pc:#6x} {fn.selector or '(fallback)':<12} "
                         f"{fn.name}  ({len(fn.blocks)} block(s))")
    else:
        lines.append("  (no dispatcher recovered — single partition)")

    lines.append("")
    lines.append("== taint: natural loops ==")
    if summary.loops:
        for loop in summary.loops:
            backs = ", ".join(f"{pc:#x}" for pc in loop.back_edge_pcs)
            lines.append(f"  header {loop.header_pc:#6x} depth {loop.depth} "
                         f"({len(loop.blocks)} block(s), back edges: {backs})")
    else:
        lines.append("  (none)")

    lines.append("")
    lines.append("== taint: sink sites (operand 0 = top of stack) ==")
    converged = "converged" if summary.converged else "NOT converged (saturated)"
    lines.append(f"  {len(summary.sink_sites)} site(s), "
                 f"{summary.rounds} storage round(s), {converged}")
    for pc in sorted(summary.sink_sites):
        site = summary.sink_sites[pc]
        operands = "  ".join(
            f"[{i}]={_taints_str(t)}"
            for i, t in enumerate(site.operand_taint))
        lines.append(f"  {pc:#6x} {site.op:<14} {operands}")

    lines.append("")
    lines.append("== taint: module screen ==")
    skipped = _screened_module_names(disassembly)
    if skipped:
        lines.append(f"  {len(skipped)} module(s) skipped wholesale "
                     "(hook opcodes unreachable):")
        for name in skipped:
            lines.append(f"    {name}")
    else:
        lines.append("  (no whole-module skips)")
    return "\n".join(lines)


def _iv_str(iv) -> str:
    """Compact stride-interval rendering: constants as hex, TOP as T,
    everything else as [lo..hi /stride]."""
    from mythril_tpu_torch.staticanalysis.absint import TOP

    lo, hi, stride = iv
    if iv == TOP:
        return "T"
    if stride == 0:
        return f"{lo:#x}"
    return f"[{lo:#x}..{hi:#x} /{stride}]"


def absint_report(absint, cfa) -> str:
    lines: List[str] = []
    lines.append("")
    lines.append("== absint: summary ==")
    lines.append(f"  fixpoint: {absint.iterations} iteration(s), "
                 f"{absint.widenings} widening(s), "
                 f"{len(absint.entry_intervals)} block(s) tracked")
    lines.append(f"  proven: {absint.regions_proven} join region(s), "
                 f"{len(absint.loop_bounds)} loop bound(s), "
                 f"{len(absint.const_jumpis)} constant JUMPI(s)")

    lines.append("")
    lines.append("== absint: block entry ranges (top -> deep) ==")
    for block_id in sorted(absint.entry_intervals):
        height, cells = absint.entry_intervals[block_id]
        start_pc = cfa.blocks[block_id].start_pc
        if height is None:
            lines.append(f"  B{block_id:<3} {start_pc:#6x}  h=?  (unknown "
                         "entry — unresolved-jump fan-in)")
            continue
        stack = "  ".join(_iv_str(iv) for iv in cells) or "-"
        lines.append(f"  B{block_id:<3} {start_pc:#6x}  h={height:<3} {stack}")

    lines.append("")
    lines.append("== absint: block write regions ==")
    any_write = False
    for block_id in sorted(absint.block_writes):
        regions = absint.block_writes[block_id]
        if regions == ():
            continue
        any_write = True
        start_pc = cfa.blocks[block_id].start_pc
        body = "TOP (unbounded/symbolic offset)" if regions is None else \
            " ".join(f"[{a:#x},{b:#x})" for a, b in regions)
        lines.append(f"  B{block_id:<3} {start_pc:#6x}  {body}")
    if not any_write:
        lines.append("  (no block writes memory)")

    lines.append("")
    lines.append("== absint: join-point memory windows ==")
    if absint.join_regions:
        for pc in sorted(absint.join_regions):
            regions = absint.join_regions[pc]
            windows = absint.word_windows(pc)
            body = " ".join(f"[{a:#x},{b:#x})" for a, b in regions) or \
                "(no writes on either arm)"
            wtxt = ("windows " + " ".join(f"{w:#x}" for w in windows)
                    if windows else
                    "no windows needed" if windows == () else
                    "over the window cap — widened merge skipped")
            lines.append(f"  join {pc:#6x}: {body}  -> {wtxt}")
    else:
        lines.append("  (no diamond proves a bounded write region)")

    lines.append("")
    lines.append("== absint: proven loop bounds (header arrivals) ==")
    if absint.loop_bounds:
        for pc in sorted(absint.loop_bounds):
            lines.append(f"  header {pc:#6x} -> {absint.loop_bounds[pc]}")
    else:
        lines.append("  (no loop trip count proven)")

    lines.append("")
    lines.append("== absint: constant JUMPIs ==")
    if absint.const_jumpis:
        for pc in sorted(absint.const_jumpis):
            verdict = ("always taken" if absint.const_jumpis[pc]
                       else "never taken")
            lines.append(f"  {pc:#6x} -> {verdict}")
    else:
        lines.append("  (no provably-constant branch)")
    return "\n".join(lines)


def as_json(result) -> dict:
    """The dense tables, JSON-serializable (dict keys become strings)."""
    return {
        "code_length": result.code_length,
        "blocks": [
            {"id": b.block_id, "start_pc": b.start_pc, "end_pc": b.end_pc,
             "terminator": b.terminator, "entry_height": b.entry_height,
             "successors": sorted(b.successors),
             "reachable": b.block_id in result.reachable}
            for b in result.blocks],
        "exit_id": result.exit_id,
        "n_edges": result.n_edges,
        "pc_to_block": list(result.pc_to_block),
        "block_merge_pc": list(result.block_merge_pc),
        "branch_merge_pc": {str(pc): merge for pc, merge
                            in sorted(result.branch_merge_pc.items())},
        "valid_targets": sorted(result.valid_targets),
        "jump_targets": {str(pc): list(targets) for pc, targets
                         in sorted(result.jump_targets.items())},
        "unresolved_jumps": sorted(result.unresolved_jumps),
        "dead_mask": [int(dead) for dead in result.dead_mask],
    }


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tools.torch_cfaview",
        description="static control-flow-analysis report for EVM "
                    "runtime bytecode (the PyTorch/CUDA port's "
                    "static analysis)")
    parser.add_argument("contract",
                        help="hex bytecode file, raw hex string, or a "
                             f"vendored name ({'/'.join(_VENDORED)})")
    parser.add_argument("--json", action="store_true",
                        help="dump the raw cfa tables as JSON")
    parser.add_argument("--taint", action="store_true",
                        help="append the source->sink taint summary "
                             "(functions, loops, sink verdicts, module "
                             "screen)")
    parser.add_argument("--absint", action="store_true",
                        help="append the value-range/memory-region "
                             "verdict (per-block entry intervals, write "
                             "regions, join windows, proven loop bounds, "
                             "constant JUMPIs)")
    args = parser.parse_args(argv)
    try:
        bytecode = load_bytecode(args.contract)
    except (OSError, ValueError) as error:
        print(f"cfaview: cannot load {args.contract!r}: {error}",
              file=sys.stderr)
        return 2

    from mythril_tpu_torch.frontends.disassembler import Disassembly
    from mythril_tpu_torch.staticanalysis import build_cfa

    disassembly = Disassembly(bytecode)
    result = build_cfa(disassembly)
    if result is None:
        print("cfaview: cfa pass bailed (empty code or over the "
              "build_cfa max_blocks budget)", file=sys.stderr)
        return 2
    summary = None
    if args.taint:
        from mythril_tpu_torch.staticanalysis import get_summary

        summary = get_summary(disassembly)
        if summary is None:
            print("cfaview: taint summary unavailable (pass disabled "
                  "in staticanalysis.ENABLED, or the fixpoint bailed)",
                  file=sys.stderr)
            return 2
    absint = None
    if args.absint:
        from mythril_tpu_torch.staticanalysis import build_absint

        absint = build_absint(disassembly, result)
        if absint is None:
            print("cfaview: absint verdict unavailable (the fixpoint "
                  "bailed — iteration budget)", file=sys.stderr)
            return 2
    if args.json:
        import json
        doc = as_json(result)
        if summary is not None:
            doc["taint"] = summary.to_json()
            doc["taint"]["screened_modules"] = \
                _screened_module_names(disassembly)
        if absint is not None:
            doc["absint"] = absint.to_json()
        print(json.dumps(doc, indent=2))
    else:
        text = report(result, disassembly.instruction_list)
        if summary is not None:
            text += "\n" + taint_report(summary, disassembly)
        if absint is not None:
            text += "\n" + absint_report(absint, result)
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
