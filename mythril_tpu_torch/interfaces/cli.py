"""`myth-tpu-torch` command-line interface.

Capability parity: mythril/interfaces/cli.py:243-356 — subcommands
analyze|a, disassemble|d, foundry|f, concolic, safe-functions, read-storage,
function-to-hash, hash-to-address, list-detectors, version; the full analysis
flag surface (strategy, tx count, timeouts, pruning, modules, reports) at
cli.py:438-600. Exit code 1 iff issues were found (cli.py:880-883).

Device additions: `--solver jax` selects the batched device solver
(parallel/device_solver.py through smt/solver/dispatch.py); `--engine tpu`
explores on the device frontier.

The port's copy of mythril_tpu/interfaces/cli.py: `analyze`/`a`,
`safe-functions`, `optimize`/`opt`, `concolic`, `disassemble`/`d`,
`list-detectors`, `function-to-hash`, `hash-to-address` and `version`,
with the reference's arguments and defaults (`--engine host` and the CDCL
solver). `--engine tpu` explores each
message call on the CUDA card (`parallel/frontier.execute_message_call_tpu`)
and exits 2 before any contract is analyzed when there is no card; so does
`--solver jax`, which decides the solver's queries on the card's SAT lane
(the batch dispatch over K11). `--checkpoint`/`--resume` save and resume
the host worklist and the device frontier. `--fleet` with `--engine tpu`
and repeated `-f` (each member named after its file) analyzes the
contracts as one fleet in shared device phases. `--metrics-out` writes
the metric registry's snapshot and `--trace-out` a Perfetto trace of the
run (observe/). `optimize --solver jax` proves the optimizer's rewrites on
the card's SAT lane (K11) and exits 2 without a card; `--solver cdcl` and
`concolic` run on the host. The other subcommands exit with code 2 and
the ROADMAP item that ports them, and so does every input whose path is
not ported (`-a`/`--rpc`, Solidity files), before any contract is
analyzed. Every command first activates the default-enabled third-party
plugins of the `mythril_tpu_torch.plugins` entry-point group
(plugin/discovery.py), as the reference does for its own group."""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys


def _add_analysis_args(parser: argparse.ArgumentParser) -> None:
    inputs = parser.add_argument_group("input")
    inputs.add_argument("solidity_files", nargs="*",
                        help=".sol files (optionally file:ContractName)")
    inputs.add_argument("-c", "--code", help="hex creation bytecode")
    inputs.add_argument("-f", "--codefile", action="append",
                        help="file containing hex bytecode (repeatable: "
                             "with --fleet every -f is one corpus member)")
    inputs.add_argument("-a", "--address", help="on-chain contract address")
    inputs.add_argument("--bin-runtime", action="store_true",
                        help="treat -c/-f input as runtime (deployed) code")

    options = parser.add_argument_group("options")
    options.add_argument("-m", "--modules",
                         help="comma-separated detection module list")
    options.add_argument("--strategy", default="bfs",
                         choices=["dfs", "bfs", "naive-random",
                                  "weighted-random", "beam-search", "pending"])
    options.add_argument("-t", "--transaction-count", type=int, default=2)
    options.add_argument("--execution-timeout", type=int, default=86400)
    options.add_argument("--create-timeout", type=int, default=10)
    options.add_argument("--solver-timeout", type=int, default=10000)
    options.add_argument("--max-depth", type=int, default=128)
    options.add_argument("-b", "--loop-bound", type=int, default=3)
    options.add_argument("--call-depth-limit", type=int, default=3)
    options.add_argument("--pruning-factor", type=float, default=None)
    options.add_argument("--incremental-txs", default=True,
                         type=lambda x: str(x).lower() not in ("false", "0"),
                         help="False = explore RF-prioritized function "
                              "sequences instead of all orderings")
    options.add_argument("--enable-state-merging", action="store_true",
                         help="merge similar world states after each tx")
    options.add_argument("--enable-summaries", action="store_true",
                         help="record and replay symbolic transaction "
                              "summaries instead of re-executing")
    options.add_argument("--unconstrained-storage", action="store_true")
    options.add_argument("--disable-dependency-pruning", action="store_true")
    options.add_argument("--disable-mutation-pruner", action="store_true")
    options.add_argument("--enable-iprof", action="store_true")
    options.add_argument("--solver-log", help="directory for .smt2 query dumps")
    options.add_argument("--solver", default="cdcl", choices=["cdcl", "jax"],
                         help="SAT backend: native CDCL, or the batched "
                              "device solver on the CUDA card (the CDCL "
                              "answers what it leaves unknown)")
    options.add_argument("--no-simplify", action="store_true",
                         help="disable the word-level simplification pass "
                              "ahead of the bit-blaster (A/B measurement)")
    options.add_argument("--no-batch-solve", action="store_true",
                         help="disable the batched device SAT dispatch "
                              "(A/B measurement; --solver jax only)")
    options.add_argument("--no-cfa", action="store_true",
                         help="disable the static control-flow-analysis "
                              "screen (staticanalysis/): jump validity, "
                              "merge-point tagging, and dead-code pruning "
                              "fall back to dynamic checks (A/B measurement)")
    options.add_argument("--no-taint", action="store_true",
                         help="disable the taint module screen "
                              "(staticanalysis/taint.py): detection "
                              "modules register and fire on every hook "
                              "site again (A/B measurement)")
    options.add_argument("--no-absint", action="store_true",
                         help="disable the value-range/memory-region "
                              "abstract interpretation "
                              "(staticanalysis/absint.py): proven loop "
                              "bounds and constant-JUMPI pruning fall back "
                              "to flat defaults (A/B measurement)")
    options.add_argument("--no-frontier-telemetry", action="store_true",
                         help="drop the device frontier's counter plane "
                              "(A/B measurement; --engine tpu only)")
    options.add_argument("--no-state-merge", action="store_true",
                         help="disable the device frontier's state merging "
                              "at post-dominator join points (A/B "
                              "measurement; --engine tpu only)")
    options.add_argument("--engine", default="host", choices=["host", "tpu"],
                         help="exploration engine: host worklist, or the "
                              "device frontier on the CUDA card")
    options.add_argument("--fleet", action="store_true",
                         help="pack every loaded contract into one device "
                              "frontier (--engine tpu, two or more "
                              "contracts; else they run one by one)")
    options.add_argument("--beam-width", type=int, default=None)
    options.add_argument("--transaction-sequences", default=None,
                         help="explicit function-sequence list (json)")
    options.add_argument("--checkpoint", default=None, metavar="PATH",
                         help="periodically snapshot the analysis so a "
                              "killed run can --resume (the device "
                              "frontier's snapshot is PATH.device.npz)")
    options.add_argument("--resume", default=None, metavar="PATH",
                         help="resume a killed analysis from --checkpoint "
                              "state")
    options.add_argument("--inject-fault", default=None,
                         metavar="CLASS[:NTH]",
                         help="deterministic fault injection for resilience "
                              "testing: fire failure CLASS (device_oom, "
                              "compile_error, wall_overrun, worker_crash, "
                              "native_crash, divergence, host_crash) at the "
                              "NTH visit of its boundary (N, N+, or *; "
                              "default 1); comma-separate multiple entries")
    options.add_argument("--trace-out", default=None, metavar="PATH",
                         help="write a trace_event JSON of the run to PATH")
    options.add_argument("--metrics-out", default=None, metavar="PATH",
                         help="write a JSON snapshot of the metric "
                              "registry to PATH")
    options.add_argument("--device-crosscheck", type=int, default=0,
                         metavar="N",
                         help="re-decide every Nth device sat/unsat verdict "
                              "on the host CDCL oracle; any divergence "
                              "quarantines the device backend for the run "
                              "(0 = off)")

    output = parser.add_argument_group("output")
    output.add_argument("-o", "--outform", default="text",
                        choices=["text", "json", "jsonv2", "markdown"])
    output.add_argument("-g", "--graph", help="write call graph HTML here")
    output.add_argument("-j", "--statespace-json",
                        help="write statespace JSON here")

    rpc = parser.add_argument_group("rpc")
    rpc.add_argument("--rpc", help="custom RPC (host:port, ganache, "
                                   "infura-<net>; not ported: ROADMAP A 14)")
    rpc.add_argument("--rpctls", action="store_true")
    rpc.add_argument("--no-onchain-data", action="store_true",
                     help="do not fault in on-chain storage/balances/code "
                          "via RPC (on by default when -a/--rpc is given)")


def _load_contracts(parser, cli_args, disassembler):
    """Resolve the input sources into loaded contracts + target address."""
    address = cli_args.address
    if cli_args.code:
        address, _ = disassembler.load_from_bytecode(
            cli_args.code, cli_args.bin_runtime, address)
    elif cli_args.codefile:
        for path in cli_args.codefile:
            with open(path) as handle:
                code = handle.read().strip()
            address, contract = disassembler.load_from_bytecode(
                code, cli_args.bin_runtime, address)
            if len(cli_args.codefile) > 1:
                # corpus sweep: name each member after its file so fleet
                # namespaces/reports stay distinguishable
                contract.name = os.path.splitext(os.path.basename(path))[0]
                contract.input_file = path
    elif cli_args.address:
        address, _ = disassembler.load_from_address(cli_args.address)
    elif cli_args.solidity_files:
        address, _ = disassembler.load_from_solidity(cli_args.solidity_files)
    else:
        parser.error("no input: provide solidity files, -c, -f or -a")
    return address


def _build_disassembler(cli_args):
    from ..mythril import MythrilConfig, MythrilDisassembler

    eth = None
    if getattr(cli_args, "rpc", None) or getattr(cli_args, "address", None):
        config = MythrilConfig()
        config.set_api_rpc(getattr(cli_args, "rpc", None),
                           getattr(cli_args, "rpctls", False))
        eth = config.eth
    return MythrilDisassembler(
        eth=eth,
        solc_version=getattr(cli_args, "solv", None),
        solc_settings_json=getattr(cli_args, "solc_json", None))


def _format_report(report, outform: str) -> str:
    return {"text": report.as_text, "json": report.as_json,
            "jsonv2": report.as_swc_standard_format,
            "markdown": report.as_markdown}[outform]()


def _cmd_analyze(parser, cli_args, safe_functions: bool = False) -> int:
    from ..mythril import MythrilAnalyzer

    disassembler = _build_disassembler(cli_args)
    address = _load_contracts(parser, cli_args, disassembler)
    cli_args.disable_iprof = not cli_args.enable_iprof
    analyzer = MythrilAnalyzer(disassembler, cmd_args=cli_args,
                               strategy=cli_args.strategy, address=address)

    if cli_args.graph:
        with open(cli_args.graph, "w") as handle:
            handle.write(analyzer.graph_html(
                transaction_count=cli_args.transaction_count))
        return 0
    if cli_args.statespace_json:
        with open(cli_args.statespace_json, "w") as handle:
            handle.write(analyzer.dump_statespace(
                transaction_count=cli_args.transaction_count))
        return 0

    modules = cli_args.modules.split(",") if cli_args.modules else None
    report = analyzer.fire_lasers(modules=modules,
                                  transaction_count=cli_args.transaction_count)
    if safe_functions:
        issues = list(report.issues.values())
        unsafe = {issue.function for issue in issues}
        all_functions = set()
        for contract in disassembler.contracts:
            all_functions.update(contract.disassembly
                                 .function_name_to_address.keys())
        safe = sorted(all_functions - unsafe)
        print(json.dumps({"safe_functions": safe,
                          "unsafe_functions": sorted(unsafe)}, indent=2))
        return 0
    print(_format_report(report, cli_args.outform))
    return 1 if report.issues else 0


def _add_optimize_args(parser: argparse.ArgumentParser) -> None:
    inputs = parser.add_argument_group("input")
    inputs.add_argument("-c", "--code", help="hex runtime bytecode")
    inputs.add_argument("-f", "--codefile",
                        help="file containing hex runtime bytecode")

    # the defaults are superopt/engine.py's DEFAULT_MAX_BLOCK_LEN,
    # DEFAULT_CANDIDATES and DEFAULT_CROSSCHECK (not imported here: the
    # optimizer's import would slow every command's start)
    options = parser.add_argument_group("options")
    options.add_argument("--solver", default="cdcl", choices=["cdcl", "jax"],
                         help="equivalence-proof backend: host CDCL oracle "
                              "or the batched device dispatch queue on the "
                              "CUDA card (one flush, shared verdict cache, "
                              "UNKNOWNs fall down the ladder to the host)")
    options.add_argument("--max-block-len", type=int, default=8,
                         metavar="N",
                         help="longest pure-stack block eligible for the "
                              "exhaustive stack-scheduling search (default: "
                              "%(default)s)")
    options.add_argument("--candidates", type=int, default=256, metavar="N",
                         help="search-sequence budget per block (default: "
                              "%(default)s)")
    options.add_argument("--crosscheck", type=int, default=8, metavar="N",
                         help="re-decide every Nth accepted proof on the "
                              "host CDCL oracle (default: %(default)s; 0 = "
                              "off)")

    output = parser.add_argument_group("output")
    output.add_argument("-o", "--outform", default="text",
                        choices=["text", "json"])
    output.add_argument("--code-out", default=None, metavar="PATH",
                        help="also write the rewritten runtime bytecode "
                             "(hex) to PATH")


def _cmd_optimize(parser, cli_args) -> int:
    from ..superopt import optimize_bytecode

    code = cli_args.code
    if code is None and cli_args.codefile:
        with open(cli_args.codefile) as handle:
            code = handle.read().strip()
    if not code:
        parser.error("optimize needs -c or -f")
    report = optimize_bytecode(
        code, solver=cli_args.solver,
        max_block_len=cli_args.max_block_len,
        candidates_budget=cli_args.candidates,
        crosscheck=cli_args.crosscheck)
    if cli_args.code_out:
        with open(cli_args.code_out, "w") as handle:
            handle.write(report.code_out + "\n")
    if cli_args.outform == "json":
        print(json.dumps(report.to_json(), indent=2, sort_keys=True))
    else:
        stats = report.proof_stats
        print(f"blocks scanned:     {report.blocks_scanned}")
        print(f"candidates proven:  {report.candidates} "
              f"({stats.get('queries', 0)} SAT queries, "
              f"{stats.get('syntactic', 0)} syntactic)")
        print(f"rewrites accepted:  {len(report.rewrites)}")
        print(f"gas saved:          {report.gas_saved} static, "
              f"{report.weighted_gas_saved} loop-weighted")
        for rewrite in report.rewrites:
            print(f"  pc {rewrite.start_pc:#06x} [{rewrite.rule}] "
                  f"-{rewrite.gas_saved} gas (x{rewrite.weight}, "
                  f"{rewrite.proof}): "
                  f"{'; '.join(rewrite.before)} => "
                  f"{'; '.join(rewrite.after) or '<elided>'}")
        if report.note:
            print(f"note: {report.note}")
        print(report.code_out)
    # a crosscheck divergence means an unsound device verdict slipped
    # through: loud, non-zero, and the rewrite was already rejected
    return 1 if report.proof_stats.get("divergences") else 0


#: the subcommands the port has not ported: their aliases and the ROADMAP
#: item that ports them
_UNPORTED_COMMANDS = {
    "foundry": (["f"], "A 14f (frontends/solidity.py, solc)"),
    "read-storage": ([], "A 14e (ethereum/rpc.py)"),
    "serve": ([], "A 12 (serve/)"),
    "client": ([], "A 12 (serve/)"),
}


def main(argv=None) -> int:
    from .. import __version__

    parser = argparse.ArgumentParser(
        prog="myth-tpu-torch",
        description="EVM security analysis, PyTorch/CUDA port")
    parser.add_argument("-v", type=int, default=2, metavar="LOG_LEVEL",
                        help="log level 0-5")
    subparsers = parser.add_subparsers(dest="command")

    analyze = subparsers.add_parser("analyze", aliases=["a"],
                                    help="symbolically analyze a contract")
    _add_analysis_args(analyze)

    safe = subparsers.add_parser("safe-functions",
                                 help="list functions with no detected issues")
    _add_analysis_args(safe)

    optimize = subparsers.add_parser(
        "optimize", aliases=["opt"],
        help="gas-superoptimize runtime bytecode: every rewrite backed "
             "by an equivalence proof (batched device SAT or host CDCL)")
    _add_optimize_args(optimize)

    disasm = subparsers.add_parser("disassemble", aliases=["d"],
                                   help="disassemble EVM bytecode")
    disasm.add_argument("-c", "--code", default=None)
    disasm.add_argument("-f", "--codefile", default=None)
    disasm.add_argument("-a", "--address", default=None)
    disasm.add_argument("--rpc", default=None)
    disasm.add_argument("--rpctls", action="store_true")

    concolic = subparsers.add_parser(
        "concolic", help="flip branches of a concrete transaction trace")
    concolic.add_argument("input", help="ConcreteData json file")
    concolic.add_argument("--branches", required=True,
                          help="comma-separated JUMPI addresses to flip")
    concolic.add_argument("--engine", default="oracle",
                          choices=["oracle", "lockstep"],
                          help="concrete replay engine (both replay on the "
                               "host engine; lockstep only logs a line)")

    f2h = subparsers.add_parser("function-to-hash",
                                help="keccak selector of a signature")
    f2h.add_argument("signature")

    h2a = subparsers.add_parser("hash-to-address",
                                help="signature lookup for a 4-byte selector")
    h2a.add_argument("hash")

    subparsers.add_parser("list-detectors", help="list detection modules")
    subparsers.add_parser("version", help="print version")
    unported = {}
    for command, (aliases, item) in _UNPORTED_COMMANDS.items():
        subparsers.add_parser(command, aliases=aliases, add_help=False,
                              help=f"not ported: ROADMAP {item}")
        unported.update(dict.fromkeys([command, *aliases], item))

    # the unported subcommands take any arguments: they refuse below
    cli_args, unknown = parser.parse_known_args(argv)
    item = unported.get(cli_args.command)
    if item is not None:
        print(f"myth-tpu-torch: {cli_args.command} is not ported: "
              f"ROADMAP {item}", file=sys.stderr)
        return 2
    if unknown:
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    if getattr(cli_args, "transaction_sequences", None):
        # "[[0xdeadbeef], [-1]]" -> nested int lists (reference cli.py:651-668;
        # a sequence longer than -t silently extends the tx count there too)
        from ast import literal_eval

        try:
            cli_args.transaction_sequences = literal_eval(
                str(cli_args.transaction_sequences))
        except (ValueError, SyntaxError):
            parser.error("--transaction-sequences is not a valid nested list")
        # validate VALUES, not just shape: hex(h) mangles negative ints other
        # than -1/-2 and selectors wider than 4 bytes would overflow the
        # selector encoding downstream (ADVICE r4)
        if not isinstance(cli_args.transaction_sequences, list):
            parser.error("--transaction-sequences must be a nested list")
        for tx_hashes in cli_args.transaction_sequences:
            if tx_hashes is None:
                continue
            if not isinstance(tx_hashes, list):
                parser.error("--transaction-sequences entries must be lists")
            for h in tx_hashes:
                if isinstance(h, bool):
                    # bool is an int subclass: [true] would silently become
                    # selector 0x00000001
                    parser.error(
                        f"--transaction-sequences value {h!r} is not a "
                        "4-byte function selector or -1/-2")
                if h in (-1, -2):
                    continue
                if not isinstance(h, int) or not 0 <= h < 2 ** 32:
                    parser.error(
                        f"--transaction-sequences value {h!r} is not a "
                        "4-byte function selector or -1/-2")
        if len(cli_args.transaction_sequences) != cli_args.transaction_count:
            cli_args.transaction_count = len(cli_args.transaction_sequences)
    logging.basicConfig(
        level=[logging.NOTSET, logging.CRITICAL, logging.ERROR,
               logging.WARNING, logging.INFO,
               logging.DEBUG][min(cli_args.v, 5)],
        format="%(levelname)s:%(name)s: %(message)s")

    # activate third-party plugins published via the
    # mythril_tpu_torch.plugins entry-point group (the reference boots its
    # MythrilPluginLoader the same way; plugin/discovery.py)
    from ..exceptions import DeviceUnavailable
    from ..plugin import MythrilPluginLoader

    MythrilPluginLoader().load_default_enabled()

    try:
        return _dispatch(parser, cli_args, __version__)
    except (NotImplementedError, DeviceUnavailable) as error:
        print(f"myth-tpu-torch: {error}", file=sys.stderr)
        return 2


def _dispatch(parser, cli_args, version: str) -> int:
    if cli_args.command in ("analyze", "a"):
        return _cmd_analyze(parser, cli_args)
    if cli_args.command in ("optimize", "opt"):
        return _cmd_optimize(parser, cli_args)
    if cli_args.command == "safe-functions":
        return _cmd_analyze(parser, cli_args, safe_functions=True)
    if cli_args.command in ("disassemble", "d"):
        from ..frontends.disassembler import Disassembly

        code = cli_args.code
        if code is None and cli_args.codefile:
            with open(cli_args.codefile) as handle:
                code = handle.read().strip()
        if code is None and cli_args.address:
            disassembler = _build_disassembler(cli_args)
            _, contract = disassembler.load_from_address(cli_args.address)
            code = contract.code
        if not code:
            parser.error("provide -c, -f or -a")
        sys.stdout.write(Disassembly(code).get_easm())
        return 0
    if cli_args.command == "concolic":
        from ..concolic.concolic_execution import concolic_execution

        with open(cli_args.input) as handle:
            concrete_data = json.load(handle)
        branches = [int(b, 0) for b in cli_args.branches.split(",")]
        flipped = concolic_execution(concrete_data, branches,
                                     engine=cli_args.engine)
        print(json.dumps(flipped, indent=2))
        return 0
    if cli_args.command == "function-to-hash":
        from ..mythril import MythrilDisassembler

        print(MythrilDisassembler.hash_for_function_signature(
            cli_args.signature))
        return 0
    if cli_args.command == "hash-to-address":
        from ..support.signatures import SignatureDB

        for name in SignatureDB().get(cli_args.hash) or ["unknown"]:
            print(name)
        return 0
    if cli_args.command == "list-detectors":
        from ..analysis.module import ModuleLoader

        for module in ModuleLoader().get_detection_modules():
            print(f"{module.__class__.__name__}: {module.name} "
                  f"(SWC-{module.swc_id})")
        return 0
    if cli_args.command == "version":
        print(f"myth-tpu-torch {version}")
        return 0
    parser.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
