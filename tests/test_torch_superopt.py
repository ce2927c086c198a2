"""The port's gas superoptimizer (mythril_tpu_torch/superopt/) against the
JAX package's (mythril_tpu/superopt/).

- The seven tests of tests/test_superopt.py (14 cases) against the port:
  accepted rewrites replayed on 48 seeded random environments, no
  divergence or self-check failure, real gas saved, code length kept, the
  gas table in parity with the port's opcode schedule.
- On the four codes of chip_smoke.py's OPTIMIZE_CODES (that corpus and
  bench.py's superopt contract at 12 blocks), under `cdcl` and under
  `jax`, the port's `optimize_bytecode(..., crosscheck=1).to_json()`
  equals the JAX package's but for `wall_ms`, exactly, and so do the
  `superopt.*` metrics the run leaves in each package's registry. The
  port's `jax` route runs K11's plain twin (`dispatch.configure(
  device="cpu")`), the JAX package's its own jitted lane on the CPU. The
  reports hold counts and verdicts, never clause lists, so the CNF's
  dependence on the process (ROADMAP C) cannot show in them.
- `STATIC_GAS` equal; for every reachable block of those codes,
  `rules.enumerate_candidates` gives equal lists and `encode.simulate`
  equal transformers (terms compared with commutative operands sorted).
- The engine's keyword defaults and the CLI's are the JAX knobs'.
- chip_smoke.py's EXPECTED_OPTIMIZE recomputed from the JAX package, and
  its own check passes the port's reports.

Every run starts from both packages' counters, solver backend, registry
and tracer reset (tests/_torch_engine.py `fresh`)."""

import hashlib
import random

import pytest
import torch

import bench
import chip_smoke
from _torch_engine import COMMUTATIVE, JAX, PORT, fresh
from mythril_tpu import staticanalysis as jstaticanalysis
from mythril_tpu.superopt import encode as jencode
from mythril_tpu.superopt import engine as jengine
from mythril_tpu.superopt import gas as jgas
from mythril_tpu.superopt import rules as jrules
from mythril_tpu.support.tpu_config import REGISTRY
from mythril_tpu_torch import staticanalysis as pstaticanalysis
from mythril_tpu_torch.ops.opcodes import GAS, OPCODES
from mythril_tpu_torch.smt.solver import dispatch as pdispatch
from mythril_tpu_torch.superopt import encode, optimize_bytecode
from mythril_tpu_torch.superopt import engine as pengine
from mythril_tpu_torch.superopt import gas as pgas
from mythril_tpu_torch.superopt import rules as prules
from mythril_tpu_torch.superopt.gas import STATIC_GAS, parity_errors
from test_superopt import SYNTHETIC

N_REPLAY_ENVS = 48          # >= 40 random environments per rewrite
REPLAY_SEED = 0xC0FFEE

SUPEROPT = {"jax": (jengine, jencode, jrules, jstaticanalysis),
            "port": (pengine, encode, prules, pstaticanalysis)}
CODES = chip_smoke.OPTIMIZE_CODES
#: tests/test_superopt.py's corpus
CORPUS = ("synthetic", "killbilly", "bectoken")


@pytest.fixture(scope="module", autouse=True)
def port_lane_on_the_cpu():
    """The port's dispatch flushes onto K11's plain twin, on one torch
    thread: the twin is many small ops, and beside the other test workers
    a pool of threads an op took it from seconds to minutes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    pdispatch.configure(device="cpu")
    yield
    pdispatch.reset_settings()
    torch.set_num_threads(threads)


_RUNS = {}


def run(side, solver: str, name: str) -> tuple:
    """(report, `superopt.*` metrics) of one `optimize_bytecode(...,
    crosscheck=1)` run from fresh counters on one side, each run once."""
    key = (side.name, solver, name)
    if key not in _RUNS:
        fresh(side)
        try:
            report = SUPEROPT[side.name][0].optimize_bytecode(
                CODES[name], solver=solver, crosscheck=1)
            metrics = {metric: value for metric, value
                       in side.metrics.snapshot().items()
                       if metric.startswith("superopt.")}
        finally:
            fresh(side)
        _RUNS[key] = (report, metrics)
    return _RUNS[key]


def without_wall(report) -> dict:
    return {key: value for key, value in report.to_json().items()
            if key != "wall_ms"}


def _body(listing):
    """Parse a BlockRewrite before/after disassembly back to BodyOps."""
    body = []
    for entry in listing:
        name, _, imm = entry.partition(" ")
        body.append((name, int(imm, 16) if imm else None))
    return body


# -- tests/test_superopt.py against the port -----------------------------------------


@pytest.mark.parametrize("name", CORPUS)
def test_accepted_rewrites_replay_concretely(name):
    report, _ = run(PORT, "cdcl", name)
    rng = random.Random(REPLAY_SEED)
    for rewrite in report.rewrites:
        before = _body(rewrite.before)
        after = _body(rewrite.after)
        constants = tuple(imm for op in (before + after)
                          for _, imm in [op] if imm is not None)
        depth = 20 + 2 * len(before)
        for _ in range(N_REPLAY_ENVS):
            env = encode.random_env(rng, depth, interesting=constants)
            assert not encode.differ_concretely(before, after, env), (
                name, rewrite.rule, rewrite.start_pc, env)


@pytest.mark.parametrize("name", CORPUS)
def test_no_divergences_or_selfcheck_failures(name):
    report, _ = run(PORT, "cdcl", name)
    stats = report.proof_stats
    assert stats["divergences"] == 0, stats
    assert stats["selfcheck_failures"] == 0, stats
    accepted_proven = sum(1 for r in report.rewrites
                          if r.proof != "syntactic")
    assert stats["crosschecks"] >= min(accepted_proven, 1), stats


def test_corpus_run_reports_positive_gas_saved():
    reports = [run(PORT, "cdcl", name)[0] for name in CORPUS]
    assert sum(report.gas_saved for report in reports) > 0
    for report in reports:
        assert report.gas_saved >= 0
        assert report.weighted_gas_saved >= report.gas_saved
        for rewrite in report.rewrites:
            assert rewrite.gas_saved > 0


@pytest.mark.parametrize("name", ["killbilly", "synthetic"])
def test_rewritable_contracts_actually_rewrite(name):
    report, _ = run(PORT, "cdcl", name)
    assert len(report.rewrites) > 0, report.to_json()
    assert report.gas_saved > 0


@pytest.mark.parametrize("name", CORPUS)
def test_total_code_length_is_invariant(name):
    report, _ = run(PORT, "cdcl", name)
    assert len(report.code_out) == len(report.code_in)
    if report.rewrites:
        assert report.code_out != report.code_in


def test_gas_table_parity_with_opcode_schedule():
    assert parity_errors(OPCODES, GAS) == ()


def test_gas_table_prices_the_minimum_schedule():
    for mnemonic in ("SLOAD", "BALANCE", "CALL", "SSTORE"):
        assert STATIC_GAS[mnemonic] == OPCODES[mnemonic][GAS][0]


# -- the port against the JAX package ------------------------------------------------


@pytest.mark.parametrize("solver", chip_smoke.OPTIMIZE_SOLVERS)
@pytest.mark.parametrize("name", sorted(CODES))
def test_reports_equal_the_jax_package(solver, name):
    """The whole report but its wall, and the `superopt.*` metrics."""
    port, port_metrics = run(PORT, solver, name)
    jax, jax_metrics = run(JAX, solver, name)
    assert without_wall(port) == without_wall(jax)
    assert port_metrics == jax_metrics
    assert port.proof_stats["batched"] == (solver == "jax")
    if solver == "jax" and port.proof_stats["queries"]:
        assert "device" in {rewrite.proof for rewrite in port.rewrites}


def test_static_gas_equals_the_jax_table():
    assert pgas.STATIC_GAS == jgas.STATIC_GAS
    assert list(pgas.STATIC_GAS) == list(jgas.STATIC_GAS)


def digest(term, memo: dict) -> str:
    """A term's digest up to the order of commutative operands (the order
    depends on the process, ROADMAP C): equal for two packages' terms
    exactly when they agree but for that order."""
    stack = [term]
    while stack:
        node = stack[-1]
        if node in memo:
            stack.pop()
            continue
        pending = [arg for arg in node.args if arg not in memo]
        if pending:
            stack.extend(pending)
            continue
        stack.pop()
        args = [memo[arg] for arg in node.args]
        if node.op in COMMUTATIVE:
            args.sort()
        text = f"{node.op} {node.params!r} {node.sort!r} {' '.join(args)}"
        memo[node] = hashlib.sha256(text.encode()).hexdigest()
    return memo[term]


def block_views(side_name: str, name: str) -> list:
    """Every reachable block of a code: its body, its candidates and the
    digest of its transformer (consumed depth, growth, outputs, memory,
    storage)."""
    engine, enc, rules, static = SUPEROPT[side_name]
    disassembly = engine.Disassembly(CODES[name])
    cfa = static.get_cfa(disassembly)
    views, memo = [], {}
    for block in cfa.blocks:
        if block.block_id not in cfa.reachable:
            continue
        layout = engine._block_layout(disassembly, block)
        if layout is None or not enc.is_encodable(layout.body):
            views.append((block.block_id, None))
            continue
        candidates = rules.enumerate_candidates(
            layout.body, pengine.DEFAULT_MAX_BLOCK_LEN,
            pengine.DEFAULT_CANDIDATES)
        shape = enc.simulate(layout.body, f"so{block.block_id}")
        views.append((block.block_id, layout.body, candidates,
                      shape.consumed, shape.max_growth,
                      [digest(term, memo) for term in shape.outputs],
                      digest(shape.memory, memo),
                      digest(shape.storage, memo)))
    return views


@pytest.mark.parametrize("name", sorted(CODES))
def test_candidates_and_transformers_equal(name):
    port = block_views("port", name)
    assert port == block_views("jax", name)
    assert any(len(view) > 2 and view[2][0] for view in port)


def test_knob_defaults_are_the_jax_registry():
    """The engine's keyword defaults and the CLI's are the JAX knobs'
    (MYTHRIL_TPU_SUPEROPT_*), and `optimize_bytecode` reads no knob."""
    import argparse
    import inspect

    from mythril_tpu_torch.interfaces import cli

    knobs = {"max_block_len": "MAX_BLOCK_LEN",
             "candidates_budget": "CANDIDATES", "crosscheck": "CROSSCHECK"}
    signature = inspect.signature(optimize_bytecode)
    for argument, knob in knobs.items():
        default = REGISTRY["MYTHRIL_TPU_SUPEROPT_" + knob].default
        assert signature.parameters[argument].default == default
        assert getattr(pengine, "DEFAULT_" + knob) == default
    parser = argparse.ArgumentParser()
    cli._add_optimize_args(parser)
    parsed = parser.parse_args([])
    assert (parsed.max_block_len, parsed.candidates, parsed.crosscheck) == \
        tuple(REGISTRY["MYTHRIL_TPU_SUPEROPT_" + knob].default
              for knob in knobs.values())
    assert not hasattr(pengine, "tpu_config")


def test_chip_smoke_constants_are_the_jax_reports():
    """chip_smoke.py's copies of the assembly are the tests' and bench's;
    EXPECTED_OPTIMIZE is the JAX package's reports; the phase's own check
    passes the port's (K11's twin under `jax`)."""
    assert chip_smoke.SUPEROPT_SYNTHETIC == SYNTHETIC
    assert chip_smoke.superopt_contract() == bench._superopt_contract()
    for solver in chip_smoke.OPTIMIZE_SOLVERS:
        for name in CODES:
            jax = without_wall(run(JAX, solver, name)[0])
            assert jax["code_in"] == CODES[name]
            del jax["code_in"]
            assert jax == chip_smoke.EXPECTED_OPTIMIZE[solver][name], \
                (solver, name)
            chip_smoke.check_optimize(solver, name,
                                      run(PORT, solver, name)[0].to_json())
    proofs = [rewrite["proof"] for rewrite in chip_smoke.EXPECTED_OPTIMIZE[
        "jax"][chip_smoke.OPTIMIZE_DEVICE_RUN]["rewrites"]]
    assert proofs == ["device"] * chip_smoke.OPTIMIZE_DEVICE_PROOFS
