"""`analyze --metrics-out M --trace-out T` of the port's CLI against the JAX
package's CLI on the same contracts, both in this process from reset
counters (tests/_torch_engine.py `run_on`), the port on its plain twins
(`frontier.configure(device="cpu")`), both at 128 lanes and 8-step
chunks:

- chip_smoke.py's EXPECTED_OBSERVE is the deterministic part of the JAX
  CLI's snapshot of OBSERVE_CONTRACT under `--engine tpu`, and the port's
  run gives it too (chip_smoke's own `observe_run`), with the same
  ordered counter-track samples and span names;
- the same for a two-contract `--fleet` run;
- `python -m tools.traceview` and `python -m tools.frontierview` read
  both packages' files with exit 0 and print the same section headings;
- `--enable-iprof` under `--engine host` (each CLI in a subprocess):
  the instruction profile names the same opcodes with the same call
  counts."""

import contextlib
import io
import os
import re
import subprocess
import sys

import pytest
import torch

import chip_smoke
from _torch_engine import JAX, PORT, run_on
from _torch_observe import (counter_samples, deterministic, load_events,
                            reset, span_names)
from mythril_tpu.interfaces import cli as jcli
from mythril_tpu_torch.observe import metrics as pmetrics
from mythril_tpu_torch.parallel import frontier as pf

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

#: the fleet run's members
FLEET = ("combo", "branchy")


def jax_run(argv: list) -> int:
    """The JAX CLI in this process from a reset registry and tracer."""
    reset("jax")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            return jcli.main(argv)
    finally:
        reset("jax")


def port_run(name: str, argv: list, metrics_out: str,
             trace_out: str) -> int:
    """The port's CLI in this process on the twins, as chip_smoke's
    observe_tpu phase runs it on the card."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    pf.configure(device="cpu", chunk=chip_smoke.OBSERVE_CHUNK)
    try:
        return chip_smoke.observe_run(name, argv, metrics_out,
                                      trace_out)[0]
    finally:
        pf.reset()
        torch.set_num_threads(threads)


def both(directory: str, argv_of) -> dict:
    """{side: {"exit", "snapshot", "events", "metrics_out", "trace_out"}}
    of one analysis on both CLIs; `argv_of(metrics_out, trace_out)`."""
    import json

    out = {}
    for side in ("jax", "port"):
        metrics_out = os.path.join(directory, f"{side}.metrics.json")
        trace_out = os.path.join(directory, f"{side}.trace.json")
        argv = argv_of(metrics_out, trace_out)
        if side == "jax":
            with pytest.MonkeyPatch.context() as patch:
                patch.setenv("MYTHRIL_TPU_LANES", str(chip_smoke.LANES))
                patch.setenv("MYTHRIL_TPU_CHUNK",
                             str(chip_smoke.OBSERVE_CHUNK))
                exit_code = run_on(JAX, lambda _: jax_run(argv))
        else:
            exit_code = run_on(PORT, lambda _: port_run(
                "observe", argv, metrics_out, trace_out))
        with open(metrics_out, encoding="utf-8") as handle:
            snapshot = json.load(handle)
        out[side] = {"exit": exit_code, "snapshot": snapshot,
                     "events": load_events(trace_out),
                     "metrics_out": metrics_out, "trace_out": trace_out}
    return out


@pytest.fixture(scope="module")
def solo(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("observe-solo"))
    paths = chip_smoke.fleet_files(directory)
    return both(directory, lambda metrics_out, trace_out:
                chip_smoke.observe_argv(paths[chip_smoke.OBSERVE_CONTRACT],
                                        metrics_out, trace_out))


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("observe-fleet"))
    paths = chip_smoke.fleet_files(directory)
    return both(directory, lambda metrics_out, trace_out: [
        *chip_smoke.fleet_argv([paths[name] for name in FLEET]),
        "--metrics-out", metrics_out, "--trace-out", trace_out])


def test_chip_smoke_constant_is_the_jax_snapshot(solo):
    assert solo["jax"]["exit"] == 1
    assert deterministic(solo["jax"]["snapshot"]) \
        == chip_smoke.EXPECTED_OBSERVE
    assert chip_smoke.EXPECTED_OBSERVE["frontier.chunks"] > 1


def test_port_run_gives_the_constant(solo):
    """chip_smoke's helper keeps what this file's helper keeps, and the
    port's snapshot, counter tracks and spans are the JAX run's."""
    assert chip_smoke.TIME_VALUED.keys() == {
        spec.name for spec in pmetrics._METRICS
        if spec.unit in ("s", "ms", "us", "states/s")}
    assert solo["port"]["exit"] == solo["jax"]["exit"]
    assert deterministic(solo["port"]["snapshot"]) \
        == chip_smoke.EXPECTED_OBSERVE
    samples = counter_samples(solo["port"]["events"])
    assert samples == counter_samples(solo["jax"]["events"])
    assert len([track for track, _ in samples
                if track == "frontier.lanes"]) \
        == chip_smoke.EXPECTED_OBSERVE["frontier.chunks"]
    names = span_names(solo["port"]["events"])
    assert names == span_names(solo["jax"]["events"])
    for name in ("svm.create_tx", "frontier.seed", "frontier.device_phase",
                 "frontier.host_continuation", "frontier.merge",
                 "cfa.build", "taint.build", "absint.build",
                 "analyze.contract"):
        assert names[("X", name)] >= 1, name


def test_fleet_run_is_the_jax_run(fleet):
    assert fleet["port"]["exit"] == fleet["jax"]["exit"] == 1
    snapshot = deterministic(fleet["port"]["snapshot"])
    assert snapshot == deterministic(fleet["jax"]["snapshot"])
    assert snapshot["frontier.fleet.phases"] == 1
    assert set(snapshot["frontier.fleet.lane_steps"]) == set(FLEET)
    assert counter_samples(fleet["port"]["events"]) \
        == counter_samples(fleet["jax"]["events"])
    names = span_names(fleet["port"]["events"])
    assert names == span_names(fleet["jax"]["events"])
    assert names[("X", "analyze.fleet")] == 1
    assert names[("X", "frontier.fleet.device_phase")] == 1


@pytest.mark.parametrize("run", ["solo", "fleet"])
def test_views_read_both_packages_files(request, run):
    """The stdlib viewers print the same sections from either package's
    trace and snapshot."""
    got = request.getfixturevalue(run)
    headings = {}
    for side in ("jax", "port"):
        headings[side] = chip_smoke.view_headings(got[side]["trace_out"],
                                                  got[side]["metrics_out"])
    assert headings["port"] == headings["jax"]
    assert "== per-phase wall time ==" in headings["port"]["traceview"]
    assert "== frontier telemetry ==" in headings["port"]["frontierview"]


#: one line of the instruction profile: its opcode and call count
PROFILE_LINE = re.compile(r"^\s+\[\s*[0-9.]+ %\] (\S+): (\d+) calls,", re.M)


def test_instruction_profile_is_the_jax_profile(tmp_path):
    """`--enable-iprof` logs the "Instruction Perf Profile" from the
    registry's `profiler.instruction_us` histograms: the same opcodes and
    call counts on both CLIs."""
    env = dict(os.environ, HOME=str(tmp_path), PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    argv = [*chip_smoke.analyze_argv(*chip_smoke.ANALYZE_RUNS["tx_origin"]),
            "--enable-iprof"]
    profiles = {}
    for side, package in (("jax", "mythril_tpu"),
                          ("port", "mythril_tpu_torch")):
        proc = subprocess.run(
            [sys.executable, "-m", package, "-v", "4", *argv],
            capture_output=True, text=True, cwd=str(tmp_path), env=env,
            timeout=600)
        assert proc.returncode == 1, proc.stderr[-2000:]
        assert "Instruction Perf Profile" in proc.stderr
        profiles[side] = sorted((op, int(count)) for op, count
                                in PROFILE_LINE.findall(proc.stderr))
    assert profiles["port"] == profiles["jax"]
    assert len(profiles["port"]) > 10
