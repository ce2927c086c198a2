"""The port's tools against the JAX package's, on the CPU.

* tools/torch_cfaview.py: stdout and exit code equal tools/cfaview.py's on
  the cases of tests/test_cfa.py (469-525: the report over the corpus
  contracts, `killbilly`, a hex string, garbage, `killbilly --taint`,
  `bectoken --taint --json`) and on an `--absint` case;
* tools/torch_loadgen.py's workload and rollups equal tools/loadgen.py's
  on the same seed and records;
* chip_smoke's EXPECTED_LOAD is the JAX daemon's reply to each corpus
  contract, and the port's service gives it under `"engine": "tpu"`;
* the daemon settings of the port's load profiles, chaos phases and serve
  smoke, given to tools/torch_loadgen.py's launcher as arguments, equal
  what the JAX tools put on the daemon's command line and in its
  environment (each daemon's start captured, none run);
* tools/torch_serve_smoke.py end to end against the port's daemon."""

import contextlib
import io
import json
import os
import random
import subprocess
import sys

import pytest

import test_cfa
from mythril_tpu.frontends.asm import assemble
from mythril_tpu.frontends.disassembler import Disassembly as JDisassembly
from mythril_tpu.staticanalysis import build_cfa as jbuild_cfa
from mythril_tpu_torch.frontends.disassembler import Disassembly
from mythril_tpu_torch.serve import autoscale as pautoscale
from mythril_tpu_torch.staticanalysis import build_cfa
from tools import (cfaview, chaos_smoke, loadgen, serve_smoke, torch_cfaview,
                   torch_chaos_smoke, torch_loadgen, torch_serve_smoke)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


# -- cfaview ---------------------------------------------------------------------------


def _main(module, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = module.main(argv)
    return code, out.getvalue(), err.getvalue()


CFAVIEW_CASES = {
    "killbilly": ["killbilly"],
    "hex": [assemble(test_cfa.DIAMOND).hex()],
    "garbage": ["not-hex-not-a-file"],
    "killbilly-taint": ["killbilly", "--taint"],
    "bectoken-taint-json": ["bectoken", "--taint", "--json"],
    "bectoken-absint": ["bectoken", "--absint"],
}


@pytest.mark.parametrize("argv", list(CFAVIEW_CASES.values()),
                         ids=list(CFAVIEW_CASES))
def test_cfaview_cli_matches_jax(argv):
    """`torch_cfaview.main` prints what `cfaview.main` prints and exits
    with its code (2 and "cannot load" on garbage)."""
    code, out, err = _main(torch_cfaview, argv)
    jcode, jout, _ = _main(cfaview, argv)
    assert (code, out) == (jcode, jout)
    if argv == CFAVIEW_CASES["garbage"]:
        assert code == 2 and "cannot load" in err
    else:
        assert code == 0 and out


def test_cfaview_report_matches_jax_on_corpus():
    """`report` over every corpus contract (the vendored headline
    contracts when the reference corpus is absent), as
    tests/test_cfa.py's report case."""
    contracts = test_cfa._corpus_bytecodes()
    assert contracts
    for name, bytecode in contracts:
        jdis, dis = JDisassembly(bytecode), Disassembly(bytecode)
        text = torch_cfaview.report(build_cfa(dis), dis.instruction_list)
        assert text == cfaview.report(jbuild_cfa(jdis),
                                      jdis.instruction_list), name
        assert "== merge points" in text and "== blocks ==" in text


def test_cfaview_vendored_contracts_match_measure_headline():
    """The copied function tables are tools/measure_headline.py's."""
    from tools import measure_headline

    assert torch_cfaview.KILLBILLY == measure_headline.KILLBILLY
    assert torch_cfaview.BECTOKEN == measure_headline.BECTOKEN


# -- loadgen's workload and rollups ----------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 5, 6, 40])
def test_build_corpus_matches_jax(n):
    assert torch_loadgen.build_corpus(n) == loadgen.build_corpus(n)


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_schedule_and_picks_match_jax(seed):
    """`arrival_times` then `pick_contract` from one RNG each, as
    `run_profile` and `run_load` draw them."""
    draws = []
    for module in (loadgen, torch_loadgen):
        rng = random.Random(seed)
        corpus = module.build_corpus(5)
        times = module.arrival_times(30.0, 4.0, rng)
        picks = [module.pick_contract(corpus, rng) for _ in times]
        draws.append((times, picks))
    assert draws[0] == draws[1] and len(draws[0][0]) > 50


def _records(seed):
    """Synthetic records of every outcome, with the port's extra keys."""
    rng = random.Random(seed)
    outcomes = ["ok"] * 6 + ["overloaded", "quarantined",
                             "transport:ServeClientError"]
    return [{"at_s": round(rng.uniform(0, 30), 3),
             "priority": rng.choice(["interactive", "bulk"]),
             "outcome": rng.choice(outcomes),
             "cached": rng.random() < 0.3,
             "elapsed_ms": rng.uniform(1.0, 9000.0),
             "code": "6000", "result": None, "frontier": None}
            for _ in range(rng.randint(0, 60))]


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_rollups_match_jax(seed):
    """`_quantile`, `summarize_class` and `summarize` on the same records
    and sampler trajectory."""
    records = _records(seed)
    values = sorted(r["elapsed_ms"] for r in records)
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert torch_loadgen._quantile(values, q) == \
            loadgen._quantile(values, q)
    assert torch_loadgen.summarize_class(records) == \
        loadgen.summarize_class(records)
    trajectory = [{"t_s": t, "pool_live": t % 3, "pool_target": 2,
                   "scale_ups": t // 4, "store_hits": t,
                   "store_hit_rate": 0.5} for t in range(seed * 3)]
    args = loadgen.build_parser().parse_args(loadgen_profile("contended"))
    port_args = torch_loadgen.build_parser().parse_args(
        loadgen_profile("contended"))
    assert torch_loadgen.summarize(records, trajectory, port_args) == \
        loadgen.summarize(records, trajectory, args)


# -- the daemons' settings --------------------------------------------------------------


class _FakeDaemon:
    """A Popen that records its command and environment and runs
    nothing; it reads as a process that exited at once."""

    started = []

    def __init__(self, cmd, env=None, **_):
        self.cmd, self.env = list(cmd), dict(env or os.environ)
        self.returncode = 0
        self.stderr = io.BytesIO(b"")
        _FakeDaemon.started.append(self)

    def poll(self):
        return 0

    def wait(self, timeout=None):
        return 0

    def kill(self):
        pass


@pytest.fixture
def captured(monkeypatch):
    _FakeDaemon.started = []
    monkeypatch.setattr(subprocess, "Popen", _FakeDaemon)
    return _FakeDaemon.started


#: the JAX knobs the JAX tools put in a daemon's environment, as the
#: service setting each stands for
KNOBS = {
    "MYTHRIL_TPU_SERVE_QUEUE_MAX": ("queue_max", int),
    "MYTHRIL_TPU_SERVE_AUTOSCALE_INTERVAL_MS": ("autoscale_interval_ms", int),
    "MYTHRIL_TPU_SERVE_WORKER_HEARTBEAT_MS": ("heartbeat_ms", int),
    "MYTHRIL_TPU_RESULT_STORE": ("result_store", lambda v: v != "0"),
}

#: the JAX knobs the JAX tools set to the port's default, so that the
#: port's tools pass nothing for them
AT_DEFAULT = {"MYTHRIL_TPU_SERVE_AUTOSCALE_UP_AFTER": pautoscale.UP_AFTER}

#: the JAX serve CLI's settings that `_cmd_serve` hands to the service
#: only when given (the others always)
OPTIONAL = ("workers", "workers_min", "workers_max", "max_inflight",
            "queue_max")


def jax_settings(daemon):
    """A JAX tool's daemon start as (service settings, slog path): its
    serve flags as the JAX CLI parses them, then its knobs."""
    import argparse

    from mythril_tpu.interfaces import cli as jcli

    cmd = daemon.cmd
    assert cmd[1:4] == ["-m", "mythril_tpu.interfaces.cli", "serve"], cmd
    parser = argparse.ArgumentParser()
    jcli._add_serve_args(parser)
    args = vars(parser.parse_args(cmd[4:]))
    settings = {"solver": args["solver"], "engine": args["engine"]}
    if args["inject_fault"] is not None:
        settings["inject_fault"] = args["inject_fault"]
    settings.update({name: args[name] for name in OPTIONAL
                     if args.get(name) is not None})
    for knob, (name, parse) in KNOBS.items():
        if knob in daemon.env and knob not in os.environ:
            settings[name] = parse(daemon.env[knob])
    for knob, default in AT_DEFAULT.items():
        if knob in daemon.env and knob not in os.environ:
            assert int(daemon.env[knob]) == default, knob
    return settings, daemon.env.get("MYTHRIL_TPU_SLOG")


def port_settings(daemon):
    """The port tool's launcher start as (service settings, slog path)."""
    cmd = daemon.cmd
    assert cmd[1:4] == ["-m", "tools.torch_loadgen", "daemon"], cmd
    for knob in (*KNOBS, *AT_DEFAULT):
        assert daemon.env.get(knob) == os.environ.get(knob)
    args = torch_loadgen.build_daemon_parser().parse_args(cmd[4:])
    settings = torch_loadgen.service_settings(args)
    settings.pop("manifest_path")
    if settings["inject_fault"] is None:
        settings.pop("inject_fault")
    return settings, args.slog


def _same_settings(jax_daemon, port_daemon):
    jax, jax_slog = jax_settings(jax_daemon)
    port, port_slog = port_settings(port_daemon)
    assert port == jax
    assert (port_slog is None) == (jax_slog is None)
    return port


#: the load profiles: the SLO A/B's two, the tool's defaults and its
#: chaos variant (tools/loadgen.py's usage)
PROFILES = {"baseline": torch_loadgen.BASELINE_PROFILE,
            "contended": torch_loadgen.CONTENDED_PROFILE, "default": [],
            "chaos": ["--inject-fault", "worker_segv:5", "--max-inflight",
                      "2"]}


def loadgen_profile(name):
    return list(PROFILES[name])


@pytest.fixture
def private_tmp(monkeypatch, tmp_path):
    """The tools' work directories under the case's tmp_path."""
    import itertools
    import tempfile

    counter = itertools.count()

    def mkdtemp(prefix="tmp", **_):
        path = tmp_path / f"{prefix}{next(counter)}"
        path.mkdir()
        return str(path)

    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)


def test_profiles_are_the_jax_slo_ab(monkeypatch):
    """`BASELINE_PROFILE` and `CONTENDED_PROFILE` are the arguments the
    JAX `slo_ab` parses; the port's parser adds only `--engine`."""
    parsed = []
    monkeypatch.setattr(loadgen, "run_profile",
                        lambda args: parsed.append(args) or {
                            "classes": {"interactive": {"p99_ms": 1.0,
                                                        "shed_rate": 0.0},
                                        "bulk": {"shed": 0}},
                            "config": {"rate_hz": args.rate},
                            "cache": {"store_hit_rate": 0.0},
                            "autoscale": {"scale_ups": 0}})
    loadgen.slo_ab()
    port = torch_loadgen.build_parser()
    ported = [vars(port.parse_args(profile)) for profile in (
        torch_loadgen.BASELINE_PROFILE, torch_loadgen.CONTENDED_PROFILE)]
    assert all(args.pop("engine") == "host" for args in ported)
    assert [vars(args) for args in parsed] == ported


@pytest.mark.parametrize("profile", ["baseline", "contended", "default",
                                     "chaos"])
def test_load_profile_settings_match_jax(profile, captured, private_tmp):
    """Each load profile's daemon gets the JAX tool's settings."""
    argv = loadgen_profile(profile)
    loadgen.SpawnedDaemon(loadgen.build_parser().parse_args(argv))
    torch_loadgen.SpawnedDaemon(torch_loadgen.build_parser().parse_args(argv))
    settings = _same_settings(*captured)
    assert settings["engine"] == "host" and settings["solver"] == "cdcl"
    if profile == "contended":
        assert settings == {"solver": "cdcl", "engine": "host",
                            "workers": 1, "workers_min": 1, "workers_max": 2,
                            "queue_max": 4, "autoscale_interval_ms": 300}


@pytest.mark.parametrize("phase", ["segv", "hang", "quarantine"])
def test_chaos_phase_settings_match_jax(phase, captured, monkeypatch,
                                       private_tmp):
    """Each chaos phase's daemon gets the JAX tool's settings: one worker,
    the fault, no result store, the structured log, and the hang phase's
    3 s heartbeat."""
    for module in (chaos_smoke, torch_chaos_smoke):
        monkeypatch.setattr(module._Phase, "wait_for_socket",
                            lambda self, timeout_s=180.0: False)
        getattr(module, f"_phase_{phase}")("6000")
    jax_daemon, port_daemon = captured
    settings = _same_settings(jax_daemon, port_daemon)
    assert settings["result_store"] is False and settings["workers"] == 1
    assert ("heartbeat_ms" in settings) == (phase == "hang")


def test_serve_smoke_settings_match_jax(captured, private_tmp, capsys):
    """The serve smoke's daemon: the defaults and the structured log."""
    for module in (serve_smoke, torch_serve_smoke):
        assert module.main() == 1  # the captured daemon "died" at once
    assert "daemon died before binding" in capsys.readouterr().err
    settings = _same_settings(*captured)
    assert settings == {"solver": "cdcl", "engine": "host"}


def test_launcher_settings_reach_the_service():
    """Every launcher flag names a keyword of the port's AnalysisService,
    and the unset ones keep the JAX knobs' defaults."""
    import inspect

    from mythril_tpu_torch.serve.service import AnalysisService

    parser = torch_loadgen.build_daemon_parser()
    full = torch_loadgen.service_settings(parser.parse_args([
        "--socket", "s", "--manifest", "m", "--workers", "2",
        "--workers-min", "1", "--workers-max", "3", "--max-inflight", "2",
        "--queue-max", "4", "--inject-fault", "worker_segv:2",
        "--autoscale-interval-ms", "300", "--heartbeat-ms", "3000",
        "--no-result-store"]))
    assert set(full) <= set(inspect.signature(AnalysisService).parameters)
    bare = torch_loadgen.service_settings(parser.parse_args(
        ["--socket", "s", "--manifest", "m"]))
    assert bare == {"solver": "cdcl", "engine": "host", "manifest_path": "m",
                    "inject_fault": None}


def test_autoscale_up_after_other_than_the_default_is_refused(private_tmp):
    """The port's daemon scales up after UP_AFTER; the JAX tool's flag
    takes no other value."""
    args = torch_loadgen.build_parser().parse_args(
        ["--autoscale-up-after", "3"])
    with pytest.raises(ValueError, match="scales up after 2"):
        torch_loadgen.daemon_argv(args, "s", "m")


# -- the corpus's replies ----------------------------------------------------------------


def _corpus_replies(side, engine):
    """One analyze request of each corpus contract, in process, through
    one side's service: {code: (result, frontier counters)}."""
    from mythril_tpu.serve import protocol as jprotocol
    from mythril_tpu.serve import service as jservice
    from mythril_tpu_torch.serve import protocol as pprotocol
    from mythril_tpu_torch.serve import service as pservice

    service_module, protocol = {"jax": (jservice, jprotocol),
                                "port": (pservice, pprotocol)}[side.name]
    service = service_module.AnalysisService(
        solver="cdcl", engine=engine, warmup=False, workers=0)
    replies = {}
    for code in loadgen.build_corpus(5):
        reply = service.handle(protocol.parse_request(json.dumps(
            {"op": "analyze", "id": code, "code": code,
             "priority": "interactive"})))
        replies[code] = (torch_loadgen.reply_result(reply),
                         reply.get("frontier"))
    service.shutdown(drain_ms=0)
    return replies


def test_expected_load_is_the_jax_daemons(monkeypatch):
    """Each corpus contract's result from tools/loadgen.py's daemon
    settings (engine host, solver cdcl) on the JAX service and its
    frontier counters under engine tpu (the JAX frontier on the CPU) are
    EXPECTED_LOAD's; the port's service under engine tpu (its twins)
    gives both. 16 lanes on both sides: the counters are the same at the
    default width."""
    import torch

    from _torch_engine import JAX, PORT, run_on
    from chip_smoke import EXPECTED_LOAD
    from mythril_tpu_torch.parallel import frontier as pf

    monkeypatch.setenv("MYTHRIL_TPU_LANES", "16")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    pf.configure(lanes=16, device="cpu")
    try:
        host = run_on(JAX, _corpus_replies, "host")
        device = run_on(JAX, _corpus_replies, "tpu")
        port = run_on(PORT, _corpus_replies, "tpu")
    finally:
        pf.reset()
        torch.set_num_threads(threads)
    expected = {code: (entry["result"], entry["frontier"])
                for code, entry in EXPECTED_LOAD.items()}
    assert {code: (host[code][0], device[code][1]) for code in host} \
        == expected
    assert {code: device[code][0] for code in device} \
        == {code: entry[0] for code, entry in expected.items()}
    assert port == expected


# -- the serve smoke end to end --------------------------------------------------------


def test_torch_serve_smoke_runs():
    """Start, ping, analyze, scrape and shut down the port's daemon."""
    proc = subprocess.run([sys.executable, "-m", "tools.torch_serve_smoke"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=170)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("SERVE_SMOKE=ok issues=1"), proc.stdout
