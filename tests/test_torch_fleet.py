"""The port's fleet driver (mythril_tpu_torch/parallel/fleet.py
`FleetDriver`, `FleetMember`, and the fleet half of `frontier.Frontier`)
against the JAX package's (`mythril_tpu.parallel.frontier`), at 16 lanes:
the port on its plain twins (`frontier.configure(lanes=16,
device="cpu")`), the JAX package on the CPU (`MYTHRIL_TPU_LANES=16`),
bfs, one transaction, the modules AccidentallyKillable and
IntegerArithmetics, on tests/test_fleet.py's corpus (branchy, addflow,
combo). The JAX fleets run once for the module (`jax_fleets`).

- Parity: the port's `--fleet` analyzer gives each contract the JAX
  fleet's detections (SWC id, address, function and each step's
  selector, as test_fleet.py's `_analyze_corpus` reads them), and the
  driver's phases, lane-steps and forks and each member's occupancy are
  the JAX driver's (its `frontier.fleet.lane_steps` labels).
- Sharded: with `configure(fleet_shard=2, steal_cadence=1,
  steal_min_imbalance=1)` the detections are the unsharded fleet's, steal
  passes ran, and the counters are the JAX fleet's under
  MYTHRIL_TPU_FLEET_SHARD=2 and the same steal knobs.
- A drained member: addflow's preempt event is set before `run` (on both
  packages, where a 1 s budget would not be deterministic): its laser is
  timed out with the JAX member's dropped states, and the others complete
  (branchy keeps SWC-106).
- The CLI: `analyze --engine tpu --fleet -f` x3 `-o json`, in process,
  gives the JAX CLI's report (`report_parity`) and exit code.
- Seams: a fleet on the default device raises naming the CUDA device
  before any turn; `--fleet` with one contract or `--engine host` runs
  one by one; `--checkpoint P --fleet` writes `P.<contract id>` for each
  member and no device file; a checkpoint of another contract id is not
  resumed; `_unique_contract_ids` is the JAX function."""

import contextlib
import io
import json
import logging
import os
import threading
from types import SimpleNamespace

import pytest
import torch

from _torch_engine import JAX, PORT, report_parity, run_on
from test_fleet import ADDFLOW, BRANCHY, COMBO, MODULES, _creation_hex
from mythril_tpu.analysis import security as jsecurity
from mythril_tpu.analysis import symbolic as jsymbolic
from mythril_tpu.interfaces import cli as jcli
from mythril_tpu.mythril import mythril_analyzer as janalyzer
from mythril_tpu.observe import metrics as jmetrics
from mythril_tpu.parallel import frontier as jf
from mythril_tpu.support import checkpoint as jcheckpoint
from mythril_tpu_torch import exceptions as pexceptions
from mythril_tpu_torch.analysis import security as psecurity
from mythril_tpu_torch.analysis import symbolic as psymbolic
from mythril_tpu_torch.interfaces import cli as pcli
from mythril_tpu_torch.mythril import mythril_analyzer as panalyzer
from mythril_tpu_torch.parallel import fleet as pfleet
from mythril_tpu_torch.parallel import frontier as pf
from mythril_tpu_torch.support import checkpoint as pcheckpoint

N_LANES = 16
CORPUS = [("branchy", _creation_hex(BRANCHY)),
          ("addflow", _creation_hex(ADDFLOW)),
          ("combo", _creation_hex(COMBO))]
#: the sharded runs' settings, and the JAX knobs that give them
SHARDED = dict(fleet_shard=2, steal_cadence=1, steal_min_imbalance=1)
SHARDED_ENV = {"MYTHRIL_TPU_FLEET_SHARD": "2",
               "MYTHRIL_TPU_STEAL_CADENCE": "1",
               "MYTHRIL_TPU_STEAL_MIN_IMBALANCE": "1"}
#: each side's fleet driver and member, wrapper, detector harvest and CLI
FLEET = {"jax": SimpleNamespace(
             driver=jf.FleetDriver, member=jf.FleetMember, cli=jcli,
             symbolic=jsymbolic, security=jsecurity),
         "port": SimpleNamespace(
             driver=pfleet.FleetDriver, member=pfleet.FleetMember, cli=pcli,
             symbolic=psymbolic, security=psecurity)}


@pytest.fixture(scope="module", autouse=True)
def _sixteen_lanes():
    """Both packages at 16 lanes, the port's twins on one torch thread."""
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


@contextlib.contextmanager
def driver_counters(side):
    """Yields a dict that, after the block, holds the counters of the one
    fleet driver that ran in it: phases, lane-steps, forks, steal passes
    and rows moved (summed over the phases) and lane-steps by contract."""
    fleet = FLEET[side.name]
    seen = {}
    run, phase = fleet.driver.run, fleet.driver._device_phase

    def counted_run(driver):
        seen["driver"] = driver
        seen["steals"] = [0, 0]
        return run(driver)

    def counted_phase(driver, gated):
        phase(driver, gated)
        if side is JAX:  # the JAX frontier keeps the last summary's block
            fr = driver.frontier
            seen["steals"][0] += fr._steal_passes
            if fr._shard_steals is not None:
                seen["steals"][1] += int(fr._shard_steals[2])

    if side is JAX:
        jmetrics.reset("frontier.fleet.lane_steps")
    counters = {}
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(fleet.driver, "run", counted_run)
        patch.setattr(fleet.driver, "_device_phase", counted_phase)
        yield counters
    driver = seen["driver"]
    counters.update(phases=driver.phases, lane_steps=driver.lane_steps,
                    forks=driver.forks)
    if side is JAX:
        counters["steal_passes"], counters["steal_rows"] = seen["steals"]
        counters["occupancy"] = {
            label: int(jmetrics.histogram("frontier.fleet.lane_steps",
                                          label).total)
            for label in jmetrics.labels("frontier.fleet.lane_steps")}
    else:
        counters.update(steal_passes=driver.steal_passes,
                        steal_rows=driver.steal_rows,
                        occupancy=dict(driver.occupancy))


def digests(issues, names) -> dict:
    """{contract: sorted (SWC id, address, function, step selectors)}."""
    found = {name: [] for name in names}
    for issue in issues:
        found[issue.contract].append(
            (issue.swc_id, issue.address, issue.function,
             [step.get("input", "")[:10] for step in
              issue.transaction_sequence["steps"]]))
    return {name: sorted(rows) for name, rows in found.items()}


def analyzer_for(side, corpus, **options):
    disassembler = side.mythril.MythrilDisassembler()
    address = None
    for name, code in corpus:
        address, contract = disassembler.load_from_bytecode(code, False)
        contract.name = name
    cmd = SimpleNamespace(**{"engine": "tpu", "fleet": True,
                             "execution_timeout": 240, "create_timeout": 30,
                             "max_depth": 128, **options})
    return side.mythril.MythrilAnalyzer(disassembler, cmd_args=cmd,
                                        strategy="bfs", address=address)


def fleet_run(side) -> dict:
    """The corpus through the side's `--fleet` analyzer: detections and the
    driver's counters."""
    with driver_counters(side) as counters:
        report = analyzer_for(side, CORPUS).fire_lasers(
            modules=MODULES, transaction_count=1)
    assert not report.exceptions and not report.incomplete
    return {"digests": digests(report.issues.values(),
                               [name for name, _ in CORPUS]),
            "counters": counters}


def drained_run(side) -> dict:
    """A FleetDriver over the corpus with addflow's preempt event set
    before `run`: each member's detections, completion and dropped
    states."""
    fleet = FLEET[side.name]
    members = []
    for index, (name, creation) in enumerate(CORPUS):
        preempt = threading.Event()
        if name == "addflow":
            preempt.set()
        member = fleet.member(index, name, execution_timeout=240,
                              preempt=preempt)

        def work(member=member, creation=creation):
            sym = fleet.symbolic.SymExecWrapper(
                creation, address=None, strategy="bfs", max_depth=128,
                execution_timeout=240, create_timeout=30,
                transaction_count=1, compulsory_statespace=False,
                modules=MODULES, engine="tpu", fleet=member)
            return fleet.security.fire_lasers(sym, MODULES)

        member.work = work
        members.append(member)
    fleet.driver(members).run()
    out = {}
    for member in members:
        assert member.error is None, member.traceback_str
        laser = member.gate_laser or member.laser
        for issue in member.result:
            issue.contract = member.contract_id
        out[member.contract_id] = {
            "timed_out": bool(getattr(laser, "timed_out", False)),
            "dropped_states": getattr(laser, "dropped_states", 0),
            "issues": digests(member.result, [member.contract_id])}
    return out


def write_corpus(directory) -> list:
    """The corpus as one hex file a contract; the CLI names each member
    after its file."""
    paths = []
    for name, code in CORPUS:
        path = os.path.join(directory, f"{name}.hex")
        with open(path, "w") as handle:
            handle.write(code)
        paths.append(path)
    return paths


def cli_run(side, paths) -> tuple:
    """`analyze --engine tpu --fleet -f ... -o json` through the side's
    CLI entry point in this process: (exit code, report)."""
    argv = ["analyze", *[arg for path in paths for arg in ("-f", path)],
            "--engine", "tpu", "--fleet", "-t", "1", "-m",
            ",".join(MODULES), "--strategy", "bfs", "-o", "json"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = FLEET[side.name].cli.main(argv)
    return code, json.loads(out.getvalue())


@pytest.fixture(scope="module")
def jax_fleets(tmp_path_factory):
    """The JAX package's fleets, once: unsharded, sharded, the drained
    member and the CLI."""
    paths = write_corpus(str(tmp_path_factory.mktemp("corpus")))
    out = {"fleet": run_on(JAX, fleet_run)}
    with pytest.MonkeyPatch.context() as patch:
        for name, value in SHARDED_ENV.items():
            patch.setenv(name, value)
        out["sharded"] = run_on(JAX, fleet_run)
    out["drained"] = run_on(JAX, drained_run)
    out["cli"] = run_on(JAX, cli_run, paths)
    out["paths"] = paths
    return out


def test_fleet_parity(jax_fleets):
    got = run_on(PORT, fleet_run)
    want = jax_fleets["fleet"]
    assert got == want
    assert any(got["digests"].values())
    assert got["counters"]["phases"] == 1
    assert sorted(got["counters"]["occupancy"]) == sorted(
        name for name, _ in CORPUS)


def test_sharded_fleet(jax_fleets):
    pf.configure(lanes=N_LANES, device="cpu", **SHARDED)
    try:
        got = run_on(PORT, fleet_run)
    finally:
        pf.configure(lanes=N_LANES, device="cpu")
    assert got["digests"] == jax_fleets["fleet"]["digests"]
    assert got["counters"]["steal_passes"] > 0
    assert got == jax_fleets["sharded"]


def test_drained_member(jax_fleets):
    got = run_on(PORT, drained_run)
    assert got == jax_fleets["drained"]
    assert got["addflow"]["timed_out"]
    assert got["addflow"]["dropped_states"] > 0
    for name in ("branchy", "combo"):
        assert not got[name]["timed_out"], name
    assert any(row[0] == "106" for row in got["branchy"]["issues"]["branchy"])


def test_cli_fleet(jax_fleets):
    code, report = run_on(PORT, cli_run, jax_fleets["paths"])
    jax_code, jax_report = jax_fleets["cli"]
    assert code == jax_code == 1
    report_parity(report, jax_report, same_pool=False)
    assert {issue["contract"] for issue in report["issues"]} == {
        name for name, _ in CORPUS}


# ---- seams ------------------------------------------------------------------------------

def seam_no_card(tmp_path):
    """A fleet on the default device (the card) raises naming the CUDA
    device before any member's turn."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    called = []
    member = pfleet.FleetMember(0, "branchy",
                                work=lambda: called.append(True))
    pf.configure(lanes=N_LANES)
    try:
        with pytest.raises(pexceptions.DeviceUnavailable, match="CUDA"):
            pfleet.FleetDriver([member]).run()
    finally:
        pf.configure(lanes=N_LANES, device="cpu")
    assert not called and member.thread is None


def seam_one_by_one(tmp_path):
    """`--fleet` with one contract, or with `--engine host`, runs the
    contracts one by one: no fleet driver."""

    def refused(driver):
        raise AssertionError("a fleet driver ran")

    for corpus, engine in ((CORPUS[:1], "tpu"), (CORPUS, "host")):
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(pfleet.FleetDriver, "run", refused)
            report = run_on(PORT, lambda side: analyzer_for(
                side, corpus, engine=engine).fire_lasers(
                    modules=MODULES, transaction_count=1))
        assert not report.exceptions
        assert {issue.contract for issue in report.issues.values()} == {
            name for name, _ in corpus}


def seam_checkpoints(tmp_path):
    """`--checkpoint P --fleet` writes one host checkpoint a member,
    `P.<contract id>`, and no device checkpoint."""
    path = str(tmp_path / "fleet.ckpt")
    report = run_on(PORT, lambda side: analyzer_for(
        side, CORPUS, checkpoint=path).fire_lasers(
            modules=MODULES, transaction_count=1))
    assert not report.exceptions
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"fleet.ckpt.{name}" for name, _ in CORPUS)
    for name, _ in CORPUS:
        payload = pcheckpoint.load_host_checkpoint(
            f"{path}.{name}", expected_contract_id=name)
        assert payload is not None and payload["contract_id"] == name


def seam_foreign_resume(tmp_path):
    """A member's resume path that holds another contract's checkpoint
    starts fresh: the member's report is the uninterrupted one's."""
    path = str(tmp_path / "fleet.ckpt")
    fresh_run = run_on(PORT, lambda side: analyzer_for(
        side, CORPUS, checkpoint=path).fire_lasers(
            modules=MODULES, transaction_count=1))
    os.replace(f"{path}.addflow", f"{path}.branchy")
    assert pcheckpoint.load_host_checkpoint(
        f"{path}.branchy", expected_contract_id="branchy") is None
    resumed = run_on(PORT, lambda side: analyzer_for(
        side, CORPUS, resume=path).fire_lasers(
            modules=MODULES, transaction_count=1))
    names = [name for name, _ in CORPUS]
    assert digests(resumed.issues.values(), names) == digests(
        fresh_run.issues.values(), names)


def seam_contract_ids(tmp_path):
    """`_unique_contract_ids` on duplicate, empty and non-alphanumeric
    names is the JAX function."""
    names = ["token", "token", "", None, "a b/c", "ünï", "x.y-z", "token",
             "", "a_b_c"]
    contracts = [SimpleNamespace(name=name) for name in names]
    assert panalyzer._unique_contract_ids(contracts) == \
        janalyzer._unique_contract_ids(contracts)
    # the host checkpoints' contract namespace, as in test_fleet.py
    laser = SimpleNamespace(open_states=[], work_list=[], executed_nodes=7,
                            total_states=9, contract_id="alpha")
    path = str(tmp_path / "solo.ckpt")
    pcheckpoint.save_host_checkpoint(path, laser, tx_index=1)
    assert pcheckpoint.load_host_checkpoint(
        path, expected_contract_id="beta") is None
    assert jcheckpoint.REQUIRED_KEYS == pcheckpoint.REQUIRED_KEYS


SEAMS = [seam_no_card, seam_one_by_one, seam_checkpoints,
         seam_foreign_resume, seam_contract_ids]


@pytest.mark.parametrize("seam", SEAMS,
                         ids=[seam.__name__[5:] for seam in SEAMS])
def test_fleet_seams(seam, tmp_path, caplog):
    caplog.set_level(logging.INFO)
    seam(tmp_path)
