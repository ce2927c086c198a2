"""chip_smoke.py's analyze_fleet constants, recomputed: EXPECTED_ANALYZE_FLEET
is what the JAX package gives on FLEET_CORPUS at 128 lanes
(`MYTHRIL_TPU_LANES=128`): its CLI with `--engine tpu --fleet`, in this
process (exit code, each contract's issues and the fleet driver's
counters), the same under FLEET_SHARDED_ENV, and a FleetDriver with
FLEET_PREEMPTED preempted. The phase's own checks then pass the port's
runs on the plain twins at the same settings
(`frontier.configure(device="cpu")`)."""

import contextlib
import io
import json

import pytest
import torch

import chip_smoke
from _torch_engine import JAX, PORT, run_on
from test_torch_fleet import driver_counters
from mythril_tpu.analysis import security as jsecurity
from mythril_tpu.analysis import symbolic as jsymbolic
from mythril_tpu.interfaces import cli as jcli
from mythril_tpu.parallel import frontier as jf
from mythril_tpu_torch.analysis import security as psecurity
from mythril_tpu_torch.analysis import symbolic as psymbolic
from mythril_tpu_torch.parallel import fleet as pfleet
from mythril_tpu_torch.parallel import frontier as pf


def jax_fleet(side, paths: dict, sharded: bool) -> dict:
    """The JAX CLI's `--fleet` run over `paths` in this process: exit,
    issues by contract and the driver's counters."""
    with driver_counters(side) as counters:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            exit_code = jcli.main(chip_smoke.fleet_argv(paths.values()))
    return {"exit": exit_code,
            "issues": chip_smoke.fleet_issues(json.loads(out.getvalue()),
                                              paths),
            "counters": chip_smoke.fleet_counters(counters, sharded)}


def jax_constants(directory: str) -> dict:
    """EXPECTED_ANALYZE_FLEET from the JAX package."""
    paths = chip_smoke.fleet_files(directory)
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("MYTHRIL_TPU_LANES", str(chip_smoke.LANES))
        fleet = run_on(JAX, jax_fleet, paths, False)
        with pytest.MonkeyPatch.context() as shard_patch:
            for name, value in chip_smoke.FLEET_SHARDED_ENV.items():
                shard_patch.setenv(name, value)
            sharded = run_on(JAX, jax_fleet, paths, True)
        preempted = run_on(JAX, lambda side: chip_smoke.preempted_fleet(
            jf, jsymbolic, jsecurity))
    assert (sharded["exit"], sharded["issues"]) == (fleet["exit"],
                                                     fleet["issues"])
    return {"exit": fleet["exit"], "issues": fleet["issues"],
            "fleet": fleet["counters"], "sharded": sharded["counters"],
            "preempted": preempted}


def test_chip_smoke_constants_are_the_jax_fleets(tmp_path):
    assert jax_constants(str(tmp_path)) == chip_smoke.EXPECTED_ANALYZE_FLEET


def test_chip_smoke_fleet_checks_pass_the_port(tmp_path):
    """The phase's own runs and checks (which raise on a difference) on the
    twins: the fleet, the sharded fleet (steal rows moved) and the
    preempted member."""
    paths = chip_smoke.fleet_files(str(tmp_path))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for what, settings in (("fleet", {}),
                               ("sharded", chip_smoke.FLEET_SHARDED)):
            pf.configure(device="cpu", **settings)
            record = chip_smoke.fleet_run(paths, what)
            assert record["exit"] == 1 and record["phases"] >= 1
        assert record["steal_passes"] and record["steal_rows"]
        pf.configure(device="cpu")
        preempted = run_on(PORT, lambda side: chip_smoke.preempted_fleet(
            pfleet, psymbolic, psecurity))
        chip_smoke.check_analyze_fleet("preempted", preempted)
        assert preempted[chip_smoke.FLEET_PREEMPTED]["incomplete"]
    finally:
        pf.reset()
        torch.set_num_threads(threads)
