"""chip_smoke.py's analyze_tpu constants, recomputed: EXPECTED_ANALYZE_TPU
is what the JAX package's CLI (`python -m mythril_tpu analyze ... --engine
tpu`, a subprocess with `MYTHRIL_TPU_LANES=128` and a HOME of the test's
own) gives on ANALYZE_TPU_RUNS, and the phase's own run of the port's CLI
(`chip_smoke.analyze_tpu_run`, in this process) gives it too, on the
plain twins at the same 128 lanes (`frontier.configure(device="cpu")`).
The SPIN run, whose device phase takes its whole step budget, is
tests/test_torch_tpu_handover.py's."""

import json
import os
import subprocess
import sys

import torch

import chip_smoke
from mythril_tpu_torch.parallel import frontier

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def check_runs(names, tmp_path) -> None:
    """The JAX CLI's summaries of `names` are EXPECTED_ANALYZE_TPU's, and so
    are the port's on the twins."""
    env = dict(os.environ, HOME=str(tmp_path), MYTHRIL_TPU_LANES="128",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for name in names:
        proc = subprocess.run(
            [sys.executable, "-m", "mythril_tpu", "-v", "4",
             *chip_smoke.analyze_tpu_argv(name)],
            capture_output=True, text=True, cwd=str(tmp_path), env=env,
            timeout=600)
        assert proc.returncode in (0, 1), proc.stderr[-2000:]
        assert chip_smoke.tpu_summary(
            json.loads(proc.stdout), proc.returncode, proc.stderr) == \
            chip_smoke.EXPECTED_ANALYZE_TPU[name], name
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    frontier.configure(device="cpu")
    try:
        for name in names:
            report, summary, record = chip_smoke.analyze_tpu_run(name)
            chip_smoke.check_analyze_tpu(name, summary)
            assert not record["incomplete"]
            assert len(record["frontier"]) == len(summary["frontier"])
    finally:
        frontier.reset()
        torch.set_num_threads(threads)


def test_chip_smoke_constants_are_the_jax_tpu_reports(tmp_path):
    check_runs([name for name in chip_smoke.ANALYZE_TPU_RUNS
                if name != "spin"], tmp_path)
