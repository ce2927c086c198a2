"""chip_smoke.py's SPIN run of analyze_tpu, recomputed as
tests/test_torch_tpu_cli.py recomputes the others: its counting loop
outlasts the device's step budget at 128 lanes, so the hand-over
materializes the live lane into the host's worklist and defers the
escape rows. The JAX package's CLI and the port's (on the plain twins)
give EXPECTED_ANALYZE_TPU["spin"]. A file of its own: its 4096 steps take
minutes on each side."""

import chip_smoke
from test_torch_tpu_cli import check_runs


def test_spin_hands_over_as_the_jax_cli(tmp_path):
    materialized = [counts[2] for counts in
                    chip_smoke.EXPECTED_ANALYZE_TPU["spin"]["frontier"]]
    assert materialized and all(materialized)
    check_runs(["spin"], tmp_path)
