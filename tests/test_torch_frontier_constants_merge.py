"""chip_smoke.py's drain constants recomputed with the JAX `_Frontier`
(tests/_torch_drain.py `check_drain_constants`): the default configuration
on branchy(12) and on mem_branchy(8), and the sharded frontier on
branchy(12).

The seven cases of `test_chip_smoke_constants_are_the_jax_drain` are split
over this file and tests/test_torch_frontier_constants.py, so that `--dist
loadfile` gives each half a worker of its own."""

import pytest

# unspent_time_budget: autouse, the JAX driver's time budget disarmed
from _torch_drain import check_drain_constants, unspent_time_budget  # noqa: F401


@pytest.mark.parametrize("which", ["default", "merge", "shard"])
def test_chip_smoke_constants_are_the_jax_drain(which, monkeypatch):
    """chip_smoke.py holds the port's drain loop on the card to constants:
    the JAX `_Frontier`'s drain of case `which` (`check_drain_constants`
    says what each case runs)."""
    check_drain_constants(which, monkeypatch)
