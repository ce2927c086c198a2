"""The port's LaserEVM against the JAX package's on branchy(6)
(chip_smoke.py's stress body: six sequential branches on calldata words,
64 paths a transaction) in a dispatcher, as tests/test_torch_svm.py holds
it on KILLBILLY: in creation and runtime mode under DFS and BFS with one
transaction, and in creation mode under BFS with two.

With two transactions branchy(6) opens 4,225 states and takes about 25 s
a side (most of it the reachability check of the first transaction's 65
open states), so that run is made once. Open states are examined one by
one up to `DETAIL` (each costs a CDCL query of a tenth of a second or
more); the rest are counted."""

import pytest

from _torch_engine import check_statespace

DETAIL = 8


@pytest.mark.parametrize("strategy", ["dfs", "bfs"])
@pytest.mark.parametrize("mode", ["creation", "runtime"])
def test_branchy_statespace(mode, strategy):
    check_statespace("branchy6", mode, 1, strategy, DETAIL)


def test_branchy_statespace_two_transactions():
    space = check_statespace("branchy6", "creation", 2, "bfs", DETAIL)
    assert space["after_tx"] == [65, 4225]
