"""Independence solver: partition constraints into variable-connected buckets and
solve each independently (API parity: mythril/laser/smt/solver/independence_solver.py:86
— DependenceMap/DependenceBucket). The buckets are also the natural batch axis for the
JAX solver: independent sub-queries discharge as parallel lanes.

The port's copy of mythril_tpu/smt/solver/independence_solver.py, unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .. import terms
from ..model import Model
from .solver import BaseSolver, check_formulas
from .solver_statistics import stat_smt_query


def _signature_of(raw: terms.Term) -> frozenset:
    """The dependency signature: variable names + UF names referenced."""
    names = set()
    for node in terms.walk(raw):
        if node.op == "var":
            names.add(node.params[0])
        elif node.op == "apply":
            names.add(("uf", node.params[0]))
    return frozenset(names)


class _UnionFind:
    def __init__(self):
        self.parent: Dict[object, object] = {}

    def find(self, item):
        root = item
        while self.parent.setdefault(root, root) != root:
            root = self.parent[root]
        while self.parent[item] != root:  # path compression
            self.parent[item], item = root, self.parent[item]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


def partition(raw_constraints: List[terms.Term]) -> List[List[terms.Term]]:
    """Group constraints whose variable sets are transitively connected."""
    uf = _UnionFind()
    signatures = []
    for index, constraint in enumerate(raw_constraints):
        signature = _signature_of(constraint)
        signatures.append(signature)
        anchor = ("c", index)
        uf.find(anchor)
        for name in signature:
            uf.union(anchor, ("v", name))
    buckets: Dict[object, List[terms.Term]] = {}
    for index, constraint in enumerate(raw_constraints):
        buckets.setdefault(uf.find(("c", index)), []).append(constraint)
    return list(buckets.values())


class IndependenceSolver(BaseSolver):
    @stat_smt_query
    def check(self, *extra) -> str:
        raw = [c.raw for c in list(self.constraints) + list(extra)]
        merged = Model()
        for bucket in partition(raw):
            status, model = check_formulas(bucket, self._budget())
            if status != "sat":
                self._model = None
                return status
            merged = merged.merge(model)
        self._model = merged
        return "sat"
