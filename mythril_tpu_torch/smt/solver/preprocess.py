"""Theory preprocessing: lower arrays and uninterpreted functions to pure QF_BV.

The port's copy of mythril_tpu/smt/solver/preprocess.py, unchanged.

Pipeline position: constraints (Bool terms) -> [this] -> bit-blaster -> CDCL/JAX.

Techniques (SURVEY.md §7 "hard parts" 1-2):
  - select-over-store chains expand to ite chains (read-over-write; the reference's
    own journaling structures show chains stay short in practice).
  - Reads on base symbolic arrays and UF applications are replaced by fresh
    variables with Ackermann consistency constraints (pairwise: equal indices/args
    imply equal values). Index sets are small in EVM paths, so the O(n^2) pairs
    stay cheap.

The returned `LoweringInfo` records enough to rebuild array/UF tables from a SAT
model (model reconstruction in solver.py).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .. import terms
from .simplify import simplify_constraints, smart_eq


_fresh_counter = itertools.count()


def _fresh_bv(prefix: str, width: int) -> terms.Term:
    return terms.bv_var(f"!{prefix}_{next(_fresh_counter)}", width)


@dataclass
class LoweringInfo:
    #: (base_array_var, index_term_lowered, fresh_read_var)
    array_reads: List[Tuple[terms.Term, terms.Term, terms.Term]] = field(default_factory=list)
    #: (uf_name, lowered_arg_terms, fresh_result_var)
    uf_applications: List[Tuple[str, Tuple[terms.Term, ...], terms.Term]] = field(default_factory=list)
    #: extra constraints generated by lowering (Ackermann etc.)
    side_constraints: List[terms.Term] = field(default_factory=list)
    #: O(1) registries (terms are hash-consed, so identity keys are stable);
    #: the incremental pipeline keeps one LoweringInfo alive for a whole run
    read_map: Dict[Tuple[int, terms.Term], terms.Term] = field(default_factory=dict)
    uf_map: Dict[Tuple[str, Tuple[terms.Term, ...]], terms.Term] = field(default_factory=dict)


def lower_constraints(constraints: List[terms.Term], simplify: bool = True
                      ) -> Tuple[List[terms.Term], LoweringInfo]:
    """Lower every constraint to pure QF_BV + side constraints.

    The word-level simplification pass (simplify.py) runs first: constant
    propagation, keccak-equality rewriting, ITE collapse and bounded select
    enumeration all shrink the term graph before any ite chains or Ackermann
    pairs are generated, which is where the clause-count orders of magnitude
    live. Pass simplify=False to lower the raw form (used by equivalence
    tests and --no-simplify)."""
    if simplify:
        constraints = simplify_constraints(constraints).constraints
    info = LoweringInfo()
    cache: Dict[terms.Term, terms.Term] = {}
    lowered = [_lower(c, cache, info) for c in constraints]
    _add_ackermann(info)
    return lowered + info.side_constraints, info


def _lower(node: terms.Term, cache: Dict[terms.Term, terms.Term],
           info: LoweringInfo) -> terms.Term:
    hit = cache.get(node)
    if hit is not None:
        return hit
    # iterative post-order to survive deep store chains
    stack = [node]
    while stack:
        current = stack[-1]
        if current in cache:
            stack.pop()
            continue
        pending = [a for a in current.args if a not in cache]
        if pending:
            stack.extend(pending)
            continue
        stack.pop()
        cache[current] = _lower_node(current, cache, info)
    return cache[node]


def _lower_node(node: terms.Term, cache, info: LoweringInfo) -> terms.Term:
    op = node.op
    new_args = tuple(cache[a] for a in node.args)
    if op == "select":
        return _lower_select(new_args[0], new_args[1], info)
    if op == "apply":
        name = node.params[0]
        key = (name, new_args)
        hit = info.uf_map.get(key)
        if hit is not None:
            return hit
        fresh = _fresh_bv(f"uf_{name}", node.width)
        info.uf_applications.append((name, new_args, fresh))
        info.uf_map[key] = fresh
        return fresh
    if op in ("store", "const_array") or isinstance(node.sort, terms.ArraySort):
        # arrays survive only as select bases; rebuild with lowered children
        if all(na is oa for na, oa in zip(new_args, node.args)):
            return node
        return terms.Term(op, new_args, node.params, node.sort)
    if all(na is oa for na, oa in zip(new_args, node.args)):
        return node
    return terms._rebuild_node(node, new_args)


def _lower_select(array: terms.Term, index: terms.Term, info: LoweringInfo) -> terms.Term:
    """select over a (lowered) array term -> pure BV via ite chain + base read var."""
    # walk the store chain, building ite(index == store_idx, store_val, ...) inside-out
    chain: List[Tuple[terms.Term, terms.Term]] = []
    node = array
    while node.op == "store":
        chain.append((node.args[1], node.args[2]))
        node = node.args[0]
    if node.op == "const_array":
        result = node.args[0]
    elif node.op == "ite":
        # merged arrays (state merge: If(c, s1, s2)) — push the select inside
        result = terms.ite(node.args[0],
                           _lower_select(node.args[1], index, info),
                           _lower_select(node.args[2], index, info))
    else:  # base symbolic array variable
        result = _base_read(node, index, info)
    for store_index, store_value in reversed(chain):
        condition = smart_eq(index, store_index)
        result = terms.ite(condition, store_value, result)
    return result


def _base_read(base: terms.Term, index: terms.Term, info: LoweringInfo) -> terms.Term:
    key = (id(base), index)
    hit = info.read_map.get(key)
    if hit is not None:
        return hit
    fresh = _fresh_bv(f"rd_{base.params[0]}", base.sort.value_width)
    info.array_reads.append((base, index, fresh))
    info.read_map[key] = fresh
    return fresh


def read_pair_fact(index_a: terms.Term, fresh_a: terms.Term,
                   index_b: terms.Term, fresh_b: terms.Term
                   ) -> Optional[terms.Term]:
    """Ackermann consistency fact for two reads of the same base array, or
    None when provably unneeded (two distinct const indices — equal const
    indices always map to the same fresh var). Shared by the one-shot and
    incremental pipelines so their facts can never drift apart."""
    if index_a.is_const and index_b.is_const:
        return None
    antecedent = smart_eq(index_a, index_b)
    if antecedent is terms.FALSE:
        return None  # e.g. keccak hashes of different input widths
    return terms.bool_implies(antecedent, terms.bv_cmp("eq", fresh_a, fresh_b))


def uf_pair_fact(args_a: Tuple[terms.Term, ...], fresh_a: terms.Term,
                 args_b: Tuple[terms.Term, ...], fresh_b: terms.Term
                 ) -> Optional[terms.Term]:
    """Ackermann consistency fact for two applications of the same UF."""
    if all(x.is_const and y.is_const for x, y in zip(args_a, args_b)):
        if tuple(x.value for x in args_a) != tuple(y.value for y in args_b):
            return None
    equalities = [smart_eq(x, y) for x, y in zip(args_a, args_b)]
    antecedent = terms.bool_and(*equalities)
    if antecedent is terms.FALSE:
        return None
    return terms.bool_implies(antecedent,
                              terms.bv_cmp("eq", fresh_a, fresh_b))


def _add_ackermann(info: LoweringInfo) -> None:
    # array reads: same base, possibly-equal indices -> equal values
    by_base: Dict[int, List[Tuple[terms.Term, terms.Term]]] = {}
    for base, index, fresh in info.array_reads:
        by_base.setdefault(id(base), []).append((index, fresh))
    for reads in by_base.values():
        for (index_a, fresh_a), (index_b, fresh_b) in itertools.combinations(reads, 2):
            fact = read_pair_fact(index_a, fresh_a, index_b, fresh_b)
            if fact is not None:
                info.side_constraints.append(fact)
    # UF applications: same name, equal args -> equal results
    by_name: Dict[str, List[Tuple[Tuple[terms.Term, ...], terms.Term]]] = {}
    for name, args, fresh in info.uf_applications:
        by_name.setdefault(name, []).append((args, fresh))
    for applications in by_name.values():
        for (args_a, fresh_a), (args_b, fresh_b) in itertools.combinations(applications, 2):
            fact = uf_pair_fact(args_a, fresh_a, args_b, fresh_b)
            if fact is not None:
                info.side_constraints.append(fact)
