"""Word-level simplification pass — runs over the hash-consed term IR before any
lowering or bit-blasting (preprocess.lower_constraints and
incremental.IncrementalPipeline.check both invoke it).

Motivation (VERDICT r5 "what's missing" #1): the raw pipeline bit-blasts
keccak-equality and symbolic-index-array queries that z3's word-level rewriter
dispatches in milliseconds — a select over a few hundred concrete stores compared
against a constant explodes to ~3M clauses and minutes of CDCL. The rewrites here
are the word-level moves that kill those blowups:

  (a) constant propagation through asserted equalities: a conjunct ``t == c``
      (c concrete) substitutes c for t in every OTHER conjunct. The defining
      conjunct is kept, so models stay complete and witness extraction never
      needs to reconstruct eliminated variables.
  (b) ITE-ladder collapse: ``If(c0,a0,If(c1,a1,...)) == K`` folds branch-wise
      when leaf comparisons go constant (built inside-out, linear size).
  (c) keccak-UF equality via injectivity: ``keccak_N(x) == keccak_N(y) -> x == y``
      for symbolic x, y — sound under the keccak function manager's inverse-
      function model; cross-width equalities are False under its disjoint-
      interval model. Only UF names matching ``keccak256_<width>`` qualify
      (the manager is the sole producer of that namespace).
  (d) Extract/Concat fusion and zero/sign-extension elimination at comparison
      level (``Concat(a,b) == K`` splits per limb; ``ZeroExt(x) == K`` drops the
      extension or goes False on high bits).
  (e) bounded symbolic-index array lowering: ``select(stores..., i) == K`` over
      concrete-index/concrete-value chains enumerates the feasible index set
      (the reference's ``keys_set`` insight) instead of expanding the full
      read-over-write ladder — the flag_array witness query drops from ~3M
      clauses to a handful of index equalities.

All rewrites preserve satisfiability AND models (defining equalities are kept;
rewritten conjuncts are logical consequences in both directions), so the pass is
safe for both the native CDCL path and the batched device path, and cached
models/witness extraction keep working unchanged.

The port's copy of mythril_tpu/smt/solver/simplify.py.
"""

from __future__ import annotations

import re
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from .. import terms
from ...observe import trace
from .solver_statistics import SolverStatistics

#: UF namespace the keccak function manager owns; applications are injective by
#: model contract (inverse-function axiom) and per-width ranges are disjoint.
_KECCAK_NAME = re.compile(r"^keccak256_\d+$")

#: fixpoint bound — each iteration is a full substitution + rewrite sweep
MAX_ITERATIONS = 8

#: memo: identical constraint tuples simplify once (get_model computes the
#: cache key, check_formulas and the pipelines re-simplify the same tuple)
_MEMO_SIZE = 512
_memo: "OrderedDict[Tuple[terms.Term, ...], SimplifyOutcome]" = OrderedDict()


@dataclass
class SimplifyOutcome:
    #: simplified conjuncts; [terms.FALSE] when the set is unsatisfiable
    constraints: List[terms.Term]
    #: substitutions applied (original term -> constant) — defining equalities
    #: are kept in `constraints`, so this is informational for witness code
    substitutions: Dict[terms.Term, terms.Term] = field(default_factory=dict)
    iterations: int = 0
    rewrites: int = 0

    @property
    def is_false(self) -> bool:
        return bool(self.constraints) and self.constraints[0] is terms.FALSE


class _Counters:
    __slots__ = ("rewrites", "constants", "keccak", "ite", "selects", "fusions")

    def __init__(self):
        self.rewrites = 0
        self.constants = 0
        self.keccak = 0
        self.ite = 0
        self.selects = 0
        self.fusions = 0


def reset_simplify_memo() -> None:
    _memo.clear()


def simplify_constraints(constraints: Iterable[terms.Term]) -> SimplifyOutcome:
    """Simplify a conjunction to fixpoint. Returns the new conjunct list plus
    the substitution record; statistics accrue on the SolverStatistics
    singleton (terms rewritten, fixpoint iterations, wall time)."""
    key = tuple(constraints)
    hit = _memo.get(key)
    if hit is not None:
        _memo.move_to_end(key)
        return hit

    statistics = SolverStatistics()
    started = time.time()
    counters = _Counters()
    conjuncts = _flatten(list(key))
    substitutions: Dict[terms.Term, terms.Term] = {}
    iterations = 0
    with trace.span("simplify.pass", conjuncts=len(key)) as pass_span:
        if conjuncts and conjuncts[0] is terms.FALSE:
            outcome = SimplifyOutcome([terms.FALSE])
        else:
            while iterations < MAX_ITERATIONS:
                iterations += 1
                new_conjuncts = _iterate(conjuncts, substitutions, counters)
                changed = len(new_conjuncts) != len(conjuncts) or any(
                    a is not b for a, b in zip(new_conjuncts, conjuncts))
                conjuncts = new_conjuncts
                if conjuncts and conjuncts[0] is terms.FALSE:
                    break
                if not changed:
                    break
            outcome = SimplifyOutcome(conjuncts, substitutions, iterations,
                                      counters.rewrites)
        pass_span.set(iterations=iterations, rewrites=counters.rewrites)

    statistics.simplify_time += time.time() - started
    statistics.simplify_iterations += iterations
    statistics.simplify_rewrites += counters.rewrites
    statistics.simplify_constants_propagated += counters.constants
    statistics.simplify_keccak_rewrites += counters.keccak
    statistics.simplify_ite_collapses += counters.ite
    statistics.simplify_selects_bounded += counters.selects
    statistics.simplify_extract_fusions += counters.fusions

    _memo[key] = outcome
    if len(_memo) > _MEMO_SIZE:
        _memo.popitem(last=False)
    return outcome


# ---------------------------------------------------------------------------------
# one fixpoint iteration: collect equalities -> substitute -> local rewrites
# ---------------------------------------------------------------------------------

def _flatten(conjuncts: List[terms.Term]) -> List[terms.Term]:
    """Flatten top-level conjunctions, drop True, dedupe (order-preserving);
    short-circuit to [False] on a constant-false conjunct."""
    out: List[terms.Term] = []
    seen = set()
    stack = list(reversed(conjuncts))
    while stack:
        node = stack.pop()
        if node is terms.TRUE:
            continue
        if node is terms.FALSE:
            return [terms.FALSE]
        if node.op == "and":
            stack.extend(reversed(node.args))
            continue
        if id(node) not in seen:
            seen.add(id(node))
            out.append(node)
    return out


def _is_const(node: terms.Term) -> bool:
    return node.op == "const"


def _node_count(term: terms.Term) -> int:
    return sum(1 for _ in terms.walk(term))


def _iterate(conjuncts: List[terms.Term],
             substitutions: Dict[terms.Term, terms.Term],
             counters: _Counters) -> List[terms.Term]:
    # -- (a) constant propagation: collect t == c definitions ----------------------
    mapping: Dict[terms.Term, terms.Term] = {}
    defining: Dict[terms.Term, int] = {}
    for index, conjunct in enumerate(conjuncts):
        key = value = None
        if conjunct.op == "eq":
            left, right = conjunct.args
            if _is_const(right) and not _is_const(left):
                key, value = left, right
            elif _is_const(left) and not _is_const(right):
                key, value = right, left
        elif conjunct.op == "var" and conjunct.sort == terms.BOOL:
            key, value = conjunct, terms.TRUE
        elif conjunct.op == "not" and conjunct.args[0].op == "var":
            key, value = conjunct.args[0], terms.FALSE
        if key is not None and key not in mapping:
            mapping[key] = value
            defining[key] = index

    context = _Context(conjuncts)
    cache: Dict[terms.Term, terms.Term] = {}

    def local(root: terms.Term) -> terms.Term:
        # bottom-up structural rewrite ((b)-(e)); cached across conjuncts so
        # shared subgraphs rewrite once and identically
        for node in terms.walk(root):
            if node in cache:
                continue
            if node.args:
                new_args = tuple(cache[a] for a in node.args)
                if any(na is not oa for na, oa in zip(new_args, node.args)):
                    base = terms._rebuild_node(node, new_args)
                else:
                    base = node
            else:
                base = node
            cache[node] = _apply_rules(base, context, counters)
        return cache[root]

    rewritten: List[terms.Term] = []
    for index, conjunct in enumerate(conjuncts):
        base = local(conjunct)
        # constant propagation is committed per conjunct only when the
        # substituted form STRICTLY SHRINKS (a constant fold, a collapsed
        # branch, a conjunct folding to True/False). A plain var -> const
        # rename has identical node count and is deliberately dropped: the
        # incremental pipeline blasts each distinct term once into its
        # persistent pool, and rewriting every old conjunct whenever a new
        # equality joins the path condition would re-blast the whole prefix
        # per query (measured: +45% wall time on killbilly -t 3, where
        # unconditional substitution defeated all pool sharing).
        own = [key for key, at in defining.items() if at == index]
        applicable = {key: val for key, val in mapping.items()
                      if key not in own} if own else mapping
        if applicable:
            candidate = terms.substitute(base, applicable)
            if candidate is not base:
                candidate = local(candidate)
                if candidate.is_const \
                        or _node_count(candidate) < _node_count(base):
                    counters.constants += 1
                    counters.rewrites += 1
                    base = candidate
        rewritten.append(base)
    substitutions.update(mapping)
    return _flatten(rewritten)


class _Context:
    """Per-iteration pattern witnesses scanned from the conjunct set: which
    keccak applications carry their %64 interval axiom (needed for the
    const-compare rule — the axiom holds only for symbolic inputs)."""

    __slots__ = ("mod64_apps",)

    def __init__(self, conjuncts: List[terms.Term]):
        self.mod64_apps = set()
        for conjunct in conjuncts:
            parts = conjunct.args if conjunct.op == "and" else (conjunct,)
            for part in parts:
                if part.op != "eq":
                    continue
                for side, other in (part.args, reversed(part.args)):
                    if (side.op == "bvurem" and _is_const(side.args[1])
                            and side.args[1].value == 64
                            and _is_const(other) and other.value == 0
                            and side.args[0].op == "apply"):
                        self.mod64_apps.add(side.args[0])


def _apply_rules(node: terms.Term, context: _Context,
                 counters: _Counters) -> terms.Term:
    if node.op == "eq":
        return _eq_rules(node, context, counters)
    if node.op in ("bvult", "bvule"):
        return _unsigned_cmp_rules(node, counters)
    return node


# ---------------------------------------------------------------------------------
# equality rules
# ---------------------------------------------------------------------------------

def _eq_rules(node: terms.Term, context: _Context,
              counters: _Counters) -> terms.Term:
    left, right = node.args

    # (c) keccak injectivity / disjoint intervals
    rewritten = keccak_eq(left, right)
    if rewritten is not None:
        counters.keccak += 1
        counters.rewrites += 1
        return rewritten
    for app, const in ((left, right), (right, left)):
        if (app.op == "apply" and _KECCAK_NAME.match(app.params[0])
                and _is_const(const) and app in context.mod64_apps
                and const.value % 64 != 0):
            # the manager pins symbolic hashes to multiples of 64; this
            # constant can never be one (axiom witnessed in this very set)
            counters.keccak += 1
            counters.rewrites += 1
            return terms.FALSE

    # (e) bounded symbolic-index select
    for selected, const in ((left, right), (right, left)):
        if selected.op == "select" and _is_const(const):
            rewritten = _bounded_select_eq(selected, const, counters)
            if rewritten is not None:
                counters.selects += 1
                counters.rewrites += 1
                return rewritten

    # (b) ITE-ladder collapse
    for ladder, const in ((left, right), (right, left)):
        if ladder.op == "ite" and _is_const(const):
            rewritten = _ite_ladder_eq(ladder, const)
            if rewritten is not None:
                counters.ite += 1
                counters.rewrites += 1
                return rewritten

    # (d) concat / extension elimination
    rewritten = _structural_eq(left, right, counters)
    if rewritten is not None:
        return rewritten
    return node


def keccak_eq(left: terms.Term, right: terms.Term) -> Optional[terms.Term]:
    """Word-level equality rewrite for two keccak applications, or None.

    Exposed for the lowering layer: preprocess builds index-equality
    conditions (select-over-store) and Ackermann facts with it, so
    ``storage[keccak(a)] / storage[keccak(b)]`` aliasing checks compare the
    *preimages* instead of two 256-bit UF placeholders. Only fires when both
    arguments are symbolic — a concrete input's hash is pinned to its real
    digest by the manager's congruence conditions, and the inverse axiom that
    justifies injectivity only covers symbolic inputs."""
    if left.op != "apply" or right.op != "apply" or left is right:
        return None
    name_l, name_r = left.params[0], right.params[0]
    if not _KECCAK_NAME.match(name_l) or not _KECCAK_NAME.match(name_r):
        return None
    if any(_is_const(arg) for arg in left.args + right.args):
        return None
    if name_l != name_r:
        # different input widths hash into disjoint output intervals
        return terms.FALSE
    return terms.bool_and(*[terms.bv_cmp("eq", a, b)
                            for a, b in zip(left.args, right.args)])


def smart_eq(left: terms.Term, right: terms.Term) -> terms.Term:
    """Equality constructor for the lowering layer: applies the keccak
    injectivity/disjointness rewrite when both sides are keccak applications
    (select-over-store index comparisons and Ackermann facts routinely compare
    two hashes), else a plain hash-consed equality."""
    rewritten = keccak_eq(left, right)
    if rewritten is not None:
        statistics = SolverStatistics()
        statistics.simplify_keccak_rewrites += 1
        statistics.simplify_rewrites += 1
        return rewritten
    return terms.bv_cmp("eq", left, right)


def _bool_ite(cond: terms.Term, then: terms.Term,
              otherwise: terms.Term) -> terms.Term:
    """Boolean If(c, t, e) that folds constant branches into and/or form."""
    if then is terms.TRUE:
        return terms.bool_or(cond, otherwise)
    if then is terms.FALSE:
        return terms.bool_and(terms.bool_not(cond), otherwise)
    if otherwise is terms.TRUE:
        return terms.bool_or(terms.bool_not(cond), then)
    if otherwise is terms.FALSE:
        return terms.bool_and(cond, then)
    return terms.ite(cond, then, otherwise)


def _ite_ladder_eq(ladder: terms.Term,
                   const: terms.Term) -> Optional[terms.Term]:
    """(b): ``If(c0,a0,If(c1,a1,...)) == K`` — push the comparison into the
    ladder when at least one leaf comparison folds constant.

    Handles full ite TREES, not just right-leaning else-chains: the
    device merge pass (parallel/symstep.py) blends reconverged lanes
    bottom-up, so a twice-merged plane slot is
    ``ite(c1, ite(c2a, v, w), ite(c2b, x, y))`` with ites in BOTH
    branches. The walk is iterative post-order with memoization on the
    hash-consed nodes — shared subtrees (cousin merges reuse leaf
    values) are rewritten once, and branches whose pushed comparisons
    come out identical collapse to that single result, so the output
    stays linear in the number of DISTINCT nodes."""
    memo: dict = {}
    folded = False
    pending = [ladder]
    while pending:
        node = pending[-1]
        if id(node) in memo:
            pending.pop()
            continue
        if node.op == "ite":
            children = [child for child in node.args[1:]
                        if id(child) not in memo]
            if children:
                pending.extend(children)
                continue
            pending.pop()
            then_eq = memo[id(node.args[1])]
            else_eq = memo[id(node.args[2])]
            memo[id(node)] = then_eq if then_eq is else_eq \
                else _bool_ite(node.args[0], then_eq, else_eq)
        else:
            pending.pop()
            leaf_eq = terms.bv_cmp("eq", node, const)
            if _is_const(leaf_eq) or leaf_eq in (terms.TRUE, terms.FALSE):
                folded = True
            memo[id(node)] = leaf_eq
    if not folded:
        return None  # nothing folds: the rewrite would not shrink anything
    return memo[id(ladder)]


def _bounded_select_eq(selected: terms.Term, const: terms.Term,
                       counters: _Counters) -> Optional[terms.Term]:
    """(e): ``select(store(...store(base, c_j, v_j)...), i) == K`` with
    concrete store indices and values — enumerate the feasible index set
    instead of expanding the ladder. ``value(i) == K`` iff i hits a store
    whose value is K, or i misses every store and the base row equals K."""
    array, index = selected.args
    chain: List[Tuple[terms.Term, terms.Term]] = []
    node = array
    while node.op == "store":
        store_index, store_value = node.args[1], node.args[2]
        if not _is_const(store_index) or not _is_const(store_value):
            return None
        chain.append((store_index, store_value))
        node = node.args[0]
    if len(chain) < 2:
        return None  # the plain lowering is already cheap
    if node.op == "const_array":
        if not _is_const(node.args[0]):
            return None
        base_hit = node.args[0].value == const.value
        residual = None
    elif node.op == "var":
        base_hit = None
        residual = terms.bv_cmp("eq", terms.select(node, index), const)
    else:
        return None

    # first store (outermost) wins on duplicate indices
    effective: "OrderedDict[int, int]" = OrderedDict()
    index_terms: Dict[int, terms.Term] = {}
    for store_index, store_value in chain:
        if store_index.value not in effective:
            effective[store_index.value] = store_value.value
            index_terms[store_index.value] = store_index
    matches = [terms.bv_cmp("eq", index, index_terms[i])
               for i, v in effective.items() if v == const.value]
    misses = [terms.bool_not(terms.bv_cmp("eq", index, index_terms[i]))
              for i, v in effective.items() if v != const.value]

    # estimated clauses the full read-over-write ladder would have cost:
    # one index-width equality + one value-width mux per chain entry vs the
    # kept index equalities (~4 ternary clauses per circuit bit)
    index_width = index.width
    value_width = const.width
    full = len(chain) * (index_width + value_width) * 4
    kept = (len(matches) + (len(misses) if base_hit or residual is not None
                            else 0)) * index_width * 4
    statistics = SolverStatistics()
    statistics.simplify_clauses_avoided += max(0, full - kept)

    disjuncts = list(matches)
    if residual is not None:
        disjuncts.append(terms.bool_and(*(misses + [residual])))
    elif base_hit:
        disjuncts.append(terms.bool_and(*misses))
    return terms.bool_or(*disjuncts)


def _structural_eq(left: terms.Term, right: terms.Term,
                   counters: _Counters) -> Optional[terms.Term]:
    """(d): comparison-level Extract/Concat fusion and extension elimination."""
    # Concat(a, b, ...) == K  ->  per-limb equalities against K's slices
    for cat, const in ((left, right), (right, left)):
        if cat.op == "concat" and _is_const(const):
            parts = []
            offset = cat.width
            for limb in cat.args:
                offset -= limb.width
                slice_value = (const.value >> offset) & terms._mask(limb.width)
                parts.append(terms.bv_cmp(
                    "eq", limb, terms.bv_const(slice_value, limb.width)))
            counters.fusions += 1
            counters.rewrites += 1
            return terms.bool_and(*parts)
    # Concat == Concat with identical limb shapes -> pairwise
    if (left.op == "concat" and right.op == "concat"
            and len(left.args) == len(right.args)
            and all(a.width == b.width
                    for a, b in zip(left.args, right.args))):
        counters.fusions += 1
        counters.rewrites += 1
        return terms.bool_and(*[terms.bv_cmp("eq", a, b)
                                for a, b in zip(left.args, right.args)])
    # ZeroExt/SignExt elimination
    for ext, const in ((left, right), (right, left)):
        if ext.op in ("zext", "sext") and _is_const(const):
            inner = ext.args[0]
            low = const.value & terms._mask(inner.width)
            widened = low if ext.op == "zext" \
                else terms._signed(low, inner.width) & terms._mask(ext.width)
            counters.fusions += 1
            counters.rewrites += 1
            if widened != const.value:
                return terms.FALSE
            return terms.bv_cmp("eq", inner,
                                terms.bv_const(low, inner.width))
    if (left.op == right.op and left.op in ("zext", "sext")
            and left.args[0].width == right.args[0].width):
        counters.fusions += 1
        counters.rewrites += 1
        return terms.bv_cmp("eq", left.args[0], right.args[0])
    return None


def _unsigned_cmp_rules(node: terms.Term,
                        counters: _Counters) -> terms.Term:
    """ULT/ULE over matching zero-extensions compare the originals; against a
    constant, the extension drops (or the comparison folds) since a
    zero-extended value never exceeds the inner range."""
    op = node.op
    left, right = node.args
    if (left.op == "zext" and right.op == "zext"
            and left.args[0].width == right.args[0].width):
        counters.fusions += 1
        counters.rewrites += 1
        return terms.bv_cmp(op, left.args[0], right.args[0])
    inner_side = None
    if left.op == "zext" and _is_const(right):
        inner = left.args[0]
        bound = right.value
        limit = 1 << inner.width
        if op == "bvult":
            result = terms.TRUE if bound >= limit else terms.bv_cmp(
                "bvult", inner, terms.bv_const(bound, inner.width))
        else:
            result = terms.TRUE if bound >= limit - 1 else terms.bv_cmp(
                "bvule", inner, terms.bv_const(bound, inner.width))
        inner_side = result
    elif right.op == "zext" and _is_const(left):
        inner = right.args[0]
        bound = left.value
        limit = 1 << inner.width
        if op == "bvult":
            result = terms.FALSE if bound >= limit else terms.bv_cmp(
                "bvult", terms.bv_const(bound, inner.width), inner)
        else:
            result = terms.FALSE if bound > limit - 1 else terms.bv_cmp(
                "bvule", terms.bv_const(bound, inner.width), inner)
        inner_side = result
    if inner_side is not None:
        counters.fusions += 1
        counters.rewrites += 1
        return inner_side
    return node
