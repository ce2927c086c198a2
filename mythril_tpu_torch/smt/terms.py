"""Hash-consed term IR — the expression representation under the typed SMT facade.

The port's copy of mythril_tpu/smt/terms.py, unchanged.

Design (SURVEY.md §7): where the reference wraps live z3 ASTs
(mythril/laser/smt/expression.py:10), this build owns its expression graph: immutable,
hash-consed `Term` nodes with constant folding and local rewrites applied at
construction. Owning the IR is what lets the same expression graph be (a) bit-blasted
to CNF for the CDCL/JAX solvers and (b) flattened into dense op/arg tensors for
TPU-resident evaluation, without round-tripping through a foreign AST.

Sorts: bit-vectors of any width, booleans, arrays (index width -> value width).
Uninterpreted functions are applications tagged with (name, signature).
"""

from __future__ import annotations

import itertools
import weakref
from typing import Dict, Iterable, Optional, Tuple

# ---------------------------------------------------------------------------------
# Sorts
# ---------------------------------------------------------------------------------

BOOL = "bool"


class ArraySort:
    __slots__ = ("index_width", "value_width")
    _interned: Dict[Tuple[int, int], "ArraySort"] = {}

    def __new__(cls, index_width: int, value_width: int):
        key = (index_width, value_width)
        cached = cls._interned.get(key)
        if cached is None:
            cached = super().__new__(cls)
            cached.index_width = index_width
            cached.value_width = value_width
            cls._interned[key] = cached
        return cached

    def __repr__(self):
        return f"Array({self.index_width}->{self.value_width})"

    def __reduce__(self):
        return (ArraySort, (self.index_width, self.value_width))


# A sort is: int (bit-vector width), BOOL, or an ArraySort instance.

# ---------------------------------------------------------------------------------
# Term
# ---------------------------------------------------------------------------------

# Operator tags. Grouped for the folding/blasting dispatch.
BV_BINOPS = frozenset({
    "bvadd", "bvsub", "bvmul", "bvudiv", "bvsdiv", "bvurem", "bvsrem",
    "bvand", "bvor", "bvxor", "bvshl", "bvlshr", "bvashr",
})
BV_CMPS = frozenset({"eq", "bvult", "bvule", "bvslt", "bvsle"})
BOOL_OPS = frozenset({"and", "or", "not", "xor", "implies"})

_COMMUTATIVE = frozenset({"bvadd", "bvmul", "bvand", "bvor", "bvxor", "eq", "and", "or", "xor"})


class Term:
    """Immutable hash-consed expression node.

    op:    operator tag ("const", "var", "bvadd", "select", "apply", ...)
    args:  child terms
    params: non-term payload (constant value, variable name, extract bounds,
            UF signature, ...)
    sort:  int width | BOOL | ArraySort
    """

    __slots__ = ("op", "args", "params", "sort", "_hash", "__weakref__")

    # Weak interning: entries die with their last strong reference, so a long
    # multi-contract run doesn't accumulate every expression ever built (the
    # z3-backed reference gets this from AST refcounting). id()-based keys are
    # sound here: a live parent holds its children strongly, so the ids inside a
    # live key cannot be recycled.
    _interned: "weakref.WeakValueDictionary[tuple, Term]" = None  # set below
    _counter = itertools.count()

    def __new__(cls, op: str, args: Tuple["Term", ...] = (), params: tuple = (),
                sort=None):
        key = (op, tuple(id(a) for a in args), params, _sort_key(sort))
        cached = cls._interned.get(key)
        if cached is not None:
            return cached
        term = super().__new__(cls)
        term.op = op
        term.args = args
        term.params = params
        term.sort = sort
        term._hash = hash(key)
        cls._interned[key] = term
        return term

    def __hash__(self):
        return self._hash

    # identity equality is correct under hash-consing
    def __eq__(self, other):
        return self is other

    def __copy__(self):
        return self

    def __deepcopy__(self, memo):
        return self

    def __reduce__(self):
        # pickle round-trips MUST re-intern: identity is equality here, so a
        # naively reconstructed duplicate would break every constraint-set /
        # cache lookup after a checkpoint resume (frontier host-phase
        # checkpoints pickle whole GlobalStates)
        return (Term, (self.op, self.args, self.params, self.sort))

    @property
    def is_const(self) -> bool:
        return self.op == "const"

    @property
    def is_var(self) -> bool:
        return self.op == "var"

    @property
    def value(self) -> Optional[int]:
        return self.params[0] if self.op == "const" else None

    @property
    def name(self) -> Optional[str]:
        return self.params[0] if self.op == "var" else None

    @property
    def width(self) -> int:
        if not isinstance(self.sort, int):
            raise TypeError(f"term {self.op} has sort {self.sort}, not a bit-vector")
        return self.sort

    def __repr__(self):
        return _pp(self, depth=3)


Term._interned = weakref.WeakValueDictionary()


def _sort_key(sort):
    if isinstance(sort, ArraySort):
        return ("arr", sort.index_width, sort.value_width)
    return sort


def _pp(term: Term, depth: int) -> str:
    if term.op == "const":
        return f"{term.params[0]:#x}[{term.sort}]" if isinstance(term.sort, int) \
            else str(term.params[0])
    if term.op == "var":
        return str(term.params[0])
    if depth <= 0:
        return f"({term.op} ...)"
    inner = " ".join(_pp(a, depth - 1) for a in term.args)
    extra = f" {term.params}" if term.params else ""
    return f"({term.op}{extra} {inner})"


# ---------------------------------------------------------------------------------
# Constructors with folding
# ---------------------------------------------------------------------------------

TRUE = Term("const", (), (True,), BOOL)
FALSE = Term("const", (), (False,), BOOL)


def bv_const(value: int, width: int) -> Term:
    return Term("const", (), (value & ((1 << width) - 1),), width)


def bv_var(name: str, width: int) -> Term:
    return Term("var", (), (name,), width)


def bool_var(name: str) -> Term:
    return Term("var", (), (name,), BOOL)


def bool_const(value: bool) -> Term:
    return TRUE if value else FALSE


def _mask(width: int) -> int:
    return (1 << width) - 1


def _signed(value: int, width: int) -> int:
    return value - (1 << width) if value >= (1 << (width - 1)) else value


def _fold_bv_binop(op: str, a: int, b: int, width: int) -> int:
    mask = _mask(width)
    if op == "bvadd":
        return (a + b) & mask
    if op == "bvsub":
        return (a - b) & mask
    if op == "bvmul":
        return (a * b) & mask
    if op == "bvudiv":
        return (a // b) & mask if b else mask  # EVM/SMT-LIB: x/0 = all-ones
    if op == "bvurem":
        return (a % b) & mask if b else a
    if op == "bvsdiv":
        if b == 0:
            # SMT-LIB: bvsdiv x 0 = bvneg(bvudiv (bvneg x) 0) = 1 for x < 0,
            # all-ones for x >= 0
            return 1 if _signed(a, width) < 0 else mask
        sa, sb = _signed(a, width), _signed(b, width)
        quotient = abs(sa) // abs(sb)
        if (sa < 0) != (sb < 0):
            quotient = -quotient
        return quotient & mask
    if op == "bvsrem":
        if b == 0:
            return a
        sa, sb = _signed(a, width), _signed(b, width)
        remainder = abs(sa) % abs(sb)
        if sa < 0:
            remainder = -remainder
        return remainder & mask
    if op == "bvand":
        return a & b
    if op == "bvor":
        return a | b
    if op == "bvxor":
        return a ^ b
    if op == "bvshl":
        return (a << b) & mask if b < width else 0
    if op == "bvlshr":
        return a >> b if b < width else 0
    if op == "bvashr":
        sa = _signed(a, width)
        return (sa >> b) & mask if b < width else (mask if sa < 0 else 0)
    raise ValueError(op)


def bv_binop(op: str, left: Term, right: Term) -> Term:
    width = left.width
    if right.width != width:
        raise ValueError(f"{op}: width mismatch {width} vs {right.width}")
    if left.is_const and right.is_const:
        return bv_const(_fold_bv_binop(op, left.value, right.value, width), width)
    # canonical order for commutative ops: constants to the right, then by hash
    if op in _COMMUTATIVE and (left.is_const or
                               (not right.is_const and left._hash > right._hash)):
        left, right = right, left
    mask = _mask(width)
    if right.is_const:
        rv = right.value
        if op == "bvadd" and rv == 0:
            return left
        if op == "bvsub" and rv == 0:
            return left
        if op == "bvmul":
            if rv == 1:
                return left
            if rv == 0:
                return right
        if op in ("bvand",):
            if rv == 0:
                return right
            if rv == mask:
                return left
        if op in ("bvor", "bvxor") and rv == 0:
            return left
        if op == "bvor" and rv == mask:
            return right
        if op in ("bvshl", "bvlshr", "bvashr") and rv == 0:
            return left
        if op in ("bvudiv",) and rv == 1:
            return left
    if left is right:
        if op == "bvsub" or op == "bvxor":
            return bv_const(0, width)
        if op in ("bvand", "bvor"):
            return left
    return Term(op, (left, right), (), width)


def bv_neg(operand: Term) -> Term:
    return bv_binop("bvsub", bv_const(0, operand.width), operand)


def bv_not(operand: Term) -> Term:
    if operand.is_const:
        return bv_const(~operand.value, operand.width)
    if operand.op == "bvnot":
        return operand.args[0]
    return Term("bvnot", (operand,), (), operand.width)


def bv_cmp(op: str, left: Term, right: Term) -> Term:
    if left.width != right.width:
        raise ValueError(f"{op}: width mismatch {left.width} vs {right.width}")
    if left.is_const and right.is_const:
        a, b, w = left.value, right.value, left.width
        if op == "eq":
            return bool_const(a == b)
        if op == "bvult":
            return bool_const(a < b)
        if op == "bvule":
            return bool_const(a <= b)
        if op == "bvslt":
            return bool_const(_signed(a, w) < _signed(b, w))
        if op == "bvsle":
            return bool_const(_signed(a, w) <= _signed(b, w))
    if left is right:
        return bool_const(op in ("eq", "bvule", "bvsle"))
    if op == "eq" and left._hash > right._hash:
        left, right = right, left
    return Term(op, (left, right), (), BOOL)


def bool_and(*operands: Term) -> Term:
    flat = []
    for operand in operands:
        if operand is TRUE:
            continue
        if operand is FALSE:
            return FALSE
        if operand.op == "and":
            flat.extend(operand.args)
        else:
            flat.append(operand)
    unique = []
    seen = set()
    for operand in flat:
        if id(operand) not in seen:
            seen.add(id(operand))
            unique.append(operand)
    if not unique:
        return TRUE
    if len(unique) == 1:
        return unique[0]
    return Term("and", tuple(unique), (), BOOL)


def bool_or(*operands: Term) -> Term:
    flat = []
    for operand in operands:
        if operand is FALSE:
            continue
        if operand is TRUE:
            return TRUE
        if operand.op == "or":
            flat.extend(operand.args)
        else:
            flat.append(operand)
    unique = []
    seen = set()
    for operand in flat:
        if id(operand) not in seen:
            seen.add(id(operand))
            unique.append(operand)
    if not unique:
        return FALSE
    if len(unique) == 1:
        return unique[0]
    return Term("or", tuple(unique), (), BOOL)


def bool_not(operand: Term) -> Term:
    if operand is TRUE:
        return FALSE
    if operand is FALSE:
        return TRUE
    if operand.op == "not":
        return operand.args[0]
    return Term("not", (operand,), (), BOOL)


def bool_xor(left: Term, right: Term) -> Term:
    if left.is_const:
        return bool_not(right) if left.value else right
    if right.is_const:
        return bool_not(left) if right.value else left
    if left is right:
        return FALSE
    return Term("xor", (left, right), (), BOOL)


def bool_implies(left: Term, right: Term) -> Term:
    return bool_or(bool_not(left), right)


def ite(cond: Term, then: Term, otherwise: Term) -> Term:
    if cond is TRUE:
        return then
    if cond is FALSE:
        return otherwise
    if then is otherwise:
        return then
    if then.sort != otherwise.sort:
        raise ValueError("ite branches have different sorts")
    # If(c, 1, 0) patterns keep their compact form; no further rewriting here.
    return Term("ite", (cond, then, otherwise), (), then.sort)


def concat(*operands: Term) -> Term:
    flat = []
    for operand in operands:
        if operand.op == "concat":
            flat.extend(operand.args)
        else:
            flat.append(operand)
    width = sum(o.width for o in flat)
    if all(o.is_const for o in flat):
        value = 0
        for operand in flat:
            value = (value << operand.width) | operand.value
        return bv_const(value, width)
    if len(flat) == 1:
        return flat[0]
    return Term("concat", tuple(flat), (), width)


def extract(high: int, low: int, operand: Term) -> Term:
    width = high - low + 1
    if width <= 0 or high >= operand.width:
        raise ValueError(f"bad extract [{high}:{low}] from width {operand.width}")
    if width == operand.width:
        return operand
    if operand.is_const:
        return bv_const(operand.value >> low, width)
    if operand.op == "extract":
        inner_low = operand.params[1]
        return extract(inner_low + high, inner_low + low, operand.args[0])
    if operand.op == "concat":
        # narrow into a single concat limb when the slice doesn't straddle
        offset = operand.width
        for part in operand.args:
            offset -= part.width
            if low >= offset and high < offset + part.width:
                return extract(high - offset, low - offset, part)
    if operand.op == "zext":
        inner = operand.args[0]
        if high < inner.width:
            return extract(high, low, inner)
        if low >= inner.width:
            return bv_const(0, width)
    return Term("extract", (operand,), (high, low), width)


def zext(operand: Term, extra: int) -> Term:
    if extra == 0:
        return operand
    if operand.is_const:
        return bv_const(operand.value, operand.width + extra)
    return Term("zext", (operand,), (extra,), operand.width + extra)


def sext(operand: Term, extra: int) -> Term:
    if extra == 0:
        return operand
    if operand.is_const:
        return bv_const(_signed(operand.value, operand.width),
                        operand.width + extra)
    return Term("sext", (operand,), (extra,), operand.width + extra)


# -- arrays -----------------------------------------------------------------------

def const_array(index_width: int, default: Term) -> Term:
    return Term("const_array", (default,), (index_width,),
                ArraySort(index_width, default.width))


def array_var(name: str, index_width: int, value_width: int) -> Term:
    return Term("var", (), (name,), ArraySort(index_width, value_width))


def store(array: Term, index: Term, value: Term) -> Term:
    sort = array.sort
    if not isinstance(sort, ArraySort):
        raise TypeError("store on non-array")
    if index.width != sort.index_width or value.width != sort.value_width:
        raise ValueError("store width mismatch")
    return Term("store", (array, index, value), (), sort)


def select(array: Term, index: Term) -> Term:
    sort = array.sort
    if not isinstance(sort, ArraySort):
        raise TypeError("select on non-array")
    if index.width != sort.index_width:
        raise ValueError("select width mismatch")
    # read-over-write resolution while indices compare syntactically/concretely
    node = array
    while node.op == "store":
        st_index = node.args[1]
        if st_index is index:
            return node.args[2]
        if st_index.is_const and index.is_const:
            node = node.args[0]  # definitely different concrete cells
            continue
        break  # possibly aliasing symbolic index: keep the select symbolic
    if node.op == "const_array":
        # every skipped store was provably non-aliasing: the read hits the default
        return node.args[0]
    # prune the provably non-aliasing prefix of the chain
    return Term("select", (node, index), (), sort.value_width)


# -- uninterpreted functions ------------------------------------------------------

def apply_uf(name: str, args: Tuple[Term, ...], domain: Tuple[int, ...],
             range_width: int) -> Term:
    if tuple(a.width for a in args) != tuple(domain):
        raise ValueError(f"UF {name}: argument widths {[a.width for a in args]} "
                         f"!= domain {domain}")
    return Term("apply", tuple(args), (name, tuple(domain), range_width), range_width)


# ---------------------------------------------------------------------------------
# Traversal utilities
# ---------------------------------------------------------------------------------

def walk(term: Term):
    """Post-order iteration over the DAG (each node once)."""
    seen = set()
    stack = [(term, False)]
    while stack:
        node, expanded = stack.pop()
        if id(node) in seen:
            continue
        if expanded:
            seen.add(id(node))
            yield node
        else:
            stack.append((node, True))
            for arg in node.args:
                if id(arg) not in seen:
                    stack.append((arg, False))


def variables_of(term: Term) -> set:
    return {node for node in walk(term) if node.op == "var"}


def substitute(term: Term, mapping: Dict[Term, Term]) -> Term:
    """Rebuild `term` with `mapping` applied (keys are Terms, matched by identity)."""
    cache: Dict[int, Term] = {}

    def rebuild(node: Term) -> Term:
        hit = mapping.get(node)
        if hit is not None:
            return hit
        cached = cache.get(id(node))
        if cached is not None:
            return cached
        if not node.args:
            cache[id(node)] = node
            return node
        new_args = tuple(rebuild(arg) for arg in node.args)
        if all(na is oa for na, oa in zip(new_args, node.args)):
            result = node
        else:
            result = _rebuild_node(node, new_args)
        cache[id(node)] = result
        return result

    order = list(walk(term))
    for node in order:  # bottom-up so recursion depth stays O(1) per node
        rebuild(node)
    return rebuild(term)


def _rebuild_node(node: Term, new_args: Tuple[Term, ...]) -> Term:
    op = node.op
    if op in BV_BINOPS:
        return bv_binop(op, *new_args)
    if op in BV_CMPS:
        return bv_cmp(op, *new_args)
    if op == "bvnot":
        return bv_not(new_args[0])
    if op == "and":
        return bool_and(*new_args)
    if op == "or":
        return bool_or(*new_args)
    if op == "not":
        return bool_not(new_args[0])
    if op == "xor":
        return bool_xor(*new_args)
    if op == "ite":
        return ite(*new_args)
    if op == "concat":
        return concat(*new_args)
    if op == "extract":
        return extract(node.params[0], node.params[1], new_args[0])
    if op == "zext":
        return zext(new_args[0], node.params[0])
    if op == "sext":
        return sext(new_args[0], node.params[0])
    if op == "select":
        return select(*new_args)
    if op == "store":
        return store(*new_args)
    if op == "const_array":
        return const_array(node.params[0], new_args[0])
    if op == "apply":
        return apply_uf(node.params[0], new_args, node.params[1], node.params[2])
    return Term(op, new_args, node.params, node.sort)


def evaluate(term: Term, assignment: Dict[Term, int]):
    """Concretely evaluate under an assignment var-term -> int/bool.

    Arrays in `assignment` map to dict {index_int: value_int} with optional
    "default" key. Raises KeyError on unassigned variables (caller decides the
    default policy), making this the cheap model-checking primitive used by the
    quick-sat model cache.
    """
    cache: Dict[int, object] = {}
    for node in walk(term):
        cache[id(node)] = _eval_node(node, assignment, cache)
    return cache[id(term)]


def _eval_node(node: Term, assignment, cache):
    op = node.op
    if op == "const":
        return node.params[0]
    if op == "var":
        return assignment[node]
    args = [cache[id(a)] for a in node.args]
    if op in BV_BINOPS:
        return _fold_bv_binop(op, args[0], args[1], node.width)
    if op == "bvnot":
        return ~args[0] & _mask(node.width)
    if op == "eq":
        return args[0] == args[1]
    if op == "bvult":
        return args[0] < args[1]
    if op == "bvule":
        return args[0] <= args[1]
    if op == "bvslt":
        w = node.args[0].width
        return _signed(args[0], w) < _signed(args[1], w)
    if op == "bvsle":
        w = node.args[0].width
        return _signed(args[0], w) <= _signed(args[1], w)
    if op == "and":
        return all(args)
    if op == "or":
        return any(args)
    if op == "not":
        return not args[0]
    if op == "xor":
        return args[0] != args[1]
    if op == "ite":
        return args[1] if args[0] else args[2]
    if op == "concat":
        value = 0
        for arg_term, arg_val in zip(node.args, args):
            value = (value << arg_term.width) | arg_val
        return value
    if op == "extract":
        high, low = node.params
        return (args[0] >> low) & _mask(high - low + 1)
    if op == "zext":
        return args[0]
    if op == "sext":
        inner_width = node.args[0].width
        return _signed(args[0], inner_width) & _mask(node.width)
    if op == "const_array":
        return {"default": args[0]}
    if op == "store":
        table = dict(args[0])
        table[args[1]] = args[2]
        return table
    if op == "select":
        table = args[0]
        if args[1] in table:
            return table[args[1]]
        if "default" in table:
            return table["default"]
        raise KeyError(f"unassigned array cell {args[1]}")
    if op == "apply":
        key = (node.params[0], tuple(args))
        table = assignment.get("__uf__", {})
        if key in table:
            return table[key]
        raise KeyError(f"unassigned UF application {key}")
    raise ValueError(f"cannot evaluate op {op}")
