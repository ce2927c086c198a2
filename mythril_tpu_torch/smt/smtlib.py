"""SMT-LIB2 printer + parser for the term IR.

The port's copy of mythril_tpu/smt/smtlib.py, unchanged.

Role parity: the reference's `--solver-log` dumps every query as .smt2
(mythril/support/model.py:51-61); that corpus is the differential-testing referee
between this build's solver and any external SMT solver the user runs offline.
`from_smt2` reads the subset this module prints, so captured query corpora can
be replayed through both SAT backends (tests/test_jax_solver.py)."""

from __future__ import annotations

from typing import Dict, List, Tuple

from . import terms


def _sort_str(sort) -> str:
    if sort == terms.BOOL:
        return "Bool"
    if isinstance(sort, terms.ArraySort):
        return f"(Array (_ BitVec {sort.index_width}) (_ BitVec {sort.value_width}))"
    return f"(_ BitVec {sort})"


_OP_MAP = {
    "bvadd": "bvadd", "bvsub": "bvsub", "bvmul": "bvmul", "bvudiv": "bvudiv",
    "bvsdiv": "bvsdiv", "bvurem": "bvurem", "bvsrem": "bvsrem", "bvand": "bvand",
    "bvor": "bvor", "bvxor": "bvxor", "bvshl": "bvshl", "bvlshr": "bvlshr",
    "bvashr": "bvashr", "bvnot": "bvnot", "bvult": "bvult", "bvule": "bvule",
    "bvslt": "bvslt", "bvsle": "bvsle", "eq": "=", "and": "and", "or": "or",
    "not": "not", "xor": "xor", "ite": "ite", "select": "select", "store": "store",
    "concat": "concat",
}


def _mangle(name: str) -> str:
    safe = "".join(ch if ch.isalnum() or ch in "_.$" else "_" for ch in str(name))
    return f"|{name}|" if safe != str(name) else safe


def term_to_smt2(node: terms.Term, cache: Dict[terms.Term, str]) -> str:
    hit = cache.get(node)
    if hit is not None:
        return hit
    op = node.op
    if op == "const":
        if node.sort == terms.BOOL:
            text = "true" if node.params[0] else "false"
        else:
            text = f"(_ bv{node.params[0]} {node.sort})"
    elif op == "var":
        text = _mangle(node.params[0])
    elif op == "extract":
        text = f"((_ extract {node.params[0]} {node.params[1]}) " \
               f"{term_to_smt2(node.args[0], cache)})"
    elif op == "zext":
        text = f"((_ zero_extend {node.params[0]}) {term_to_smt2(node.args[0], cache)})"
    elif op == "sext":
        text = f"((_ sign_extend {node.params[0]}) {term_to_smt2(node.args[0], cache)})"
    elif op == "const_array":
        text = f"((as const {_sort_str(node.sort)}) {term_to_smt2(node.args[0], cache)})"
    elif op == "apply":
        inner = " ".join(term_to_smt2(a, cache) for a in node.args)
        text = f"({_mangle(node.params[0])} {inner})"
    else:
        mapped = _OP_MAP.get(op)
        if mapped is None:
            raise ValueError(f"cannot print op {op}")
        inner = " ".join(term_to_smt2(a, cache) for a in node.args)
        text = f"({mapped} {inner})"
    cache[node] = text
    return text


def to_smt2(constraints: List[terms.Term]) -> str:
    declarations = {}
    ufs = {}
    for constraint in constraints:
        for node in terms.walk(constraint):
            if node.op == "var":
                declarations[node.params[0]] = node.sort
            elif node.op == "apply":
                ufs[node.params[0]] = (node.params[1], node.params[2])
    lines = ["(set-logic QF_AUFBV)"]
    for name, sort in sorted(declarations.items()):
        lines.append(f"(declare-fun {_mangle(name)} () {_sort_str(sort)})")
    for name, (domain, range_width) in sorted(ufs.items()):
        domain_str = " ".join(f"(_ BitVec {w})" for w in domain)
        lines.append(f"(declare-fun {_mangle(name)} ({domain_str}) "
                     f"(_ BitVec {range_width}))")
    cache: Dict[terms.Term, str] = {}
    for constraint in constraints:
        lines.append(f"(assert {term_to_smt2(constraint, cache)})")
    lines.append("(check-sat)")
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------- #
# parser (for the subset printed above)                                       #
# --------------------------------------------------------------------------- #


def _tokenize(text: str) -> List[str]:
    tokens: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch in "()":
            tokens.append(ch)
            i += 1
        elif ch == "|":
            j = text.index("|", i + 1)
            tokens.append(text[i:j + 1])
            i = j + 1
        elif ch == ";":
            while i < n and text[i] != "\n":
                i += 1
        elif ch.isspace():
            i += 1
        else:
            j = i
            while j < n and not text[j].isspace() and text[j] not in "()|;":
                j += 1
            tokens.append(text[i:j])
            i = j
    return tokens


def _read_sexpr(tokens: List[str], pos: int):
    token = tokens[pos]
    if token == "(":
        items = []
        pos += 1
        while tokens[pos] != ")":
            item, pos = _read_sexpr(tokens, pos)
            items.append(item)
        return items, pos + 1
    return token, pos + 1


def _symbol(token: str) -> str:
    return token[1:-1] if token.startswith("|") else token


def _parse_sort(sexpr):
    if sexpr == "Bool":
        return terms.BOOL
    if isinstance(sexpr, list) and sexpr[0] == "_" and sexpr[1] == "BitVec":
        return int(sexpr[2])
    if isinstance(sexpr, list) and sexpr[0] == "Array":
        return terms.ArraySort(_parse_sort(sexpr[1]), _parse_sort(sexpr[2]))
    raise ValueError(f"unknown sort {sexpr}")


class _Parser:
    def __init__(self):
        self.vars: Dict[str, terms.Term] = {}
        self.ufs: Dict[str, Tuple[Tuple[int, ...], int]] = {}

    def expr(self, sexpr) -> terms.Term:
        if isinstance(sexpr, str):
            if sexpr == "true":
                return terms.TRUE
            if sexpr == "false":
                return terms.FALSE
            name = _symbol(sexpr)
            if name in self.vars:
                return self.vars[name]
            raise ValueError(f"undeclared symbol {name}")
        head = sexpr[0]
        if head == "_":  # (_ bvN W)
            return terms.bv_const(int(sexpr[1][2:]), int(sexpr[2]))
        if isinstance(head, list):
            if head[0] == "_" and head[1] == "extract":
                return terms.extract(int(head[2]), int(head[3]),
                                     self.expr(sexpr[1]))
            if head[0] == "_" and head[1] == "zero_extend":
                return terms.zext(self.expr(sexpr[1]), int(head[2]))
            if head[0] == "_" and head[1] == "sign_extend":
                return terms.sext(self.expr(sexpr[1]), int(head[2]))
            if head[0] == "as" and head[1] == "const":
                sort = _parse_sort(head[2])
                return terms.const_array(sort.index_width, self.expr(sexpr[1]))
            raise ValueError(f"unknown head {head}")
        operands = [self.expr(a) for a in sexpr[1:]]
        if head == "=":
            if operands[0].sort == terms.BOOL:
                return terms.bool_not(terms.bool_xor(*operands))
            return terms.bv_cmp("eq", *operands)
        if head in ("bvult", "bvule", "bvslt", "bvsle"):
            return terms.bv_cmp(head, *operands)
        if head == "and":
            return terms.bool_and(*operands)
        if head == "or":
            return terms.bool_or(*operands)
        if head == "not":
            return terms.bool_not(*operands)
        if head == "xor":
            return terms.bool_xor(*operands)
        if head == "ite":
            return terms.ite(*operands)
        if head == "select":
            return terms.select(*operands)
        if head == "store":
            return terms.store(*operands)
        if head == "concat":
            return terms.concat(*operands)
        if head == "bvnot":
            return terms.bv_not(*operands)
        if head in ("bvadd", "bvsub", "bvmul", "bvudiv", "bvsdiv", "bvurem",
                    "bvsrem", "bvand", "bvor", "bvxor", "bvshl", "bvlshr",
                    "bvashr"):
            result = operands[0]
            for operand in operands[1:]:
                result = terms.bv_binop(head, result, operand)
            return result
        name = _symbol(head)
        if name in self.ufs:
            domain, range_width = self.ufs[name]
            return terms.apply_uf(name, tuple(operands), domain, range_width)
        raise ValueError(f"unknown operator {head}")


def from_smt2(text: str) -> List[terms.Term]:
    """Parse the subset of SMT-LIB2 printed by `to_smt2` back into assert
    terms (the --solver-log replay path)."""
    tokens = _tokenize(text)
    parser = _Parser()
    asserts: List[terms.Term] = []
    pos = 0
    while pos < len(tokens):
        sexpr, pos = _read_sexpr(tokens, pos)
        if not isinstance(sexpr, list) or not sexpr:
            continue
        command = sexpr[0]
        if command == "declare-fun":
            name = _symbol(sexpr[1])
            domain, sort = sexpr[2], _parse_sort(sexpr[3])
            if domain:  # uninterpreted function
                parser.ufs[name] = (tuple(_parse_sort(s) for s in domain), sort)
            elif sort == terms.BOOL:
                parser.vars[name] = terms.bool_var(name)
            elif isinstance(sort, terms.ArraySort):
                parser.vars[name] = terms.array_var(
                    name, sort.index_width, sort.value_width)
            else:
                parser.vars[name] = terms.bv_var(name, sort)
        elif command == "assert":
            asserts.append(parser.expr(sexpr[1]))
    return asserts
