"""Bit-blaster: pure-QF_BV terms -> CNF (Tseitin with structural hashing).

The port's copy of mythril_tpu/smt/solver/bitblast.py, unchanged.

Pipeline position: preprocess.lower_constraints -> [this] -> CDCL (native/cdcl.cpp via
ctypes) or the batched JAX unit-propagation solver (parallel/jax_solver.py), which
both consume the same clause lists.

Conventions: SAT variables are positive ints, negation by sign (DIMACS). Variable 1 is
pinned TRUE (unit clause [1]) so constants are literals too. Bit lists are LSB-first.

Circuit choices: ripple-carry adders, shift-add multipliers (constant operands gate
out zero bits), barrel shifters with an explicit out-of-range guard (EVM shift
amounts are full 256-bit words), restoring division with SMT-LIB div-by-zero
semantics (x/0 = all-ones, x%0 = x) to match terms._fold_bv_binop exactly.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .. import terms


class Blaster:
    def __init__(self):
        self.n_vars = 1
        self.clauses: List[List[int]] = [[1]]  # var 1 pinned TRUE
        self.TRUE = 1
        self.FALSE = -1
        self._bv_cache: Dict[terms.Term, List[int]] = {}
        self._bool_cache: Dict[terms.Term, int] = {}
        self._gate_cache: Dict[tuple, int] = {}
        #: input BV var term -> bit literals (for model extraction)
        self.var_bits: Dict[terms.Term, List[int]] = {}
        #: input Bool var term -> literal
        self.var_lits: Dict[terms.Term, int] = {}
        #: gate var -> (first clause index, clause count) of its definition
        self.gate_clauses: Dict[int, Tuple[int, int]] = {}
        #: gate var -> abs child vars — the cone-of-influence edge list used
        #: by the incremental pipeline to ship only a query's reachable
        #: definitions to the device SAT lane (the pool itself outgrows the
        #: device clause cap within a few queries)
        self.gate_children: Dict[int, Tuple[int, ...]] = {}

    # -- gate layer ------------------------------------------------------------------
    def new_lit(self) -> int:
        self.n_vars += 1
        return self.n_vars

    def AND(self, a: int, b: int) -> int:
        if a == self.FALSE or b == self.FALSE:
            return self.FALSE
        if a == self.TRUE:
            return b
        if b == self.TRUE:
            return a
        if a == b:
            return a
        if a == -b:
            return self.FALSE
        key = ("and", min(a, b), max(a, b))
        hit = self._gate_cache.get(key)
        if hit is not None:
            return hit
        c = self.new_lit()
        self.gate_clauses[c] = (len(self.clauses), 3)
        self.gate_children[c] = (abs(a), abs(b))
        self.clauses += [[-a, -b, c], [a, -c], [b, -c]]
        self._gate_cache[key] = c
        return c

    def OR(self, a: int, b: int) -> int:
        return -self.AND(-a, -b)

    def XOR(self, a: int, b: int) -> int:
        if a == self.FALSE:
            return b
        if b == self.FALSE:
            return a
        if a == self.TRUE:
            return -b
        if b == self.TRUE:
            return -a
        if a == b:
            return self.FALSE
        if a == -b:
            return self.TRUE
        key = ("xor", min(abs(a), abs(b)), max(abs(a), abs(b)),
               (a < 0) ^ (b < 0))
        hit = self._gate_cache.get(key)
        if hit is not None:
            return hit
        c = self.new_lit()
        self.gate_clauses[c] = (len(self.clauses), 4)
        self.gate_children[c] = (abs(a), abs(b))
        self.clauses += [[-a, -b, -c], [a, b, -c], [a, -b, c], [-a, b, c]]
        self._gate_cache[key] = c
        return c

    def MUX(self, s: int, a: int, b: int) -> int:
        """s ? a : b"""
        if s == self.TRUE:
            return a
        if s == self.FALSE:
            return b
        if a == b:
            return a
        if a == self.TRUE and b == self.FALSE:
            return s
        if a == self.FALSE and b == self.TRUE:
            return -s
        key = ("mux", s, a, b)
        hit = self._gate_cache.get(key)
        if hit is not None:
            return hit
        c = self.new_lit()
        self.gate_clauses[c] = (len(self.clauses), 4)
        self.gate_children[c] = (abs(s), abs(a), abs(b))
        self.clauses += [[-s, -a, c], [-s, a, -c], [s, -b, c], [s, b, -c]]
        self._gate_cache[key] = c
        return c

    def or_many(self, lits: List[int]) -> int:
        out = self.FALSE
        for lit in lits:
            out = self.OR(out, lit)
        return out

    def and_many(self, lits: List[int]) -> int:
        out = self.TRUE
        for lit in lits:
            out = self.AND(out, lit)
        return out

    # -- word layer ------------------------------------------------------------------
    def const_bits(self, value: int, width: int) -> List[int]:
        return [self.TRUE if (value >> i) & 1 else self.FALSE for i in range(width)]

    def full_adder(self, a: int, b: int, cin: int) -> Tuple[int, int]:
        axb = self.XOR(a, b)
        total = self.XOR(axb, cin)
        carry = self.OR(self.AND(a, b), self.AND(cin, axb))
        return total, carry

    def add(self, a: List[int], b: List[int], cin: int = None) -> List[int]:
        carry = cin if cin is not None else self.FALSE
        out = []
        for bit_a, bit_b in zip(a, b):
            total, carry = self.full_adder(bit_a, bit_b, carry)
            out.append(total)
        return out

    def sub(self, a: List[int], b: List[int]) -> List[int]:
        return self.add(a, [-bit for bit in b], cin=self.TRUE)

    def neg(self, a: List[int]) -> List[int]:
        return self.add([-bit for bit in a], self.const_bits(0, len(a)), cin=self.TRUE)

    def mul(self, a: List[int], b: List[int]) -> List[int]:
        width = len(a)
        # prefer the operand with more constant-FALSE bits as the gating side
        def falses(bits):
            return sum(1 for bit in bits if bit == self.FALSE)
        if falses(a) > falses(b):
            a, b = b, a
        acc = self.const_bits(0, width)
        for i, gate in enumerate(b):
            if gate == self.FALSE:
                continue
            addend = [self.FALSE] * i + [self.AND(bit, gate) for bit in a[:width - i]]
            acc = self.add(acc, addend)
        return acc

    def eq(self, a: List[int], b: List[int]) -> int:
        return self.and_many([-self.XOR(x, y) for x, y in zip(a, b)])

    def ult(self, a: List[int], b: List[int]) -> int:
        lt = self.FALSE
        for x, y in zip(a, b):  # LSB -> MSB ripple comparator
            lt = self.MUX(self.XOR(x, y), self.AND(-x, y), lt)
        return lt

    def ule(self, a: List[int], b: List[int]) -> int:
        return -self.ult(b, a)

    def slt(self, a: List[int], b: List[int]) -> int:
        flipped_a = a[:-1] + [-a[-1]]
        flipped_b = b[:-1] + [-b[-1]]
        return self.ult(flipped_a, flipped_b)

    def sle(self, a: List[int], b: List[int]) -> int:
        return -self.slt(b, a)

    def mux_word(self, s: int, a: List[int], b: List[int]) -> List[int]:
        return [self.MUX(s, x, y) for x, y in zip(a, b)]

    def _shift_stages(self, a: List[int], amount: List[int], kind: str) -> List[int]:
        width = len(a)
        n_stages = max(1, (width - 1).bit_length())
        fill = a[-1] if kind == "ashr" else self.FALSE
        current = list(a)
        for stage in range(n_stages):
            gate = amount[stage]
            step = 1 << stage
            if kind == "shl":
                shifted = [self.FALSE] * min(step, width) + current[:max(0, width - step)]
            else:
                shifted = current[min(step, width):] + [fill] * min(step, width)
            current = self.mux_word(gate, shifted, current)
        # out-of-range: amount >= width (any high bit set, or low-bits value >= width)
        n = max(1, (width - 1).bit_length())
        high_set = self.or_many(amount[n:])
        low_ge = -self.ult(amount[:n] + [self.FALSE], self.const_bits(width, n + 1)) \
            if (1 << n) > width else self.FALSE
        oor = self.OR(high_set, low_ge)
        return self.mux_word(oor, [fill] * width, current)

    def udivrem(self, a: List[int], b: List[int]) -> Tuple[List[int], List[int]]:
        width = len(a)
        b_wide = b + [self.FALSE]
        rem = self.const_bits(0, width + 1)
        quotient = [self.FALSE] * width
        for i in reversed(range(width)):
            rem = [a[i]] + rem[:-1]  # rem = (rem << 1) | a[i]
            geq = -self.ult(rem, b_wide)
            rem = self.mux_word(geq, self.sub(rem, b_wide), rem)
            quotient[i] = geq
        b_zero = -self.or_many(b)
        final_q = self.mux_word(b_zero, self.const_bits((1 << width) - 1, width), quotient)
        final_r = self.mux_word(b_zero, a, rem[:width])
        return final_q, final_r

    def sdivrem(self, a: List[int], b: List[int]) -> Tuple[List[int], List[int]]:
        sign_a, sign_b = a[-1], b[-1]
        abs_a = self.mux_word(sign_a, self.neg(a), a)
        abs_b = self.mux_word(sign_b, self.neg(b), b)
        q, r = self.udivrem(abs_a, abs_b)
        q_sign = self.XOR(sign_a, sign_b)
        q = self.mux_word(q_sign, self.neg(q), q)
        r = self.mux_word(sign_a, self.neg(r), r)
        width = len(a)
        b_zero = -self.or_many(b)
        # SMT-LIB: bvsdiv x 0 = 1 for x < 0, all-ones otherwise; bvsrem x 0 = x
        div_by_zero = self.mux_word(sign_a, self.const_bits(1, width),
                                    self.const_bits((1 << width) - 1, width))
        q = self.mux_word(b_zero, div_by_zero, q)
        r = self.mux_word(b_zero, a, r)
        return q, r

    # -- term layer ------------------------------------------------------------------
    def _blast(self, node: terms.Term) -> None:
        # iterative post-order over the DAG (store chains / long sums recurse deep)
        stack = [node]
        while stack:
            current = stack[-1]
            if current in self._bv_cache or current in self._bool_cache:
                stack.pop()
                continue
            pending = [a for a in current.args
                       if a not in self._bv_cache and a not in self._bool_cache]
            if pending:
                stack.extend(pending)
                continue
            stack.pop()
            if current.sort == terms.BOOL:
                self._bool_cache[current] = self._blast_bool_node(current)
            else:
                self._bv_cache[current] = self._blast_bv_node(current)

    def blast_bv(self, node: terms.Term) -> List[int]:
        if node not in self._bv_cache:
            self._blast(node)
        return self._bv_cache[node]

    def blast_bool(self, node: terms.Term) -> int:
        if node not in self._bool_cache:
            self._blast(node)
        return self._bool_cache[node]

    def _blast_bv_node(self, node: terms.Term) -> List[int]:
        op = node.op
        width = node.width
        if op == "const":
            return self.const_bits(node.value, width)
        if op == "var":
            bits = [self.new_lit() for _ in range(width)]
            self.var_bits[node] = bits
            return bits
        args = node.args
        if op in ("bvadd", "bvsub", "bvmul", "bvand", "bvor", "bvxor"):
            a, b = self._bv_cache[args[0]], self._bv_cache[args[1]]
            if op == "bvadd":
                return self.add(a, b)
            if op == "bvsub":
                return self.sub(a, b)
            if op == "bvmul":
                return self.mul(a, b)
            if op == "bvand":
                return [self.AND(x, y) for x, y in zip(a, b)]
            if op == "bvor":
                return [self.OR(x, y) for x, y in zip(a, b)]
            return [self.XOR(x, y) for x, y in zip(a, b)]
        if op == "bvnot":
            return [-bit for bit in self._bv_cache[args[0]]]
        if op in ("bvshl", "bvlshr", "bvashr"):
            a, amount = self._bv_cache[args[0]], self._bv_cache[args[1]]
            kind = {"bvshl": "shl", "bvlshr": "lshr", "bvashr": "ashr"}[op]
            if args[1].is_const:
                return self._const_shift(a, args[1].value, kind)
            return self._shift_stages(a, amount, kind)
        if op in ("bvudiv", "bvurem"):
            q, r = self.udivrem(self._bv_cache[args[0]], self._bv_cache[args[1]])
            return q if op == "bvudiv" else r
        if op in ("bvsdiv", "bvsrem"):
            q, r = self.sdivrem(self._bv_cache[args[0]], self._bv_cache[args[1]])
            return q if op == "bvsdiv" else r
        if op == "concat":  # args MSB-first; bits LSB-first
            bits: List[int] = []
            for part in reversed(args):
                bits.extend(self._bv_cache[part])
            return bits
        if op == "extract":
            high, low = node.params
            return self._bv_cache[args[0]][low:high + 1]
        if op == "zext":
            return self._bv_cache[args[0]] + [self.FALSE] * node.params[0]
        if op == "sext":
            inner = self._bv_cache[args[0]]
            return inner + [inner[-1]] * node.params[0]
        if op == "ite":
            s = self._bool_cache[args[0]]
            return self.mux_word(s, self._bv_cache[args[1]], self._bv_cache[args[2]])
        raise ValueError(f"cannot bit-blast BV op {op} "
                         f"(arrays/UFs must be lowered by preprocess first)")

    def _const_shift(self, a: List[int], amount: int, kind: str) -> List[int]:
        width = len(a)
        fill = a[-1] if kind == "ashr" else self.FALSE
        if amount >= width:
            return [fill] * width
        if kind == "shl":
            return [self.FALSE] * amount + a[:width - amount]
        return a[amount:] + [fill] * amount

    def _blast_bool_node(self, node: terms.Term) -> int:
        op = node.op
        if op == "const":
            return self.TRUE if node.params[0] else self.FALSE
        if op == "var":
            lit = self.new_lit()
            self.var_lits[node] = lit
            return lit
        args = node.args
        if op == "and":
            return self.and_many([self._bool_cache[a] for a in args])
        if op == "or":
            return self.or_many([self._bool_cache[a] for a in args])
        if op == "not":
            return -self._bool_cache[args[0]]
        if op == "xor":
            return self.XOR(self._bool_cache[args[0]], self._bool_cache[args[1]])
        if op == "ite":
            return self.MUX(self._bool_cache[args[0]], self._bool_cache[args[1]],
                            self._bool_cache[args[2]])
        if op == "eq":
            return self.eq(self._bv_cache[args[0]], self._bv_cache[args[1]])
        if op == "bvult":
            return self.ult(self._bv_cache[args[0]], self._bv_cache[args[1]])
        if op == "bvule":
            return self.ule(self._bv_cache[args[0]], self._bv_cache[args[1]])
        if op == "bvslt":
            return self.slt(self._bv_cache[args[0]], self._bv_cache[args[1]])
        if op == "bvsle":
            return self.sle(self._bv_cache[args[0]], self._bv_cache[args[1]])
        raise ValueError(f"cannot bit-blast Bool op {op}")

    def assert_true(self, node: terms.Term) -> int:
        lit = self.blast_bool(node)
        self.clauses.append([lit])
        return lit
