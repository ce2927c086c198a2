"""Symbolic block-transformer encoding for rewrite-equivalence proofs.

A basic-block body (terminator excluded) is summarized as a *transformer*
over an unknown entry state: the entry stack slots it consumes become
lazily-materialized 256-bit variables, memory is a byte array
(index 256 -> value 8, MSTORE = 32 byte stores MSB-first) and storage a
word array (256 -> 256). Two bodies simulated against the *same* entry
variables are compared by a miter: a disjunction of disagreement
predicates over the padded output stacks plus fresh probe indices into
the final memory/storage arrays. SAT means some entry state
distinguishes the bodies; UNSAT means the candidate is a drop-in
replacement. Because the term IR hash-conses and constant-folds, a
miter that folds to FALSE is a *syntactic* proof (no solver query) and
one that folds to TRUE is rejected without a query.

Only the whitelisted pure stack/memory/storage opcodes below are
encodable; anything observing the environment (GAS, PC, MSIZE, SHA3,
CALL*, LOG*, ...) or with blasting-hostile semantics (EXP, ADDMOD,
MULMOD, BYTE, SIGNEXTEND) makes a block ineligible.

The module also carries the concrete differential interpreter used to
screen exhaustive-search candidates, to self-check every accepted
rewrite, and by tests/test_superopt.py for the >=40-environment replay.

The port's copy of mythril_tpu/superopt/encode.py, over the port's
smt/terms.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..smt import terms

WORD = 256
MASK = (1 << WORD) - 1

#: (name, immediate) — immediate is an int for PUSH1..32, else None
BodyOp = Tuple[str, Optional[int]]

# Opcodes whose effect is a pure function of (stack, memory, storage).
ENCODABLE = frozenset(
    ["ADD", "SUB", "MUL", "DIV", "SDIV", "MOD", "SMOD",
     "LT", "GT", "SLT", "SGT", "EQ", "ISZERO",
     "AND", "OR", "XOR", "NOT", "SHL", "SHR", "SAR",
     "POP", "JUMPDEST", "PUSH0",
     "MLOAD", "MSTORE", "MSTORE8", "SLOAD", "SSTORE"]
    + [f"PUSH{i}" for i in range(1, 33)]
    + [f"DUP{i}" for i in range(1, 17)]
    + [f"SWAP{i}" for i in range(1, 17)]
)


def is_encodable(body: List[BodyOp]) -> bool:
    return all(name in ENCODABLE for name, _ in body)


@dataclass(frozen=True)
class Transformer:
    """Symbolic summary of one body run against shared entry variables."""

    consumed: int            # entry slots materialized (depth read)
    outputs: Tuple[terms.Term, ...]   # residual stack, bottom..top
    memory: terms.Term
    storage: terms.Term
    max_growth: int          # max interim height relative to entry

    @property
    def delta(self) -> int:
        return len(self.outputs) - self.consumed


def entry_stack_var(tag: str, slot: int) -> terms.Term:
    """Entry stack slot `slot` (0 = top of stack at block entry)."""
    return terms.bv_var(f"{tag}_s{slot}", WORD)


def entry_memory(tag: str) -> terms.Term:
    return terms.array_var(f"{tag}_mem", WORD, 8)


def entry_storage(tag: str) -> terms.Term:
    return terms.array_var(f"{tag}_sto", WORD, WORD)


def _mem_store_word(memory: terms.Term, offset: terms.Term,
                    value: terms.Term) -> terms.Term:
    for i in range(32):
        addr = offset if i == 0 else terms.bv_binop(
            "bvadd", offset, terms.bv_const(i, WORD))
        byte = terms.extract(255 - 8 * i, 248 - 8 * i, value)
        memory = terms.store(memory, addr, byte)
    return memory


def _mem_load_word(memory: terms.Term, offset: terms.Term) -> terms.Term:
    parts = []
    for i in range(32):
        addr = offset if i == 0 else terms.bv_binop(
            "bvadd", offset, terms.bv_const(i, WORD))
        parts.append(terms.select(memory, addr))
    return terms.concat(*parts)


def _flag(cond: terms.Term) -> terms.Term:
    return terms.ite(cond, terms.bv_const(1, WORD), terms.bv_const(0, WORD))


def _guarded(op: str, a: terms.Term, b: terms.Term) -> terms.Term:
    # EVM defines x/0 == x%0 == 0; SMT bv division by zero does not.
    zero = terms.bv_const(0, WORD)
    return terms.ite(terms.bv_cmp("eq", b, zero), zero,
                     terms.bv_binop(op, a, b))


def simulate(body: List[BodyOp], tag: str) -> Transformer:
    """Run `body` symbolically against the shared `tag` entry state.

    Entry stack slots materialize lazily on underflow, so `consumed` is
    exactly the depth the body reads — the miter pads both sides to the
    deeper of the two.
    """
    stack: List[terms.Term] = []     # bottom..top
    consumed = 0
    max_growth = 0
    memory = entry_memory(tag)
    storage = entry_storage(tag)

    def ensure(n: int) -> None:
        nonlocal consumed
        while len(stack) < n:
            stack.insert(0, entry_stack_var(tag, consumed))
            consumed += 1

    def pop() -> terms.Term:
        ensure(1)
        return stack.pop()

    def push(value: terms.Term) -> None:
        nonlocal max_growth
        stack.append(value)
        max_growth = max(max_growth, len(stack) - consumed)

    for name, imm in body:
        if name not in ENCODABLE:
            raise ValueError(f"op {name} is not encodable")
        if name == "JUMPDEST":
            continue
        if name == "PUSH0":
            push(terms.bv_const(0, WORD))
        elif name.startswith("PUSH"):
            push(terms.bv_const((imm or 0) & MASK, WORD))
        elif name.startswith("DUP"):
            n = int(name[3:])
            ensure(n)
            push(stack[-n])
        elif name.startswith("SWAP"):
            n = int(name[4:])
            ensure(n + 1)
            stack[-1], stack[-1 - n] = stack[-1 - n], stack[-1]
        elif name == "POP":
            pop()
        elif name in ("ADD", "SUB", "MUL", "AND", "OR", "XOR"):
            a, b = pop(), pop()
            push(terms.bv_binop("bv" + name.lower(), a, b))
        elif name in ("DIV", "SDIV", "MOD", "SMOD"):
            a, b = pop(), pop()
            smt_op = {"DIV": "bvudiv", "SDIV": "bvsdiv",
                      "MOD": "bvurem", "SMOD": "bvsrem"}[name]
            push(_guarded(smt_op, a, b))
        elif name in ("SHL", "SHR", "SAR"):
            shift, value = pop(), pop()
            smt_op = {"SHL": "bvshl", "SHR": "bvlshr", "SAR": "bvashr"}[name]
            push(terms.bv_binop(smt_op, value, shift))
        elif name == "LT":
            a, b = pop(), pop()
            push(_flag(terms.bv_cmp("bvult", a, b)))
        elif name == "GT":
            a, b = pop(), pop()
            push(_flag(terms.bv_cmp("bvult", b, a)))
        elif name == "SLT":
            a, b = pop(), pop()
            push(_flag(terms.bv_cmp("bvslt", a, b)))
        elif name == "SGT":
            a, b = pop(), pop()
            push(_flag(terms.bv_cmp("bvslt", b, a)))
        elif name == "EQ":
            a, b = pop(), pop()
            push(_flag(terms.bv_cmp("eq", a, b)))
        elif name == "ISZERO":
            a = pop()
            push(_flag(terms.bv_cmp("eq", a, terms.bv_const(0, WORD))))
        elif name == "NOT":
            push(terms.bv_not(pop()))
        elif name == "MLOAD":
            push(_mem_load_word(memory, pop()))
        elif name == "MSTORE":
            offset, value = pop(), pop()
            memory = _mem_store_word(memory, offset, value)
        elif name == "MSTORE8":
            offset, value = pop(), pop()
            memory = terms.store(memory, offset, terms.extract(7, 0, value))
        elif name == "SLOAD":
            push(terms.select(storage, pop()))
        elif name == "SSTORE":
            key, value = pop(), pop()
            storage = terms.store(storage, key, value)
        else:  # pragma: no cover — whitelist and dispatch must agree
            raise ValueError(f"unhandled encodable op {name}")

    return Transformer(consumed=consumed, outputs=tuple(stack),
                       memory=memory, storage=storage,
                       max_growth=max_growth)


def build_miter(original: Transformer, candidate: Transformer,
                tag: str) -> Optional[terms.Term]:
    """Boolean term that is SAT iff some entry state distinguishes the
    two transformers. Returns None when the net stack deltas differ
    (never equivalent, no query worth making). FALSE means syntactic
    equivalence; TRUE means syntactic inequivalence.
    """
    if original.delta != candidate.delta:
        return None
    depth = max(original.consumed, candidate.consumed)
    disjuncts: List[terms.Term] = []
    for side_a, side_b in zip(_padded(original, tag, depth),
                              _padded(candidate, tag, depth)):
        if side_a is side_b:
            continue
        disjuncts.append(terms.bool_not(terms.bv_cmp("eq", side_a, side_b)))
    if original.memory is not candidate.memory:
        probe = terms.bv_var(f"{tag}_probe_mem", WORD)
        disjuncts.append(terms.bool_not(terms.bv_cmp(
            "eq", terms.select(original.memory, probe),
            terms.select(candidate.memory, probe))))
    if original.storage is not candidate.storage:
        probe = terms.bv_var(f"{tag}_probe_sto", WORD)
        disjuncts.append(terms.bool_not(terms.bv_cmp(
            "eq", terms.select(original.storage, probe),
            terms.select(candidate.storage, probe))))
    if not disjuncts:
        return terms.FALSE
    return terms.bool_or(*disjuncts)


def _padded(side: Transformer, tag: str, depth: int) -> List[terms.Term]:
    """Output stack top..bottom, padded with untouched deeper entry
    slots so both sides describe the same `depth` entry slots."""
    padded = list(reversed(side.outputs))
    for slot in range(side.consumed, depth):
        padded.append(entry_stack_var(tag, slot))
    return padded


# ---------------------------------------------------------------------------------
# Concrete differential interpreter
# ---------------------------------------------------------------------------------

def _c_signed(value: int) -> int:
    return value - (1 << WORD) if value >> (WORD - 1) else value


def concrete_run(body: List[BodyOp], entry_stack: List[int],
                 memory: Dict[int, int], storage: Dict[int, int]
                 ) -> Tuple[List[int], Dict[int, int], Dict[int, int]]:
    """Concretely execute `body` from an entry environment.

    `entry_stack` is top-first; `memory` maps byte address -> byte value
    (missing cells read 0); `storage` maps word key -> word value.
    Returns the final (stack top-first, memory, storage) without
    mutating the inputs. Raises IndexError if the body digs deeper than
    the provided entry stack — callers supply a stack at least as deep
    as the transformer's `consumed`.
    """
    stack = list(reversed(entry_stack))   # bottom..top
    mem = dict(memory)
    sto = dict(storage)

    for name, imm in body:
        if name == "JUMPDEST":
            continue
        if name == "PUSH0":
            stack.append(0)
        elif name.startswith("PUSH"):
            stack.append((imm or 0) & MASK)
        elif name.startswith("DUP"):
            stack.append(stack[-int(name[3:])])
        elif name.startswith("SWAP"):
            n = int(name[4:])
            if len(stack) < n + 1:
                raise IndexError("stack underflow")
            stack[-1], stack[-1 - n] = stack[-1 - n], stack[-1]
        elif name == "POP":
            stack.pop()
        elif name == "ADD":
            a, b = stack.pop(), stack.pop()
            stack.append((a + b) & MASK)
        elif name == "SUB":
            a, b = stack.pop(), stack.pop()
            stack.append((a - b) & MASK)
        elif name == "MUL":
            a, b = stack.pop(), stack.pop()
            stack.append((a * b) & MASK)
        elif name == "DIV":
            a, b = stack.pop(), stack.pop()
            stack.append(0 if b == 0 else a // b)
        elif name == "SDIV":
            a, b = stack.pop(), stack.pop()
            if b == 0:
                stack.append(0)
            else:
                sa, sb = _c_signed(a), _c_signed(b)
                quotient = abs(sa) // abs(sb)
                if (sa < 0) != (sb < 0):
                    quotient = -quotient
                stack.append(quotient & MASK)
        elif name == "MOD":
            a, b = stack.pop(), stack.pop()
            stack.append(0 if b == 0 else a % b)
        elif name == "SMOD":
            a, b = stack.pop(), stack.pop()
            if b == 0:
                stack.append(0)
            else:
                sa, sb = _c_signed(a), _c_signed(b)
                remainder = abs(sa) % abs(sb)
                if sa < 0:
                    remainder = -remainder
                stack.append(remainder & MASK)
        elif name == "LT":
            a, b = stack.pop(), stack.pop()
            stack.append(1 if a < b else 0)
        elif name == "GT":
            a, b = stack.pop(), stack.pop()
            stack.append(1 if a > b else 0)
        elif name == "SLT":
            a, b = stack.pop(), stack.pop()
            stack.append(1 if _c_signed(a) < _c_signed(b) else 0)
        elif name == "SGT":
            a, b = stack.pop(), stack.pop()
            stack.append(1 if _c_signed(a) > _c_signed(b) else 0)
        elif name == "EQ":
            a, b = stack.pop(), stack.pop()
            stack.append(1 if a == b else 0)
        elif name == "ISZERO":
            stack.append(1 if stack.pop() == 0 else 0)
        elif name == "AND":
            a, b = stack.pop(), stack.pop()
            stack.append(a & b)
        elif name == "OR":
            a, b = stack.pop(), stack.pop()
            stack.append(a | b)
        elif name == "XOR":
            a, b = stack.pop(), stack.pop()
            stack.append(a ^ b)
        elif name == "NOT":
            stack.append(stack.pop() ^ MASK)
        elif name == "SHL":
            shift, value = stack.pop(), stack.pop()
            stack.append((value << shift) & MASK if shift < WORD else 0)
        elif name == "SHR":
            shift, value = stack.pop(), stack.pop()
            stack.append(value >> shift if shift < WORD else 0)
        elif name == "SAR":
            shift, value = stack.pop(), stack.pop()
            signed = _c_signed(value)
            stack.append((signed >> min(shift, WORD - 1)) & MASK)
        elif name == "MLOAD":
            offset = stack.pop()
            word = 0
            for i in range(32):
                word = (word << 8) | mem.get((offset + i) & MASK, 0)
            stack.append(word)
        elif name == "MSTORE":
            offset, value = stack.pop(), stack.pop()
            for i in range(32):
                mem[(offset + i) & MASK] = (value >> (8 * (31 - i))) & 0xFF
        elif name == "MSTORE8":
            offset, value = stack.pop(), stack.pop()
            mem[offset] = value & 0xFF
        elif name == "SLOAD":
            stack.append(sto.get(stack.pop(), 0))
        elif name == "SSTORE":
            key, value = stack.pop(), stack.pop()
            sto[key] = value
        else:
            raise ValueError(f"concrete_run cannot execute {name}")

    return list(reversed(stack)), mem, sto


def differ_concretely(original: List[BodyOp], candidate: List[BodyOp],
                      env: Tuple[List[int], Dict[int, int], Dict[int, int]]
                      ) -> bool:
    """True when one concrete environment distinguishes the two bodies.

    Memory/storage comparison normalizes away explicitly-written default
    values so a rewrite that skips writing a cell the original sets to
    its implicit 0 still compares equal.
    """
    stack_a, mem_a, sto_a = concrete_run(original, *env)
    stack_b, mem_b, sto_b = concrete_run(candidate, *env)
    if stack_a != stack_b:
        return True
    if _nonzero(mem_a) != _nonzero(mem_b):
        return True
    return _nonzero(sto_a) != _nonzero(sto_b)


def _nonzero(cells: Dict[int, int]) -> Dict[int, int]:
    return {k: v for k, v in cells.items() if v != 0}


def random_env(rng, depth: int, interesting: Tuple[int, ...] = ()
               ) -> Tuple[List[int], Dict[int, int], Dict[int, int]]:
    """One random concrete entry environment for differential replay.

    Half the stack slots are drawn from a boundary-value pool (0, 1,
    small, MASK, sign bit, plus block constants) because uniform random
    256-bit words essentially never hit the x==0 / x==2^255 edges where
    DIV/SDIV/SMOD rewrites actually break.
    """
    pool = (0, 1, 2, 31, 32, 255, MASK, 1 << 255, (1 << 255) - 1) + interesting
    stack = [rng.choice(pool) if rng.random() < 0.5
             else rng.getrandbits(WORD) for _ in range(depth)]
    memory = {rng.randrange(0, 512): rng.getrandbits(8) for _ in range(8)}
    storage = {rng.choice(pool) & MASK: rng.getrandbits(WORD)
               for _ in range(4)}
    return stack, memory, storage
