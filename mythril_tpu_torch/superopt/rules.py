"""Candidate-rewrite enumeration: the peephole catalog plus bounded
exhaustive stack-scheduling search.

Every rule proposes a *full replacement body* for a basic-block body
(terminator excluded); nothing here is trusted — each distinct candidate
becomes an equivalence obligation the engine discharges through the
solver stack. Rules therefore only have to be *plausible*, and the
catalog leans on a cheap concrete screen (a handful of seeded random
environments) to avoid wasting proof obligations on junk.

Two enumeration tiers:

* the **catalog** — windowed rewrites: generic constant folding (any
  entry-independent window collapses to pushes of its concrete result),
  identity/shuffle elision (PUSH 0 ADD, SWAPn SWAPn, PUSH/DUP POP,
  SWAP1 before a commutative op), strength reduction (MUL / SWAP1 DIV /
  SWAP1 MOD by a power of two into SHL / SHR / AND — these survive the
  term IR's constant folder, so they are the rules that generate *real*
  SAT queries for the batched prover), dead-store elision
  (back-to-back MSTORE/SSTORE to the same constant address), and PUSH0
  minimization (the only PUSH narrowing that changes static gas);
* **exhaustive search** — for short pure-stack bodies (length bounded by
  the engine's `max_block_len`), iterative-deepening enumeration
  of strictly shorter instruction sequences over an alphabet derived
  from the body, height-delta pruned, concretely screened, and capped
  by the engine's `candidates_budget` total sequences tried.

Deterministic by construction: the screen RNG is fixed-seed and the
search order is the sorted alphabet, so repeat runs propose identical
candidates (the verdict cache then makes repeat proofs free).

The port's copy of mythril_tpu/superopt/rules.py.
"""

from __future__ import annotations

import random
from typing import Iterator, List, Optional, Sequence, Set, Tuple

from .encode import (BodyOp, MASK, concrete_run, differ_concretely,
                     is_encodable, random_env)

#: ops a constant-folding window may contain (entry-independent compute)
_FOLDABLE = frozenset(
    ["ADD", "SUB", "MUL", "DIV", "SDIV", "MOD", "SMOD",
     "LT", "GT", "SLT", "SGT", "EQ", "ISZERO",
     "AND", "OR", "XOR", "NOT", "SHL", "SHR", "SAR", "PUSH0"]
    + [f"PUSH{i}" for i in range(1, 33)]
)

_COMMUTATIVE = frozenset({"ADD", "MUL", "AND", "OR", "XOR", "EQ"})

#: x OP 0 == x with 0 on top of the stack (PUSH 0; OP)
_ZERO_IDENTITY = frozenset({"ADD", "OR", "XOR"})

_SCREEN_ENVS = 8
_SCREEN_DEPTH = 20
_SCREEN_SEED = 0x5EED


def push_of(value: int) -> BodyOp:
    """Cheapest PUSH encoding a constant: PUSH0 for zero (2 gas instead
    of 3), else the narrowest PUSHn."""
    value &= MASK
    if value == 0:
        return ("PUSH0", None)
    width = max(1, (value.bit_length() + 7) // 8)
    return (f"PUSH{width}", value)


def _push_value(op: BodyOp) -> Optional[int]:
    name, imm = op
    if name == "PUSH0":
        return 0
    if name.startswith("PUSH"):
        return (imm or 0) & MASK
    return None


def _is_pow2(value: int) -> Optional[int]:
    if value > 0 and value & (value - 1) == 0:
        return value.bit_length() - 1
    return None


def _cand(body: Sequence[BodyOp], rule: str) -> Tuple[Tuple[BodyOp, ...], str]:
    return (tuple(body), rule)


def _splice(body: Sequence[BodyOp], start: int, length: int,
            replacement: Sequence[BodyOp]) -> Tuple[BodyOp, ...]:
    return tuple(body[:start]) + tuple(replacement) + tuple(body[start + length:])


# ---------------------------------------------------------------------------------
# Catalog rules — each yields (replacement_window, rule_name, window_len) at `i`
# ---------------------------------------------------------------------------------

def _window_rewrites(body: Sequence[BodyOp], i: int
                     ) -> Iterator[Tuple[List[BodyOp], str, int]]:
    name, imm = body[i]
    nxt = body[i + 1][0] if i + 1 < len(body) else None

    # PUSH minimization: any wide encoding of zero drops to PUSH0
    if name.startswith("PUSH") and name != "PUSH0" and _push_value(body[i]) == 0:
        yield [("PUSH0", None)], "push0_min", 1

    value = _push_value(body[i])
    if value is not None and nxt is not None:
        # identity elision: PUSH 0; ADD/OR/XOR and PUSH 1; MUL vanish
        if value == 0 and nxt in _ZERO_IDENTITY:
            yield [], "identity", 2
        if value == 1 and nxt == "MUL":
            yield [], "identity", 2
        # PUSH x; POP is dead
        if nxt == "POP":
            yield [], "push_pop", 2
        # strength reduction: constant power-of-two multiply -> shift
        shift = _is_pow2(value)
        if shift is not None and nxt == "MUL":
            yield [push_of(shift), ("SHL", None)], "strength_mul", 2
        # ... and the compiled divide/modulo-by-constant idiom
        # (PUSH c; SWAP1 puts the dividend back on top before DIV/MOD)
        if shift is not None and i + 2 < len(body) and nxt == "SWAP1":
            third = body[i + 2][0]
            if third == "DIV":
                yield [push_of(shift), ("SHR", None)], "strength_div", 3
            if third == "MOD":
                yield [push_of(value - 1), ("AND", None)], "strength_mod", 3

    # shuffle elision
    if name.startswith("SWAP") and nxt == name:
        yield [], "swap_swap", 2
    if name.startswith("SWAP") and imm is None and name == "SWAP1" \
            and nxt in _COMMUTATIVE:
        yield [(nxt, None)], "swap_commutative", 2
    if name.startswith("DUP") and nxt == "POP":
        yield [], "dup_pop", 2

    # generic constant folding: the longest entry-independent window at i
    # that concretely executes from an empty stack collapses to pushes
    if name in _FOLDABLE and name.startswith("PUSH"):
        for length in range(2, min(6, len(body) - i) + 1):
            window = body[i:i + length]
            if any(op not in _FOLDABLE for op, _ in window):
                break
            try:
                stack, _, _ = concrete_run(list(window), [], {}, {})
            except IndexError:
                continue  # window reads the entry stack: not foldable
            folded = [push_of(v) for v in reversed(stack)]  # bottom-first
            if len(folded) < length:
                yield folded, "const_fold", length

    # dead store: PUSH v1; PUSH off; MSTORE; PUSH v2; PUSH off; MSTORE
    # (same constant offset, no intervening read) — first store is dead
    for store_op in ("MSTORE", "SSTORE"):
        if (i + 5 < len(body)
                and _push_value(body[i]) is not None
                and _push_value(body[i + 1]) is not None
                and body[i + 2][0] == store_op
                and _push_value(body[i + 3]) is not None
                and _push_value(body[i + 4]) == _push_value(body[i + 1])
                and body[i + 5][0] == store_op):
            yield list(body[i + 3:i + 6]), "dead_store", 6


def catalog_candidates(body: Sequence[BodyOp]
                       ) -> List[Tuple[Tuple[BodyOp, ...], str]]:
    """All single-window catalog rewrites of `body` (deduplicated)."""
    out: List[Tuple[Tuple[BodyOp, ...], str]] = []
    seen: Set[Tuple[BodyOp, ...]] = {tuple(body)}
    for i in range(len(body)):
        for replacement, rule, length in _window_rewrites(body, i):
            candidate = _splice(body, i, length, replacement)
            if candidate not in seen:
                seen.add(candidate)
                out.append(_cand(candidate, rule))
    return out


# ---------------------------------------------------------------------------------
# Bounded exhaustive stack-scheduling search
# ---------------------------------------------------------------------------------

_PURE_STACK = frozenset(
    ["ADD", "SUB", "MUL", "DIV", "SDIV", "MOD", "SMOD",
     "LT", "GT", "SLT", "SGT", "EQ", "ISZERO",
     "AND", "OR", "XOR", "NOT", "SHL", "SHR", "SAR",
     "POP", "PUSH0"]
    + [f"PUSH{i}" for i in range(1, 33)]
    + [f"DUP{i}" for i in range(1, 17)]
    + [f"SWAP{i}" for i in range(1, 17)]
)


def _height_delta(op: BodyOp) -> int:
    name, _ = op
    if name.startswith("PUSH"):
        return 1
    if name.startswith("DUP"):
        return 1
    if name.startswith("SWAP"):
        return 0
    if name in ("POP",):
        return -1
    if name in ("ISZERO", "NOT"):
        return 0
    return -1  # every binary op


def _search_alphabet(body: Sequence[BodyOp]) -> List[BodyOp]:
    """Instruction alphabet derived from the body: its constants, its
    operators, and small-depth stack plumbing."""
    alphabet: Set[BodyOp] = {("POP", None), ("PUSH0", None)}
    for op in body:
        value = _push_value(op)
        if value is not None:
            alphabet.add(push_of(value))
        else:
            alphabet.add(op)
    for depth in range(1, 4):
        alphabet.add((f"DUP{depth}", None))
        alphabet.add((f"SWAP{depth}", None))
    return sorted(alphabet)


def search_candidates(body: Sequence[BodyOp], max_block_len: int,
                      budget: int) -> Tuple[List[Tuple[Tuple[BodyOp, ...], str]], int]:
    """Iterative-deepening exhaustive search for strictly shorter
    equivalent-looking sequences. Returns (candidates, sequences_tried).

    Only pure-stack bodies are searched (a memory/storage write in the
    body makes the space explode and the catalog covers those), pruned
    by net-height reachability and screened on fixed-seed random
    environments; survivors still go through the full symbolic proof.
    """
    if len(body) > max_block_len or not body:
        return [], 0
    if any(name not in _PURE_STACK for name, _ in body):
        return [], 0

    rng = random.Random(_SCREEN_SEED)
    depth = max(_SCREEN_DEPTH, 17 + 2 * len(body))
    envs = [random_env(rng, depth,
                       tuple(v for v in (_push_value(op) for op in body)
                             if v is not None))
            for _ in range(_SCREEN_ENVS)]
    try:
        target_delta = _body_delta(body, envs[0])
    except IndexError:
        return [], 0

    alphabet = _search_alphabet(body)
    survivors: List[Tuple[Tuple[BodyOp, ...], str]] = []
    tried = 0
    body_t = tuple(body)

    for length in range(len(body)):
        prefix: List[BodyOp] = []

        def dfs(remaining: int, delta: int) -> bool:
            """Returns False when the budget ran out."""
            nonlocal tried
            if tried >= budget:
                return False
            if remaining == 0:
                tried += 1
                candidate = tuple(prefix)
                if candidate != body_t and not any(
                        differ_concretely(list(body), list(candidate), env)
                        for env in envs):
                    survivors.append(_cand(candidate, "search"))
                return True
            for op in alphabet:
                step = _height_delta(op)
                # net height must still be able to reach the target
                if abs(delta + step - target_delta) > remaining - 1:
                    continue
                prefix.append(op)
                ok = dfs(remaining - 1, delta + step)
                prefix.pop()
                if not ok:
                    return False
            return True

        if not dfs(length, 0):
            break

    return survivors, tried


def _body_delta(body: Sequence[BodyOp], env) -> int:
    entry, memory, storage = env
    stack, _, _ = concrete_run(list(body), entry, memory, storage)
    return len(stack) - len(entry)


# ---------------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------------

def enumerate_candidates(body: Sequence[BodyOp], max_block_len: int,
                         search_budget: int
                         ) -> Tuple[List[Tuple[Tuple[BodyOp, ...], str]], int]:
    """All screened candidate bodies for one block body, deduplicated,
    plus the exhaustive-search sequence count (for metrics)."""
    if not is_encodable(list(body)):
        return [], 0
    rng = random.Random(_SCREEN_SEED + 1)
    # 17 + 2*len bounds any body's entry-stack reach (SWAP16 peeks 17,
    # every op nets <= 2 pops), so the screen never underflows its envs
    depth = max(_SCREEN_DEPTH, 17 + 2 * len(body))
    envs = [random_env(rng, depth) for _ in range(_SCREEN_ENVS)]

    out: List[Tuple[Tuple[BodyOp, ...], str]] = []
    seen: Set[Tuple[BodyOp, ...]] = {tuple(body)}
    for candidate, rule in catalog_candidates(body):
        try:
            if any(differ_concretely(list(body), list(candidate), env)
                   for env in envs):
                continue  # a buggy rule application; screen it out
        except IndexError:
            continue
        if candidate not in seen:
            seen.add(candidate)
            out.append((candidate, rule))

    searched, tried = search_candidates(body, max_block_len, search_budget)
    for candidate, rule in searched:
        if candidate not in seen:
            seen.add(candidate)
            out.append((candidate, rule))
    return out, tried
