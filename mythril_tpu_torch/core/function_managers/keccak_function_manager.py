"""Keccak-256 modeled as per-width uninterpreted functions with inverse functions and
disjoint output intervals (capability parity:
mythril/laser/ethereum/function_managers/keccak_function_manager.py:25 — the
VerX-style interval-partition encoding with hash%64==0 spreading and lazy
per-application conditions returned by create_conditions).

Concrete inputs hash concretely (utils.keccak); symbolic inputs get:
  keccak_inverse_N(keccak_N(x)) == x  (injectivity)
  lower_bound(width) <= keccak_N(x) < upper_bound(width), hash % 64 == 0
so hashes of different widths can never collide and storage-slot arithmetic over
hashes stays satisfiable.

The port's copy of mythril_tpu/core/function_managers/keccak_function_manager.py."""

from __future__ import annotations

from typing import Dict, List, Tuple

from ...smt import And, BitVec, Bool, Function, ULE, ULT, URem, symbol_factory
from ...utils.keccak import keccak256

TOTAL_PARTS = 10 ** 40
PART = (2 ** 256 - 1) // TOTAL_PARTS
INTERVAL_DIFFERENCE = 10 ** 30


class KeccakFunctionManager:
    hash_matcher = "fffffff"  # prefix marker used by witness back-substitution

    def __init__(self):
        self.store_function: Dict[int, Tuple[Function, Function]] = {}
        self.interval_hook_for_size: Dict[int, int] = {}
        self._index_counter = TOTAL_PARTS - 34534
        self.hash_result_store: Dict[int, List[BitVec]] = {}
        self.quick_inverse: Dict[BitVec, BitVec] = {}  # hash expr -> input expr
        self.concrete_hashes: Dict[BitVec, BitVec] = {}
        self.symbolic_inputs: Dict[int, List[BitVec]] = {}

    def reset(self) -> None:
        self.__init__()

    @staticmethod
    def find_concrete_keccak(data: BitVec) -> BitVec:
        keccak = symbol_factory.BitVecVal(
            int.from_bytes(
                keccak256(data.value.to_bytes(data.size() // 8, "big")), "big"), 256)
        return keccak

    def get_function(self, length: int) -> Tuple[Function, Function]:
        try:
            return self.store_function[length]
        except KeyError:
            func = Function(f"keccak256_{length}", [length], 256)
            inverse = Function(f"keccak256_{length}-1", [256], length)
            self.store_function[length] = (func, inverse)
            self.hash_result_store[length] = []
            return func, inverse

    def create_keccak(self, data: BitVec) -> BitVec:
        length = data.size()
        func, _ = self.get_function(length)
        if data.raw.is_const:
            concrete = self.find_concrete_keccak(data)
            self.concrete_hashes[data] = concrete
            return concrete
        result = func(data)
        self.hash_result_store[length].append(result)
        self.quick_inverse[result] = data
        self.symbolic_inputs.setdefault(length, []).append(data)
        return result

    def _get_interval(self, length: int) -> Tuple[int, int]:
        try:
            index = self.interval_hook_for_size[length]
        except KeyError:
            self.interval_hook_for_size[length] = self._index_counter
            index = self._index_counter
            self._index_counter -= INTERVAL_DIFFERENCE
        lower = index * PART
        upper = lower + PART
        return lower, upper

    def create_conditions(self) -> List[Bool]:
        """Lazy per-application axioms, appended to every constraint set via
        Constraints.get_all_constraints (reference state/constraints.py:76-79)."""
        conditions: List[Bool] = []
        for length, (func, inverse) in self.store_function.items():
            lower, upper = self._get_interval(length)
            for symbolic_input in self.symbolic_inputs.get(length, []):
                hashed = func(symbolic_input)
                conditions.append(And(
                    inverse(hashed) == symbolic_input,
                    ULE(symbol_factory.BitVecVal(lower, 256), hashed),
                    ULT(hashed, symbol_factory.BitVecVal(upper, 256)),
                    URem(hashed, symbol_factory.BitVecVal(64, 256)) == 0,
                ))
        # concrete hashes participate in the same function so congruence holds
        for concrete_input, concrete_hash in self.concrete_hashes.items():
            func, _ = self.get_function(concrete_input.size())
            conditions.append(func(concrete_input) == concrete_hash)
        return conditions

    def get_concrete_hash_data(self, model) -> Dict[int, Dict[int, int]]:
        """For witness back-substitution: width -> {input_value: hash_value} under a
        model (reference analysis/solver.py:131 _replace_with_actual_sha support)."""
        concrete_hashes: Dict[int, Dict[int, int]] = {}
        for length, inputs in self.symbolic_inputs.items():
            concrete_hashes[length] = {}
            for symbolic_input in inputs:
                try:
                    input_value = model.eval(symbolic_input)
                except Exception:
                    continue
                concrete_hashes[length][input_value] = int.from_bytes(
                    keccak256(input_value.to_bytes(length // 8, "big")), "big")
        return concrete_hashes


keccak_function_manager = KeccakFunctionManager()
