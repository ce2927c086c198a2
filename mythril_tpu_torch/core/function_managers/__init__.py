"""The port's copy of mythril_tpu/core/function_managers/__init__.py."""

from .keccak_function_manager import KeccakFunctionManager, keccak_function_manager
from .exponent_function_manager import ExponentFunctionManager, exponent_function_manager

__all__ = ["KeccakFunctionManager", "keccak_function_manager",
           "ExponentFunctionManager", "exponent_function_manager"]
