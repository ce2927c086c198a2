"""The port's copy of mythril_tpu/core/state/__init__.py."""

from .constraints import Constraints
from .calldata import (BaseCalldata, BasicConcreteCalldata, BasicSymbolicCalldata,
                       ConcreteCalldata, SymbolicCalldata)
from .memory import Memory
from .machine_state import MachineStack, MachineState
from .account import Account, Storage
from .environment import Environment
from .world_state import WorldState
from .global_state import GlobalState
from .return_data import ReturnData
from .annotation import StateAnnotation, MergeableStateAnnotation

__all__ = [
    "Constraints", "BaseCalldata", "ConcreteCalldata", "BasicConcreteCalldata",
    "SymbolicCalldata", "BasicSymbolicCalldata", "Memory", "MachineStack",
    "MachineState", "Account", "Storage", "Environment", "WorldState",
    "GlobalState", "ReturnData", "StateAnnotation", "MergeableStateAnnotation",
]
