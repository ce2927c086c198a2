"""The port's copy of mythril_tpu/analysis/modules/__init__.py."""

from .suicide import AccidentallyKillable
from .ether_thief import EtherThief
from .external_calls import ExternalCalls
from .dependence_on_origin import TxOrigin
from .dependence_on_predictable_vars import PredictableVariables
from .delegatecall import ArbitraryDelegateCall
from .arbitrary_jump import ArbitraryJump
from .arbitrary_write import ArbitraryStorage
from .exceptions import Exceptions
from .integer import IntegerArithmetics
from .multiple_sends import MultipleSends
from .requirements_violation import RequirementsViolation
from .state_change_external_calls import StateChangeAfterCall
from .transaction_order_dependence import TxOrderDependence
from .unchecked_retval import UncheckedRetval
from .unexpected_ether import UnexpectedEther
from .user_assertions import UserAssertions
from .ether_phishing import EtherPhishing

__all__ = [
    "AccidentallyKillable", "EtherThief", "ExternalCalls", "TxOrigin",
    "PredictableVariables", "ArbitraryDelegateCall", "ArbitraryJump",
    "ArbitraryStorage", "Exceptions", "IntegerArithmetics", "MultipleSends",
    "RequirementsViolation", "StateChangeAfterCall", "TxOrderDependence",
    "UncheckedRetval", "UnexpectedEther", "UserAssertions", "EtherPhishing",
]
