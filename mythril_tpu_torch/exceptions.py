"""Framework-wide exception hierarchy (capability parity: mythril/exceptions.py).

The port's copy of mythril_tpu/exceptions.py, with `DeviceUnavailable`
added (the port's entry points run on the CUDA card and raise it when there
is none).
"""


class MythrilTpuBaseException(Exception):
    """Base for all framework exceptions."""


class CompilerError(MythrilTpuBaseException):
    """Solidity compiler (solc) invocation failed or solc unavailable."""


class UnsatError(MythrilTpuBaseException):
    """Constraint system proven unsatisfiable (or no model found in budget)."""


class SolverTimeOutException(UnsatError):
    """Solver exceeded its per-query time budget."""


class NoContractFoundError(MythrilTpuBaseException):
    """Input did not contain a contract."""


class CriticalError(MythrilTpuBaseException):
    """Unrecoverable user-facing error (bad arguments, missing inputs)."""


class AddressNotFoundError(MythrilTpuBaseException):
    """On-chain address lookup failed."""


class DetectorNotFoundError(MythrilTpuBaseException):
    """Unknown detection-module name."""


class IllegalArgumentError(ValueError, MythrilTpuBaseException):
    """Bad argument to a framework API."""


class DeviceUnavailable(RuntimeError):
    """The CUDA card was asked for and there is none."""
