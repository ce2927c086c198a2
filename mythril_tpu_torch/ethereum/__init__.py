"""On-chain access: JSON-RPC client + dynamic loader.

The port's copy of mythril_tpu/ethereum/__init__.py."""

from .rpc import EthJsonRpc, RPCError

__all__ = ["EthJsonRpc", "RPCError"]
