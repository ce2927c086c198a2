"""Minimal Ethereum JSON-RPC client (capability parity:
mythril/ethereum/interface/rpc/client.py:30 — eth_getCode / eth_getStorageAt /
eth_getBalance / eth_getTransactionReceipt over HTTP(S), with the infura/
ganache presets the CLI accepts).

stdlib-only (urllib); no web3 dependency. Tests mock `_call`.

The port's copy of mythril_tpu/ethereum/rpc.py."""

from __future__ import annotations

import json
import urllib.request
from typing import Any, List, Optional

JSON_MEDIA_TYPE = "application/json"


class RPCError(Exception):
    pass


class EthJsonRpc:
    def __init__(self, host: str = "localhost", port: Optional[int] = 8545,
                 tls: bool = False):
        if host.startswith(("http://", "https://")):
            self.url = host if port is None else f"{host}:{port}"
        else:
            scheme = "https" if tls else "http"
            self.url = f"{scheme}://{host}" + (f":{port}" if port else "")
        self._id = 0

    @classmethod
    def from_preset(cls, rpc: str, rpctls: bool = False) -> "EthJsonRpc":
        """'ganache' | 'infura-<net>' | 'host:port' (reference
        mythril_config.py:121-210)."""
        if rpc == "ganache":
            return cls("localhost", 7545, rpctls)
        if rpc.startswith("infura-"):
            net = rpc[len("infura-"):]
            return cls(f"https://{net}.infura.io/v3/API_KEY", None, True)
        if ":" in rpc:
            host, port = rpc.rsplit(":", 1)
            return cls(host, int(port), rpctls)
        return cls(rpc, 8545, rpctls)

    # -- transport ---------------------------------------------------------------
    def _call(self, method: str, params: Optional[List[Any]] = None) -> Any:
        self._id += 1
        payload = json.dumps({"jsonrpc": "2.0", "method": method,
                              "params": params or [], "id": self._id}).encode()
        request = urllib.request.Request(
            self.url, data=payload,
            headers={"Content-Type": JSON_MEDIA_TYPE})
        try:
            with urllib.request.urlopen(request, timeout=30) as response:
                body = json.loads(response.read())
        except Exception as error:
            raise RPCError(f"RPC {method} failed: {error}") from error
        if "error" in body:
            raise RPCError(body["error"].get("message", str(body["error"])))
        return body.get("result")

    # -- methods -----------------------------------------------------------------
    @staticmethod
    def _addr(address) -> str:
        if isinstance(address, int):
            return "0x{:040x}".format(address)
        return address

    def eth_getCode(self, address, block: str = "latest") -> str:
        return self._call("eth_getCode", [self._addr(address), block])

    def eth_getStorageAt(self, address, position, block: str = "latest") -> str:
        if isinstance(position, int):
            position = hex(position)
        return self._call("eth_getStorageAt",
                          [self._addr(address), position, block])

    def eth_getBalance(self, address, block: str = "latest") -> int:
        return int(self._call("eth_getBalance",
                              [self._addr(address), block]), 16)

    def eth_getTransactionReceipt(self, tx_hash: str) -> dict:
        return self._call("eth_getTransactionReceipt", [tx_hash])

    def eth_blockNumber(self) -> int:
        return int(self._call("eth_blockNumber"), 16)

    def eth_coinbase(self) -> str:
        return self._call("eth_coinbase")

    def eth_getBlockByNumber(self, block="latest",
                             tx_objects: bool = True) -> dict:
        if isinstance(block, int):
            block = hex(block)
        return self._call("eth_getBlockByNumber", [block, tx_objects])

    def eth_getBlockByHash(self, block_hash: str,
                           tx_objects: bool = True) -> dict:
        return self._call("eth_getBlockByHash", [block_hash, tx_objects])

    def eth_getTransactionByHash(self, tx_hash: str) -> dict:
        return self._call("eth_getTransactionByHash", [tx_hash])

    def eth_getTransactionCount(self, address, block: str = "latest") -> int:
        return int(self._call("eth_getTransactionCount",
                              [self._addr(address), block]), 16)

    def eth_gasPrice(self) -> int:
        return int(self._call("eth_gasPrice"), 16)

    def eth_call(self, to, data: str = "0x", block: str = "latest") -> str:
        return self._call("eth_call",
                          [{"to": self._addr(to), "data": data}, block])

    def eth_estimateGas(self, transaction: dict) -> int:
        return int(self._call("eth_estimateGas", [transaction]), 16)

    def eth_sendRawTransaction(self, raw: str) -> str:
        return self._call("eth_sendRawTransaction", [raw])

    def net_version(self) -> str:
        return self._call("net_version")

    def web3_clientVersion(self) -> str:
        return self._call("web3_clientVersion")
