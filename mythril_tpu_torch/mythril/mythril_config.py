"""Persistent configuration (capability parity: mythril/mythril/mythril_config.py:18
— ~/.mythril/config.ini with an [defaults] RPC section, env overrides, and
`set_api_rpc*` helpers that build the JSON-RPC client).

The port's copy of mythril_tpu/mythril/mythril_config.py: the
`MYTHRIL_TPU_DIR` read is the `mythril_dir` keyword's default and the
`MYTHRIL_TPU_RPC` read `set_api_rpc`'s `default_rpc`, both None."""

from __future__ import annotations

import configparser
import logging
from pathlib import Path
from typing import Optional

from ..ethereum.rpc import EthJsonRpc

log = logging.getLogger(__name__)


class MythrilConfig:
    def __init__(self, config_path: Optional[str] = None,
                 mythril_dir: Optional[str] = None):
        self.mythril_dir = Path(mythril_dir) if mythril_dir else \
            Path.home() / ".mythril-tpu"
        self.config_path = Path(config_path) if config_path else \
            self.mythril_dir / "config.ini"
        self.config = configparser.ConfigParser()
        self.eth: Optional[EthJsonRpc] = None
        self._load()

    def _load(self) -> None:
        if self.config_path.exists():
            self.config.read(self.config_path)
        if not self.config.has_section("defaults"):
            self.config.add_section("defaults")

    def save(self) -> None:
        self.mythril_dir.mkdir(parents=True, exist_ok=True)
        with open(self.config_path, "w") as handle:
            self.config.write(handle)

    # -- RPC selection ---------------------------------------------------------------
    def set_api_rpc(self, rpc: Optional[str] = None, rpctls: bool = False,
                    default_rpc: Optional[str] = None) -> None:
        """The client of `rpc`, else of `default_rpc`, else of config.ini's
        `dynamic_loading`, else of infura-mainnet."""
        rpc = rpc or default_rpc or \
            self.config.get("defaults", "dynamic_loading",
                            fallback="infura-mainnet")
        self.eth = EthJsonRpc.from_preset(rpc, rpctls)
        log.info("using RPC endpoint %s", self.eth.url)

    def set_api_rpc_infura(self, network: str = "mainnet") -> None:
        self.set_api_rpc(f"infura-{network}")

    def set_api_rpc_localhost(self) -> None:
        self.set_api_rpc("localhost:8545")
