"""Function-signature database: 4-byte selector -> canonical text signature(s).

Capability parity: mythril/support/signatures.py:117 (SQLite DB at
~/.mythril/signatures.db, optional 4byte.directory online lookup, solidity-file
import). This build keeps the same surface but (a) seeds from a small built-in table of
ubiquitous signatures rather than a shipped binary DB, (b) supports learning signatures
from any ABI/signature list the user supplies, (c) gates online lookup behind a flag
(the build environment has no egress, so it fails soft).

The port's own copy of the JAX package's module. Its default store is the
port's own: one SQLite database in the process's memory, seeded from the
built-in table and shared by every thread (pass `path` for a file).
"""

from __future__ import annotations

import json
import re
import sqlite3
import threading
from typing import List

from ..utils.keccak import keccak256_py as keccak256

_COMMON_SIGNATURES = [
    "transfer(address,uint256)", "transferFrom(address,address,uint256)",
    "approve(address,uint256)", "balanceOf(address)", "totalSupply()",
    "allowance(address,address)", "owner()", "name()", "symbol()", "decimals()",
    "mint(address,uint256)", "burn(uint256)", "withdraw()", "withdraw(uint256)",
    "deposit()", "kill()", "destroy()", "transferOwnership(address)",
    "fallback()", "pause()", "unpause()", "setOwner(address)", "init()",
    "initialize()", "getBalance()", "sendTo(address,uint256)", "claim()",
    "killbilly()", "activatekillability()", "commencekilling()", "isKillable()",
    "batchTransfer(address[],uint256)", "safeTransferFrom(address,address,uint256)",
]


#: the default store: an in-memory database shared by the process's
#: connections (SQLite URI, shared cache)
DEFAULT_DB = "file:mythril_tpu_torch_signatures?mode=memory&cache=shared"


_SCHEMA = ("CREATE TABLE IF NOT EXISTS signatures "
           "(byte_sig VARCHAR(10), text_sig VARCHAR(255), "
           "PRIMARY KEY (byte_sig, text_sig))")


class SignatureDB:
    """Thread-safe selector<->signature store, shared per-process (singleton-ish)."""

    _instance = None
    _lock = threading.Lock()

    def __new__(cls, enable_online_lookup: bool | None = None, path: str | None = None):
        if path is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = super().__new__(cls)
                return cls._instance
        return super().__new__(cls)

    def __init__(self, enable_online_lookup: bool | None = None, path: str | None = None):
        if getattr(self, "_initialized", False) and path is None:
            # singleton re-construction: only an EXPLICIT flag changes the setting
            if enable_online_lookup is not None:
                self.enable_online_lookup = enable_online_lookup
            return
        self.enable_online_lookup = bool(enable_online_lookup)
        self.path = path or DEFAULT_DB
        self._local = threading.local()
        self._conn  # noqa: B018  (opens, creates and seeds the store)
        self._initialized = True

    @property
    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path, uri=True)
            self._local.conn = conn
            # every thread's first connection: the shared in-memory store
            # lives only while one of its connections is open
            self._ensure_schema(conn)
        return conn

    def _ensure_schema(self, conn: sqlite3.Connection) -> None:
        with conn:
            conn.execute(_SCHEMA)
        if not conn.execute("SELECT 1 FROM signatures LIMIT 1").fetchone():
            for sig in _COMMON_SIGNATURES:
                self.add(self.get_sighash(sig), sig)

    @staticmethod
    def get_sighash(text_signature: str) -> str:
        return "0x" + keccak256(text_signature.encode())[:4].hex()

    def add(self, byte_sig: str, text_sig: str) -> None:
        with self._conn as conn:
            conn.execute("INSERT OR IGNORE INTO signatures VALUES (?, ?)",
                         (byte_sig.lower(), text_sig))

    def get(self, byte_sig: str) -> List[str]:
        byte_sig = byte_sig.lower()
        if not byte_sig.startswith("0x"):
            byte_sig = "0x" + byte_sig
        rows = self._conn.execute(
            "SELECT text_sig FROM signatures WHERE byte_sig = ?", (byte_sig,)).fetchall()
        results = [row[0] for row in rows]
        if not results and self.enable_online_lookup:
            results = self._online_lookup(byte_sig)
            for sig in results:
                self.add(byte_sig, sig)
        return results

    def __getitem__(self, item: str) -> List[str]:
        return self.get(item)

    def _online_lookup(self, byte_sig: str) -> List[str]:
        """4byte.directory lookup; fails soft (no egress in this environment)."""
        try:
            import urllib.request

            url = f"https://www.4byte.directory/api/v1/signatures/?hex_signature={byte_sig}"
            with urllib.request.urlopen(url, timeout=2) as response:
                payload = json.load(response)
            return [entry["text_signature"] for entry in payload.get("results", [])]
        except Exception:
            return []

    def import_solidity_file(self, file_path: str) -> None:
        """Harvest `function name(args)` declarations from a solidity source file."""
        pattern = re.compile(r"function\s+(\w+)\s*\(([^)]*)\)")
        with open(file_path, errors="ignore") as handle:
            source = handle.read()
        for name, args in pattern.findall(source):
            arg_types = []
            for arg in args.split(","):
                arg = arg.strip()
                if not arg:
                    continue
                base_type = arg.split()[0]
                base_type = {"uint": "uint256", "int": "int256", "byte": "bytes1"}.get(
                    base_type, base_type)
                arg_types.append(base_type)
            canonical = f"{name}({','.join(arg_types)})"
            self.add(self.get_sighash(canonical), canonical)

    def import_abi(self, abi: list) -> None:
        for entry in abi:
            if entry.get("type") != "function":
                continue
            types = ",".join(inp["type"] for inp in entry.get("inputs", []))
            canonical = f"{entry['name']}({types})"
            self.add(self.get_sighash(canonical), canonical)
