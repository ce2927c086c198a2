"""Solidity frontend: solc standard-json driver + source-map decoding
(capability parity: mythril/solidity/soliditycontract.py:169 — compile,
creation+runtime srcmap decode, get_source_info; mythril/ethereum/util.py:43 —
the solc standard-json invocation).

Degrades gracefully: when no solc binary is on PATH
`get_contracts_from_file` raises `SolcNotFound` with a clear message, and `SolidityContract.from_standard_json` lets callers (and tests)
feed pre-compiled standard-json output directly.

The port's copy of mythril_tpu/frontends/solidity.py."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
from typing import Dict, Iterator, List, Optional

from .evmcontract import EVMContract

SOLC_SETTINGS = {
    "optimizer": {"enabled": False},
    "outputSelection": {
        "*": {"*": ["metadata", "evm.bytecode", "evm.deployedBytecode",
                    "evm.methodIdentifiers"],
              "": ["ast"]}},
}


class SolcError(Exception):
    pass


class SolcNotFound(SolcError):
    pass


def get_solc_json(file_path: str, solc_binary: str = "solc",
                  solc_settings_json: Optional[str] = None) -> Dict:
    """Compile with solc standard-json (reference ethereum/util.py:43)."""
    if shutil.which(solc_binary) is None:
        raise SolcNotFound(
            f"solc binary '{solc_binary}' not found on PATH; install solc or "
            "pass pre-compiled bytecode with -c / --bin")
    settings = dict(SOLC_SETTINGS)
    if solc_settings_json:
        with open(solc_settings_json) as handle:
            settings.update(json.load(handle))
    standard_input = {
        "language": "Solidity",
        "sources": {file_path: {"urls": [file_path]}},
        "settings": settings,
    }
    proc = subprocess.run(
        [solc_binary, "--standard-json", "--allow-paths", ".,/"],
        input=json.dumps(standard_input).encode(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    if proc.returncode:
        raise SolcError(f"solc exited {proc.returncode}: "
                        f"{proc.stderr.decode()[:500]}")
    output = json.loads(proc.stdout)
    errors = [e for e in output.get("errors", [])
              if e.get("severity") == "error"]
    if errors:
        raise SolcError("\n".join(e.get("formattedMessage", str(e))
                                  for e in errors))
    return output


class SourceMapping:
    """One decoded srcmap entry: byte range + source file + line + snippet."""

    __slots__ = ("offset", "length", "file_index", "filename", "lineno", "code")

    def __init__(self, offset: int, length: int, file_index: int,
                 filename: str = "", lineno: Optional[int] = None,
                 code: str = ""):
        self.offset = offset
        self.length = length
        self.file_index = file_index
        self.filename = filename
        self.lineno = lineno
        self.code = code


def decode_srcmap(srcmap: str) -> List[List[int]]:
    """'s:l:f:j;;...' with empty-field inheritance -> [[s, l, f], ...]."""
    entries: List[List[int]] = []
    prev = [0, 0, 0]
    for chunk in srcmap.split(";"):
        fields = chunk.split(":")
        entry = list(prev)
        for i in range(min(3, len(fields))):
            if fields[i] != "":
                entry[i] = int(fields[i])
        entries.append(entry)
        prev = entry
    return entries


class SolidityContract(EVMContract):
    """A compiled contract with source mapping."""

    def __init__(self, input_file: str, name: str, code: str,
                 creation_code: str, srcmap_runtime: str, srcmap_creation: str,
                 sources: Dict[int, str], source_texts: Dict[int, str]):
        super().__init__(code=code, creation_code=creation_code, name=name)
        self.input_file = input_file
        self.sources = sources              # file index -> path
        self.source_texts = source_texts    # file index -> contents
        self.srcmap = decode_srcmap(srcmap_runtime) if srcmap_runtime else []
        self.creation_srcmap = \
            decode_srcmap(srcmap_creation) if srcmap_creation else []
        #: per-function AST features for the RF tx prioritizer
        #: (reference soliditycontract.py:195)
        self.features = None

    @classmethod
    def from_standard_json(cls, output: Dict, input_file: str,
                           contract_name: Optional[str] = None
                           ) -> Iterator["SolidityContract"]:
        # file index -> path, from the AST ids solc assigns
        sources: Dict[int, str] = {}
        source_texts: Dict[int, str] = {}
        for path, desc in output.get("sources", {}).items():
            index = desc.get("id", len(sources))
            sources[index] = path
            text = None
            if os.path.exists(path):
                with open(path, errors="replace") as handle:
                    text = handle.read()
            source_texts[index] = text or ""
        for path, contracts in output.get("contracts", {}).items():
            for name, desc in contracts.items():
                if contract_name and name != contract_name:
                    continue
                evm = desc.get("evm", {})
                runtime = evm.get("deployedBytecode", {})
                creation = evm.get("bytecode", {})
                code = _strip_unlinked(runtime.get("object", ""))
                creation_code = _strip_unlinked(creation.get("object", ""))
                if not code:
                    continue
                contract = cls(input_file=input_file, name=name, code=code,
                               creation_code=creation_code,
                               srcmap_runtime=runtime.get("sourceMap", ""),
                               srcmap_creation=creation.get("sourceMap", ""),
                               sources=sources, source_texts=source_texts)
                ast = output.get("sources", {}).get(path, {}).get("ast")
                if ast:
                    from .features import SolidityFeatureExtractor

                    contract.features = \
                        SolidityFeatureExtractor(ast).extract_features()
                yield contract

    # -- issue source mapping -----------------------------------------------------
    def get_source_info(self, address: int, constructor: bool = False):
        """bytecode address -> (filename, lineno, code snippet) or None."""
        disassembly = self.creation_disassembly if constructor \
            else self.disassembly
        srcmap = self.creation_srcmap if constructor else self.srcmap
        index = None
        for i, instruction in enumerate(disassembly.instruction_list):
            if instruction.address == address:
                index = i
                break
        if index is None or index >= len(srcmap):
            return None
        offset, length, file_index = srcmap[index]
        if file_index < 0 or file_index not in self.sources:
            return None
        text = self.source_texts.get(file_index) or ""
        lineno = text.count("\n", 0, offset) + 1 if text else None
        code = text[offset:offset + length] if text else ""
        return SourceMapping(offset, length, file_index,
                             filename=self.sources.get(file_index, ""),
                             lineno=lineno, code=code)

    @property
    def filename(self) -> str:
        return self.input_file


def _strip_unlinked(bytecode: str) -> str:
    """Library placeholders (__$...$__) are not hex; zero them so the
    disassembler can proceed."""
    return bytecode.replace("_", "0").replace("$", "0")


def get_contracts_from_file(input_file: str, solc_binary: str = "solc",
                            solc_settings_json: Optional[str] = None,
                            name: Optional[str] = None
                            ) -> Iterator[SolidityContract]:
    output = get_solc_json(input_file, solc_binary=solc_binary,
                           solc_settings_json=solc_settings_json)
    yield from SolidityContract.from_standard_json(output, input_file,
                                                   contract_name=name)


def get_contracts_from_foundry(project_root: str
                               ) -> Iterator[SolidityContract]:
    """Load forge build artifacts (reference soliditycontract.py:140)."""
    out_dir = os.path.join(project_root, "out")
    if not os.path.isdir(out_dir):
        raise SolcError(f"no foundry output directory at {out_dir}")
    for sol_dir in sorted(os.listdir(out_dir)):
        full = os.path.join(out_dir, sol_dir)
        if not os.path.isdir(full):
            continue
        for artifact in sorted(os.listdir(full)):
            if not artifact.endswith(".json"):
                continue
            with open(os.path.join(full, artifact)) as handle:
                data = json.load(handle)
            runtime = data.get("deployedBytecode", {})
            creation = data.get("bytecode", {})
            code = _strip_unlinked(
                (runtime.get("object", "") or "").replace("0x", "", 1))
            if not code:
                continue
            yield SolidityContract(
                input_file=os.path.join(sol_dir, artifact),
                name=os.path.splitext(artifact)[0], code=code,
                creation_code=_strip_unlinked(
                    (creation.get("object", "") or "").replace("0x", "", 1)),
                srcmap_runtime=runtime.get("sourceMap", ""),
                srcmap_creation=creation.get("sourceMap", ""),
                sources={}, source_texts={})
