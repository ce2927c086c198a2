"""Issues and reports in four output formats (capability parity:
mythril/analysis/report.py — Issue:29 with source mapping + function-name
resolution, Report:262 with as_text/as_json/as_swc_standard_format/as_markdown).

Templates are generated in code rather than jinja2 (no template dependency).

The port's copy of mythril_tpu/analysis/report.py."""

from __future__ import annotations

import hashlib
import json
import logging
from typing import Dict, List, Optional

from ..support.signatures import SignatureDB
from ..utils.helpers import get_code_hash
from .swc_data import SWC_TO_TITLE

log = logging.getLogger(__name__)


class TransactionSequence(dict):
    """The initialState + steps witness dict (concolic ConcreteData schema)."""


class Issue:
    def __init__(self, contract: str, function_name: str, address: int,
                 swc_id: str, title: str, bytecode: str,
                 gas_used=(None, None), severity: str = "Medium",
                 description_head: str = "", description_tail: str = "",
                 transaction_sequence: Optional[Dict] = None):
        self.title = title
        self.contract = contract
        self.function = function_name
        self.address = address
        self.description_head = description_head
        self.description_tail = description_tail
        self.description = f"{description_head}\n{description_tail}".strip()
        self.severity = severity
        self.swc_id = swc_id
        self.min_gas_used, self.max_gas_used = gas_used
        self.bytecode = bytecode
        self.filename = None
        self.code = None
        self.lineno = None
        self.source_mapping = None
        self.discovery_time = 0.0
        self.bytecode_hash = get_code_hash(bytecode) if bytecode else "0x"
        self.transaction_sequence = transaction_sequence
        self.source_location = None

    @property
    def transaction_sequence_users(self):
        """Witness with symbolic senders resolved to actor names."""
        return self.transaction_sequence

    @property
    def as_dict(self) -> Dict:
        issue = {
            "title": self.title,
            "swc-id": self.swc_id,
            "contract": self.contract,
            "description": self.description,
            "function": self.function,
            "severity": self.severity,
            "address": self.address,
            "tx_sequence": self.transaction_sequence,
            "min_gas_used": self.min_gas_used,
            "max_gas_used": self.max_gas_used,
            "sourceMap": self.source_mapping,
        }
        if self.filename and self.lineno:
            issue["filename"] = self.filename
            issue["lineno"] = self.lineno
        if self.code:
            issue["code"] = self.code
        return issue

    def resolve_function_name(self) -> None:
        """4-byte-based function-name resolution from the witness calldata
        (reference report.py:190-248)."""
        if self.transaction_sequence is None:
            return
        steps = self.transaction_sequence.get("steps", [])
        if not steps:
            return
        last_input = steps[-1].get("input", "0x")
        if len(last_input) < 10:
            return
        selector = last_input[:10]
        if self.function and not self.function.startswith("_function_"):
            return
        matches = SignatureDB().get(selector)
        if matches:
            self.function = matches[0]

    def add_code_info(self, contract) -> None:
        """Source mapping via the contract's solc srcmap (reference report.py:148)."""
        if self.address is None or not hasattr(contract, "get_source_info"):
            return
        is_constructor = self.function == "constructor"
        try:
            source_info = contract.get_source_info(self.address,
                                                   constructor=is_constructor)
        except Exception:
            return
        if source_info is None:
            return
        self.filename = source_info.filename
        self.code = source_info.code
        self.lineno = source_info.lineno
        self.source_mapping = f"{self.address}"


class Report:
    environment: Dict = {}

    def __init__(self, contracts=None, exceptions=None,
                 execution_info: Optional[List] = None):
        self.issues: Dict[bytes, Issue] = {}
        self.solc_version = ""
        self.meta: Dict = {}
        self.source = contracts
        self.exceptions = exceptions or []
        self.execution_info = execution_info or []
        #: the global analysis deadline fired and the frontier was drained
        #: gracefully: issues found so far are valid, but exploration is
        #: partial (core/svm.py graceful drain)
        self.incomplete = False
        #: coverage stats accompanying an incomplete report (executed nodes,
        #: explored/dropped state counts, transactions reached)
        self.coverage: Dict = {}

    def sorted_issues(self) -> List[Dict]:
        return [issue.as_dict for key, issue in
                sorted(self.issues.items(), key=lambda kv: kv[1].address)]

    def append_issue(self, issue: Issue) -> None:
        disambiguator = f"{issue.swc_id}-{issue.title}-{issue.address}-{issue.function}"
        key = hashlib.md5(disambiguator.encode()).digest()
        self.issues[key] = issue

    # -- formats --------------------------------------------------------------------
    def _incomplete_banner(self) -> str:
        stats = ", ".join(f"{key}: {value}" for key, value
                          in self.coverage.items())
        return ("==== INCOMPLETE ANALYSIS ====\n"
                "The analysis deadline expired before exploration finished; "
                "the results below are valid but partial.\n"
                + (f"Coverage: {stats}\n" if stats else ""))

    def as_text(self) -> str:
        if not self.issues:
            if self.incomplete:
                return self._incomplete_banner() + \
                    "No issues were detected in the explored portion.\n"
            return "The analysis was completed successfully. " \
                   "No issues were detected.\n"
        blocks = []
        if self.incomplete:
            blocks.append(self._incomplete_banner())
        for issue in (issue for _, issue in
                      sorted(self.issues.items(), key=lambda kv: kv[1].address)):
            lines = [
                f"==== {issue.title} ====",
                f"SWC ID: {issue.swc_id}",
                f"Severity: {issue.severity}",
                f"Contract: {issue.contract}",
                f"Function name: {issue.function}",
                f"PC address: {issue.address}",
                f"Estimated Gas Usage: {issue.min_gas_used} - {issue.max_gas_used}",
                issue.description,
            ]
            if issue.filename and issue.lineno:
                lines.append(f"--------------------\nIn file: "
                             f"{issue.filename}:{issue.lineno}")
            if issue.code:
                lines.append(f"\n{issue.code}\n--------------------")
            if issue.transaction_sequence:
                lines.append("\nTransaction Sequence:\n")
                lines.append(self._format_tx_sequence(issue.transaction_sequence))
            blocks.append("\n".join(lines))
        return "\n\n".join(blocks) + "\n"

    @staticmethod
    def _format_tx_sequence(sequence: Dict) -> str:
        out = []
        for index, step in enumerate(sequence.get("steps", [])):
            kind = "CREATE" if step.get("address", "") == "" else "CALL"
            line = (f"Caller: [{step.get('origin', '?')}], "
                    f"function: {step.get('name', 'unknown')}, "
                    f"txdata: {step.get('input', '0x')}, "
                    f"value: {step.get('value', '0x0')}")
            out.append(f"{index}: {kind} {line}")
        return "\n".join(out)

    def as_json(self) -> str:
        result = {"success": True, "error": None, "issues": self.sorted_issues()}
        if self.incomplete:
            result["incomplete"] = True
            result["coverage"] = self.coverage
        if self.execution_info:
            result["extra"] = {
                "execution_info": [info.as_dict() for info in self.execution_info]}
        return json.dumps(result, default=str)

    def as_swc_standard_format(self) -> str:
        """jsonv2: SWC standard format with testCases (reference report.py:352)."""
        issues_grouped = []
        for _, issue in sorted(self.issues.items(), key=lambda kv: kv[1].address):
            entry = {
                "swcID": f"SWC-{issue.swc_id}",
                "swcTitle": SWC_TO_TITLE.get(issue.swc_id, ""),
                "description": {
                    "head": issue.description_head,
                    "tail": issue.description_tail,
                },
                "severity": issue.severity,
                "locations": [{"bytecodeOffset": issue.address}],
                "extra": {},
            }
            if issue.transaction_sequence:
                entry["extra"]["testCases"] = [issue.transaction_sequence]
            issues_grouped.append(entry)
        result = [{
            "issues": issues_grouped,
            "sourceType": "raw-bytecode",
            "sourceFormat": "evm-byzantium-bytecode",
            "sourceList": [issue.bytecode_hash
                           for _, issue in self.issues.items()][:1],
            "meta": self.meta,
        }]
        return json.dumps(result, default=str)

    def as_markdown(self) -> str:
        if not self.issues:
            return "# Analysis results\n\nThe analysis was completed " \
                   "successfully. No issues were detected.\n"
        blocks = ["# Analysis results"]
        for _, issue in sorted(self.issues.items(), key=lambda kv: kv[1].address):
            block = [
                f"## {issue.title}",
                f"- SWC ID: {issue.swc_id}",
                f"- Severity: {issue.severity}",
                f"- Contract: {issue.contract}",
                f"- Function name: `{issue.function}`",
                f"- PC address: {issue.address}",
                f"- Estimated Gas Usage: {issue.min_gas_used} - {issue.max_gas_used}",
                "",
                "### Description",
                issue.description,
            ]
            if issue.filename and issue.lineno:
                block.append(f"\nIn file: {issue.filename}:{issue.lineno}")
            blocks.append("\n".join(block))
        return "\n\n".join(blocks) + "\n"
