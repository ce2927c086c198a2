"""Statespace graph nodes/edges (capability parity: the Node/Edge model kept by
mythril/laser/ethereum/svm.py manage_cfg for --graph / --statespace-json).

The port's copy of mythril_tpu/core/node.py."""

from __future__ import annotations

from enum import Enum
from typing import Dict, List, Optional


class JumpType(Enum):
    CONDITIONAL = 1
    UNCONDITIONAL = 2
    CALL = 3
    RETURN = 4
    Transaction = 5


class NodeFlags(Enum):
    FUNC_ENTRY = 1
    CALL_RETURN = 2


class Node:
    _uid_counter = 0

    def __init__(self, contract_name: str, start_addr: int = 0,
                 constraints=None, function_name: str = "unknown"):
        self.contract_name = contract_name
        self.start_addr = start_addr
        self.states: List = []
        self.constraints = constraints if constraints is not None else []
        self.function_name = function_name
        self.flags: List[NodeFlags] = []
        Node._uid_counter += 1
        self.uid = Node._uid_counter

    def get_cfg_dict(self) -> Dict:
        code_lines = []
        for state in self.states:
            instruction = state.get_current_instruction()
            code_lines.append(f"{instruction['address']} {instruction['opcode']}"
                              + (f" {instruction.get('argument')}"
                                 if instruction.get("argument") else ""))
        return {
            "contract_name": self.contract_name,
            "start_addr": self.start_addr,
            "function_name": self.function_name,
            "code": "\\n".join(code_lines),
        }


class Edge:
    def __init__(self, node_from: int, node_to: int,
                 edge_type: JumpType = JumpType.UNCONDITIONAL, condition=None):
        self.node_from = node_from
        self.node_to = node_to
        self.type = edge_type
        self.condition = condition

    def __str__(self):
        return f"{self.node_from} -> {self.node_to}"
