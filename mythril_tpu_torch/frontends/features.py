"""Per-function feature extraction from the solc AST (capability parity:
mythril/solidity/features.py:4 SolidityFeatureExtractor).

Features feed the RF transaction prioritizer (core/tx_prioritiser.py): which
functions look dangerous (selfdestruct/delegatecall/call), which are payable,
which are owner-gated, and which variables their requires/modifiers guard.

The port's copy of mythril_tpu/frontends/features.py."""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Set, Tuple

TRANSFER_METHODS = ("transfer", "send")


class SolidityFeatureExtractor:
    def __init__(self, ast: dict):
        self.ast = ast or {}

    def extract_features(self) -> Dict[str, Dict]:
        function_features: Dict[str, Dict] = {}
        modifier_vars: Dict[str, Set[str]] = {}
        for modifier_node in self._walk_nodes(self.ast, "ModifierDefinition"):
            guarded = self.find_variables_in_require(modifier_node)
            guarded |= set(self.find_variables_in_if(modifier_node))
            modifier_vars[modifier_node.get("name", "")] = guarded

        for node in self._walk_nodes(self.ast, "FunctionDefinition"):
            require_vars = self.find_variables_in_require(node)
            for modifier in node.get("modifiers", []):
                name = modifier.get("modifierName", {}).get("name")
                if name in modifier_vars:
                    require_vars |= modifier_vars[name]
            function_features[node.get("name", "")] = {
                "contains_selfdestruct": self._contains(node, "selfdestruct"),
                "contains_call": self._contains(node, "call"),
                "is_payable": node.get("stateMutability") == "payable",
                "has_owner_modifier": self.has_owner_modifier(node),
                "contains_assert": self._contains(node, "assert"),
                "contains_callcode": self._contains(node, "callcode"),
                "contains_delegatecall": self._contains(node, "delegatecall"),
                "contains_staticcall": self._contains(node, "staticcall"),
                "all_require_vars": require_vars,
                "transfer_vars": self.extract_address_variable(node),
            }
        return function_features

    # -- AST helpers -----------------------------------------------------------------

    @staticmethod
    def _walk_nodes(node, node_type: str) -> Iterator[dict]:
        stack = [node]
        while stack:
            current = stack.pop()
            if isinstance(current, dict):
                if current.get("nodeType") == node_type:
                    yield current
                stack.extend(v for v in current.values()
                             if isinstance(v, (dict, list)))
            elif isinstance(current, list):
                stack.extend(current)

    @staticmethod
    def _contains(node, command: str) -> bool:
        stack = [node]
        while stack:
            current = stack.pop()
            if isinstance(current, dict):
                if command in current.values():
                    return True
                stack.extend(v for v in current.values()
                             if isinstance(v, (dict, list)))
            elif isinstance(current, list):
                stack.extend(current)
        return False

    @staticmethod
    def has_owner_modifier(node) -> bool:
        for modifier in node.get("modifiers", []):
            name = modifier.get("modifierName", {}).get("name", "")
            if name.lower() in ("isowner", "onlyowner"):
                return True
        return False

    @classmethod
    def _nodes_with_value(cls, node, command: str, parent=None
                          ) -> List[Tuple[Optional[dict], dict]]:
        found = []
        if isinstance(node, dict):
            if command in node.values():
                found.append((parent, node))
            for value in node.values():
                if isinstance(value, (dict, list)):
                    found.extend(cls._nodes_with_value(value, command,
                                                       parent=node))
        elif isinstance(node, list):
            for item in node:
                found.extend(cls._nodes_with_value(item, command, parent=node))
        return found

    @classmethod
    def _identifiers(cls, node) -> Set[str]:
        names: Set[str] = set()
        stack = [node]
        while stack:
            current = stack.pop()
            if isinstance(current, dict):
                if current.get("nodeType") == "Identifier" and "name" in current:
                    names.add(current["name"])
                stack.extend(v for v in current.values()
                             if isinstance(v, (dict, list)))
            elif isinstance(current, list):
                stack.extend(current)
        return names

    def find_variables_in_require(self, node) -> Set[str]:
        variables: Set[str] = set()
        for parent, _ in self._nodes_with_value(node, "require"):
            if parent and "arguments" in parent:
                for argument in parent["arguments"]:
                    variables |= self._identifiers(argument)
        return variables

    def find_variables_in_if(self, node) -> List[str]:
        variables: List[str] = []
        stack = [node]
        while stack:
            current = stack.pop()
            if isinstance(current, dict):
                condition = current.get("condition")
                if isinstance(condition, dict):
                    for side in ("leftExpression", "rightExpression"):
                        expr = condition.get(side)
                        if isinstance(expr, dict) and \
                                expr.get("nodeType") == "Identifier":
                            variables.append(expr.get("name"))
                stack.extend(v for v in current.values()
                             if isinstance(v, (dict, list)))
            elif isinstance(current, list):
                stack.extend(current)
        return variables

    def extract_address_variable(self, node) -> Set[str]:
        """Variables receiving ether via .transfer(...) / .send(...)."""
        variables: Set[str] = set()
        for method in TRANSFER_METHODS:
            for _parent, member in self._nodes_with_value(node, method):
                if member.get("nodeType") != "MemberAccess":
                    continue
                expression = member.get("expression", {})
                variables |= self._identifiers(expression)
        return variables
