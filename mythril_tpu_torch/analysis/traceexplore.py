"""Serializable statespace export for `--statespace-json`
(capability parity: mythril/analysis/traceexplore.py:52 —
get_serializable_statespace).

The port's copy of mythril_tpu/analysis/traceexplore.py."""

from __future__ import annotations

from typing import Dict, List

_COLORS = [
    "#6c54de", "#de5454", "#54de89", "#de9a54", "#54bade", "#d354de",
    "#dede54", "#54de54",
]


def get_serializable_statespace(statespace) -> Dict:
    """Nodes/edges/states of one exploration as plain JSON-able dicts."""
    nodes: List[Dict] = []
    edges: List[Dict] = []

    color_map: Dict[str, str] = {}
    for uid, node in statespace.nodes.items():
        function_name = getattr(node, "function_name", "unknown")
        if function_name not in color_map:
            color_map[function_name] = _COLORS[len(color_map) % len(_COLORS)]
        code_lines = []
        for state in node.states:
            try:
                instruction = state.get_current_instruction()
            except Exception:
                continue
            code_lines.append(
                f"{instruction['address']} {instruction['opcode']} "
                f"{instruction.get('argument', '') or ''}".strip())
        nodes.append({
            "id": str(uid),
            "func": function_name,
            "color": color_map[function_name],
            "code": code_lines,
            "instructions": code_lines,
            "contract": getattr(node, "contract_name", "Unknown"),
            "startAddr": getattr(node, "start_addr", None),
            "isExpanded": False,
            "truncLabel": f"{function_name}",
            "states": [
                {
                    "pc": state.mstate.pc,
                    "depth": state.mstate.depth,
                    "gas": {"min": state.mstate.min_gas_used,
                            "max": state.mstate.max_gas_used},
                    "stackSize": len(state.mstate.stack),
                } for state in node.states],
        })

    for edge in statespace.edges:
        edges.append({
            "from": str(edge.node_from),
            "to": str(edge.node_to),
            "arrows": "to",
            "label": str(edge.condition) if edge.condition is not None else "",
            "smooth": {"type": "cubicBezier"},
        })

    return {"nodes": nodes, "edges": edges,
            "totalStates": sum(len(n["states"]) for n in nodes)}
