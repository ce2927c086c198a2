"""Iterative dominator-tree construction (Cooper–Harvey–Kennedy).

"A Simple, Fast Dominance Algorithm" (Cooper, Harvey, Kennedy 2001):
process nodes in reverse postorder, intersecting the current immediate
dominators of each node's processed predecessors, until a fixed point.
No Lengauer–Tarjan machinery, no recursion, no external deps — the CFGs
this runs on are EVM contracts (hundreds to low thousands of blocks), and
CHK is near-linear there.

The same routine computes POST-dominators: call it on the reversed edge
set with the virtual exit node as the entry.

The port's own copy of the JAX package's module.
"""

from __future__ import annotations

from typing import List, Optional, Sequence


def postorder(succs: Sequence[Sequence[int]], entry: int) -> List[int]:
    """Iterative DFS postorder over the nodes reachable from `entry`."""
    seen = [False] * len(succs)
    order: List[int] = []
    # (node, iterator over its successors) — explicit stack, no recursion
    stack = [(entry, iter(succs[entry]))]
    seen[entry] = True
    while stack:
        node, it = stack[-1]
        advanced = False
        for nxt in it:
            if not seen[nxt]:
                seen[nxt] = True
                stack.append((nxt, iter(succs[nxt])))
                advanced = True
                break
        if not advanced:
            order.append(node)
            stack.pop()
    return order


def compute_idoms(succs: Sequence[Sequence[int]],
                  entry: int) -> List[Optional[int]]:
    """Immediate dominator of every node, or None for nodes unreachable
    from `entry` (the entry dominates itself: idom[entry] == entry)."""
    n = len(succs)
    preds: List[List[int]] = [[] for _ in range(n)]
    for node in range(n):
        for nxt in succs[node]:
            preds[nxt].append(node)

    order = postorder(succs, entry)          # postorder
    rpo_index = [-1] * n                     # node -> reverse-postorder rank
    for rank, node in enumerate(reversed(order)):
        rpo_index[node] = rank

    idom: List[Optional[int]] = [None] * n
    idom[entry] = entry

    def intersect(a: int, b: int) -> int:
        # walk the two dominator chains up (toward the entry = lower rank)
        while a != b:
            while rpo_index[a] > rpo_index[b]:
                a = idom[a]  # type: ignore[assignment]
            while rpo_index[b] > rpo_index[a]:
                b = idom[b]  # type: ignore[assignment]
        return a

    changed = True
    while changed:
        changed = False
        for node in reversed(order):         # reverse postorder
            if node == entry:
                continue
            new_idom: Optional[int] = None
            for pred in preds[node]:
                if idom[pred] is None:
                    continue                 # not processed / unreachable
                new_idom = pred if new_idom is None \
                    else intersect(pred, new_idom)
            if new_idom is not None and idom[node] != new_idom:
                idom[node] = new_idom
                changed = True
    return idom


def dominator_depth(idom: Sequence[Optional[int]], entry: int) -> List[int]:
    """Depth of every node in the dominator tree (-1 when unreachable)."""
    depth = [-1] * len(idom)
    depth[entry] = 0
    for start in range(len(idom)):
        if depth[start] >= 0 or idom[start] is None:
            continue
        chain = []
        node = start
        while depth[node] < 0 and idom[node] is not None:
            chain.append(node)
            node = idom[node]  # type: ignore[assignment]
        base = depth[node]
        if base < 0:
            continue
        for offset, member in enumerate(reversed(chain), start=1):
            depth[member] = base + offset
    return depth
