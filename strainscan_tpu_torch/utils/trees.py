"""Minimal binary-tree structure for the Cluster Search Tree.

Replaces the reference's ``treelib`` dependency with plain dicts; node
identifiers are ints.  Provides exactly the operations the CST build and
search need (children/parent/siblings/leaves/depth/ancestor tests and
root-to-leaf paths — cf. treelib usage across library/Build_tree.py and
library/identify.py).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple


class BinTree:
    def __init__(self) -> None:
        self.parent: Dict[int, Optional[int]] = {}
        self.children: Dict[int, Tuple[int, int]] = {}
        self.root: Optional[int] = None

    @classmethod
    def from_relationship(cls, root: int,
                          rel: Dict[int, Tuple[int, int]]) -> "BinTree":
        t = cls()
        t.root = root
        t.parent[root] = None
        stack = [root]
        while stack:
            n = stack.pop()
            if n in rel:
                a, b = rel[n]
                t.children[n] = (a, b)
                t.parent[a] = n
                t.parent[b] = n
                stack.extend([a, b])
        return t

    def add_root(self, nid: int) -> None:
        self.root = nid
        self.parent[nid] = None

    def nodes(self) -> List[int]:
        """All node ids in root-first (pre-order, left-to-right) order."""
        if self.root is None:
            return []
        out: List[int] = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            out.append(n)
            if n in self.children:
                a, b = self.children[n]
                stack.append(b)
                stack.append(a)
        return out

    def nodes_bfs(self) -> List[int]:
        """Breadth-first order, root first — matches the insertion order of
        the reference's treelib ``all_nodes()`` (Build_tree.py:68-79), which
        fixes identifier assignment."""
        if self.root is None:
            return []
        out: List[int] = []
        queue = [self.root]
        while queue:
            n = queue.pop(0)
            out.append(n)
            if n in self.children:
                queue.extend(self.children[n])
        return out

    def leaves(self) -> List[int]:
        return [n for n in self.nodes() if n not in self.children]

    def is_leaf(self, nid: int) -> bool:
        return nid not in self.children

    def sibling(self, nid: int) -> Optional[int]:
        p = self.parent.get(nid)
        if p is None:
            return None
        a, b = self.children[p]
        return b if nid == a else a

    def depth(self, nid: int) -> int:
        d = 0
        p = self.parent.get(nid)
        while p is not None:
            d += 1
            p = self.parent.get(p)
        return d

    def is_ancestor(self, anc: int, nid: int) -> bool:
        p = self.parent.get(nid)
        while p is not None:
            if p == anc:
                return True
            p = self.parent.get(p)
        return False

    def ancestors(self, nid: int, include_self: bool = True) -> List[int]:
        out = [nid] if include_self else []
        p = self.parent.get(nid)
        while p is not None:
            out.append(p)
            p = self.parent.get(p)
        return out

    def descendants(self, nid: int, include_self: bool = True) -> List[int]:
        out: List[int] = []
        stack = [nid]
        while stack:
            n = stack.pop()
            out.append(n)
            if n in self.children:
                stack.extend(self.children[n])
        return out if include_self else out[1:]

    def descendant_leaves(self, nid: int) -> List[int]:
        return [n for n in self.descendants(nid) if self.is_leaf(n)]

    def paths_to_leaves(self) -> Iterator[List[int]]:
        for leaf in self.leaves():
            yield list(reversed(self.ancestors(leaf)))
