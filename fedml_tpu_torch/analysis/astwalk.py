"""``walk``: :func:`ast.walk`'s breadth-first order, remembered on the
node walked.

The analyzer's rules and passes walk the same module, class and function
nodes many times over (the per-module rules, the concurrency pass, and
each project-wide pass over every file), so a node's descendants are
listed once and the list is kept on the node. Over the port that halves
the time ``ast.walk``'s re-listing took and keeps the whole run inside
its CLI budget. The analyzer never edits a tree it walks: a tree changed
after a walk must be parsed again.
"""

from __future__ import annotations

import ast
from collections import deque

_KEY = "_fedlint_walk"


def walk(node):
    """Every node under ``node`` (itself first), in :func:`ast.walk`'s
    order."""
    nodes = node.__dict__.get(_KEY)
    if nodes is None:
        nodes, todo = [], deque([node])
        while todo:
            n = todo.popleft()
            todo.extend(ast.iter_child_nodes(n))
            nodes.append(n)
        setattr(node, _KEY, nodes)
    return iter(nodes)
