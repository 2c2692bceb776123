"""Nested dict/list trees of tensors, flattened the way ``jax.tree_util`` does.

Parameter and gradient trees in the port are plain nested ``dict``s and
``list``s with tensors at the leaves, the same layout as the reference's
pytrees.  Flattening visits dict keys in sorted order and lists in index
order, and skips ``None`` (an empty subtree), so leaf order and the path
strings are exactly ``jax.tree_util.tree_flatten_with_path`` and
``jax.tree_util.keystr``: ``['stages'][3]['blk00']['attn']['w_q']``.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Iterator, Mapping

_KEY_RE = re.compile(r"\[(?:'((?:[^'\\]|\\.)*)'|(\d+))\]")


def _walk(tree, prefix: str) -> Iterator[tuple[str, Any]]:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def flatten_with_path(tree) -> list[tuple[str, Any]]:
    """``(keystr path, leaf)`` pairs in ``jax.tree_util`` flatten order."""
    return list(_walk(tree, ""))


def leaves(tree) -> list:
    return [v for _, v in _walk(tree, "")]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of the same structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def map_with_path(fn: Callable, tree, prefix: str = ""):
    """``fn(path, leaf)`` over one tree, keeping its structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def parse_path(path: str) -> list[str | int]:
    """Inverse of the keystr format: ``"['a'][2]" -> ['a', 2]``."""
    keys: list[str | int] = []
    pos = 0
    for m in _KEY_RE.finditer(path):
        if m.start() != pos:
            raise ValueError(f"not a keystr path: {path!r}")
        keys.append(m.group(1) if m.group(2) is None else int(m.group(2)))
        pos = m.end()
    if pos != len(path) or not keys:
        raise ValueError(f"not a keystr path: {path!r}")
    return keys


def from_paths(items: Mapping[str, Any]):
    """Build a nested dict/list tree from ``{keystr path: leaf}``."""
    root: dict = {}
    for path, leaf in items.items():
        keys = parse_path(path)
        node: Any = root
        for k, nxt in zip(keys[:-1], keys[1:]):
            node = _child(node, k, [] if isinstance(nxt, int) else {})
        _set(node, keys[-1], leaf)
    return root


def _child(node, key, empty):
    if isinstance(key, int):
        while len(node) <= key:
            node.append(None)
        if node[key] is None:
            node[key] = empty
        return node[key]
    return node.setdefault(key, empty)


def _set(node, key, leaf):
    if isinstance(key, int):
        while len(node) <= key:
            node.append(None)
    node[key] = leaf
