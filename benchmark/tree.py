"""Named leaves (``"net.layers.0.w"``) and the nested dicts and lists the
program takes its parameters in. The reference and the output check work
on the named form; only ``families/`` hand the nested form to the
program."""

from __future__ import annotations

from typing import Any, Dict


def nest(named: Dict[str, Any]) -> Any:
    """``{"a.0.w": t}`` → ``{"a": [{"w": t}]}``: a numeric part is a list
    index."""
    root: Dict[str, Any] = {}
    for name, value in named.items():
        parts = name.split(".")
        node = root
        for part, nxt in zip(parts[:-1], parts[1:]):
            key = int(part) if part.isdigit() else part
            child = [] if nxt.isdigit() else {}
            if isinstance(node, list):
                while len(node) <= key:
                    node.append(None)
                if node[key] is None:
                    node[key] = child
                node = node[key]
            else:
                node = node.setdefault(key, child)
        last = parts[-1]
        if isinstance(node, list):
            idx = int(last)
            while len(node) <= idx:
                node.append(None)
            node[idx] = value
        else:
            node[last] = value
    return root


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """The inverse of :func:`nest`."""
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}
