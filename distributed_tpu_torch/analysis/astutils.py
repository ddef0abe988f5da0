"""Shared AST plumbing for the lint rules.

Nothing here knows about any specific invariant: parent links, dotted-name
rendering, import-alias resolution (so ``import time as _t; _t.sleep(...)``
still reads as ``time.sleep``), and enclosing-scope lookup.
"""

from __future__ import annotations

import ast
from typing import Iterator

PARENT_ATTR = "_graft_parent"


def add_parents(tree: ast.AST) -> ast.AST:
    if getattr(tree, "_graft_parented", False):  # every rule calls this
        return tree
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            setattr(child, PARENT_ATTR, node)
    tree._graft_parented = True  # type: ignore[attr-defined]
    return tree


def parent(node: ast.AST) -> ast.AST | None:
    return getattr(node, PARENT_ATTR, None)


def enclosing(
    node: ast.AST, *types: type
) -> ast.AST | None:
    """Nearest ancestor of one of ``types`` (parents must be linked)."""
    cur = parent(node)
    while cur is not None:
        if isinstance(cur, types):
            return cur
        cur = parent(cur)
    return None


def enclosing_function_name(node: ast.AST) -> str:
    fn = enclosing(node, ast.FunctionDef, ast.AsyncFunctionDef)
    if fn is None:
        return "<module>"
    return fn.name  # type: ignore[union-attr]


def dotted(node: ast.AST) -> str | None:
    """Render ``a.b.c`` chains; None for anything non-trivial."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


class ImportMap:
    """local name -> canonical dotted target, from a module's imports."""

    def __init__(self, tree: ast.Module):
        self.names: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    target = alias.name if alias.asname else alias.name.split(".")[0]
                    self.names[local] = target
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    self.names[alias.asname or alias.name] = (
                        f"{node.module}.{alias.name}"
                    )

    def resolve(self, node: ast.AST) -> str | None:
        """Canonical dotted name of an expression, aliases unwound."""
        name = dotted(node)
        if name is None:
            return None
        head, _, rest = name.partition(".")
        head = self.names.get(head, head)
        return f"{head}.{rest}" if rest else head


def iter_calls(tree: ast.AST) -> Iterator[ast.Call]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield node


def call_keywords(call: ast.Call) -> tuple[list[str], bool]:
    """(explicit keyword names, has **expansion)."""
    names, double_star = [], False
    for kw in call.keywords:
        if kw.arg is None:
            double_star = True
        else:
            names.append(kw.arg)
    return names, double_star


def func_params(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> tuple[set[str], bool]:
    """(acceptable keyword names, accepts **kwargs)."""
    a = fn.args
    names = {p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)}
    return names, a.kwarg is not None


def walk_scope(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> Iterator[ast.AST]:
    """Walk a function body WITHOUT descending into nested def/lambda.

    Blocking-in-async cares about code that runs on the loop; a nested
    ``def`` is (in this codebase) an executor target or callback, not loop
    code, so its body is judged separately (or not at all).
    """
    stack: list[ast.AST] = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None
