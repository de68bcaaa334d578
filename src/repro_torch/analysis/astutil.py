"""Shared AST helpers for the source-scanning checkers (the port's own
copy of ``repro.analysis.astutil``): dotted-name resolution and a
scope-tracking visitor whose ``scope`` property yields the dotted
function/class context findings anchor to (the same scope strings the
report fingerprints use).
"""
from __future__ import annotations

import ast


def dotted(node: ast.AST) -> str | None:
    """``a.b.c`` attribute chain -> ``"a.b.c"``; None if the base is not a
    plain name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def leaf_name(func: ast.AST) -> str | None:
    """The called name of a Call's ``func``: ``dist.all_reduce`` ->
    ``all_reduce``."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


class ScopedVisitor(ast.NodeVisitor):
    """NodeVisitor that tracks the dotted def/class scope while walking.

    Subclasses override ``visit_*`` for the nodes they care about and read
    ``self.scope``; function/class/lambda nesting is handled here."""

    def __init__(self) -> None:
        self._stack: list[str] = []

    @property
    def scope(self) -> str:
        return ".".join(self._stack)

    def _push(self, name: str, node: ast.AST) -> None:
        self._stack.append(name)
        self.generic_visit(node)
        self._stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._push(node.name, node)

    def visit_AsyncFunctionDef(self, node) -> None:
        self._push(node.name, node)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._push(node.name, node)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._push("<lambda>", node)
