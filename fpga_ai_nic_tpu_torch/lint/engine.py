"""The parsed-module context the H1 lockset pass walks — the port of
``ModuleCtx`` from the JAX package's ``lint/engine.py`` (its rule
dispatch and the traced-function scan check JAX programs and are not
ported)."""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional


class ModuleCtx:
    """Parsed module + shared derived facts: parent links, import aliases,
    dotted names."""

    def __init__(self, path: str, text: str, tree: ast.Module) -> None:
        self.path = path
        self.text = text
        self.tree = tree
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        # module aliases: local name -> dotted module (import time as t,
        # import numpy as np, from os import environ, ...)
        self.mod_aliases: Dict[str, str] = {}
        self.from_imports: Dict[str, str] = {}   # local name -> "mod.attr"
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        # `import numpy.random as npr` binds the full
                        # dotted module to the alias
                        self.mod_aliases[a.asname] = a.name
                    else:
                        # `import os.path` binds only `os`
                        root = a.name.split(".")[0]
                        self.mod_aliases[root] = root
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.from_imports[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return anc
        return None

    def dotted(self, node: ast.AST) -> str:
        """Best-effort dotted name of a Name/Attribute chain ('' if not)."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
            return ".".join(reversed(parts))
        return ""
