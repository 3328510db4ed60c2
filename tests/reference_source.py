"""Module-level values of a reference module, read from its source.

Some reference modules change the process when imported:
``repro.launch.dryrun`` and ``repro.launch.hillclimb`` set
``XLA_FLAGS`` to 512 host devices before anything else, and every
reference test that starts JAX later in the same pytest worker would see
them. The port's parity tests read those modules' rule sets and
iteration tables here instead, with ``ast``: literals, and ``dict(...)``
calls of literals, as the reference writes them.
"""
from __future__ import annotations

import ast
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
SRC = REPO_ROOT / "src"


def _value(node):
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id == "dict" and not node.args:
        return {kw.arg: _value(kw.value) for kw in node.keywords}
    if isinstance(node, ast.Dict):
        return {None if k is None else _value(k): _value(v)
                for k, v in zip(node.keys, node.values)}
    if isinstance(node, (ast.List, ast.Tuple)):
        items = [_value(e) for e in node.elts]
        return items if isinstance(node, ast.List) else tuple(items)
    return ast.literal_eval(node)


def module_values(module: str, *names: str) -> dict:
    """``{name: value}`` of the named top-level assignments of
    ``module`` (a dotted name under ``src/``), never importing it."""
    path = SRC.joinpath(*module.split(".")).with_suffix(".py")
    found = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id in names:
            found[node.targets[0].id] = _value(node.value)
    missing = set(names) - set(found)
    if missing:
        raise KeyError(f"{module} assigns no {sorted(missing)}")
    return found


def dict_keys(module: str, function: str, name: str) -> list:
    """The keys of the dict display that ``function`` of ``module``
    assigns to ``name`` (in order), never importing the module."""
    path = SRC.joinpath(*module.split(".")).with_suffix(".py")
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.FunctionDef) and node.name == function:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign) and isinstance(
                        sub.value, ast.Dict) and any(
                        isinstance(t, ast.Name) and t.id == name
                        for t in sub.targets):
                    return [_value(k) for k in sub.value.keys]
    raise KeyError(f"{module}.{function} assigns no dict to {name}")
