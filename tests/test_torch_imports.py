"""The port's modules keep to each other's public names: no module of
benerf_tpu_torch imports, or reads as an attribute, a `_`-prefixed
function, class or constant of another of its modules. A private module
imported as a whole (data/events.py imports data/_native) is a public
use of that module."""

import ast
from pathlib import Path

PKG = Path(__file__).resolve().parents[1] / "benerf_tpu_torch"
ROOT = PKG.parent


def _module_name(path):
    parts = path.relative_to(ROOT).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


MODULES = {_module_name(p): p for p in PKG.rglob("*.py")}


def _private(name):
    return name.startswith("_") and not (name.startswith("__") and name.endswith("__"))


def _absolute(module, node):
    """The absolute name of an ImportFrom's module inside `module`."""
    if not node.level:
        return node.module
    base = module.split(".")
    if MODULES[module].name != "__init__.py":
        base = base[:-1]
    base = base[:len(base) - node.level + 1]
    return ".".join(base + ([node.module] if node.module else []))


def _private_uses(module):
    """(line, what) of every private name of another of the package's
    modules that `module` imports or reads as an attribute."""
    tree = ast.parse(MODULES[module].read_text())
    aliases, out = {}, []  # local name -> the package module it is bound to
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name in MODULES and a.asname:
                    aliases[a.asname] = a.name
        elif isinstance(node, ast.ImportFrom):
            src = _absolute(module, node)
            if src not in MODULES:
                continue
            for a in node.names:
                sub = f"{src}.{a.name}"
                if sub in MODULES:
                    aliases[a.asname or a.name] = sub
                elif _private(a.name) and src != module:
                    out.append((node.lineno, f"from {src} import {a.name}"))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                and node.value.id in aliases and _private(node.attr)
                and aliases[node.value.id] != module
                and f"{aliases[node.value.id]}.{node.attr}" not in MODULES):
            out.append((node.lineno, f"{aliases[node.value.id]}.{node.attr}"))
    return out


def test_no_module_reaches_into_another_modules_private_names():
    found = [f"{MODULES[m].relative_to(ROOT)}:{line}: {what}"
             for m in sorted(MODULES) for line, what in _private_uses(m)]
    assert not found, "\n".join(found)


def test_the_scan_sees_both_forms_of_private_use(tmp_path, monkeypatch):
    """The scan finds a private name imported by name and one read as an
    attribute of an imported module, and passes a private module imported
    as a whole."""
    src = ("from benerf_tpu_torch.ops.mlp import _hidden\n"
           "from benerf_tpu_torch.ops import mlp as mlp_ops\n"
           "from benerf_tpu_torch.data import _native\n"
           "x = mlp_ops._hidden\n"
           "y = _native.prepare_raw\n")
    (tmp_path / "probe.py").write_text(src)
    monkeypatch.setitem(MODULES, "benerf_tpu_torch.probe", tmp_path / "probe.py")
    assert [line for line, _ in _private_uses("benerf_tpu_torch.probe")] == [1, 4]
