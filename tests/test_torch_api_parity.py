"""The port's API against the JAX package's, name by name: every public
function, class and method (name not starting with "_") of a module of
minlz_tpu has a counterpart of the same name in the same module of
minlz_tpu_torch, or an entry with its reason in
minlz_tpu_torch._parity.NOT_PORTED.  A counterpart is a function, a class,
a method of the class of the same name, or a name the port's module binds
at its top (an import or an assignment: a re-export).  One case a module of
minlz_tpu.  Both packages are read with ast; neither is imported."""

import ast
import os

import pytest

from minlz_tpu_torch._parity import NOT_PORTED

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(ROOT, "minlz_tpu")
PORT = os.path.join(ROOT, "minlz_tpu_torch")
_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def _modules(root):
    return sorted(
        os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/")
        for d, _, files in os.walk(root) for f in files if f.endswith(".py"))


def public_defs(path):
    """Public top-level functions and classes, and Class.method for the
    public methods of public classes."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    out = set()
    for node in tree.body:
        if isinstance(node, _DEFS) and not node.name.startswith("_"):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{m.name}" for m in node.body
                           if isinstance(m, _DEFS[:2])
                           and not m.name.startswith("_"))
    return out


def bound_names(path):
    """``public_defs`` plus every name the module binds at its top by an
    import or an assignment."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    out = public_defs(path)
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            out.update(t.id for t in targets if isinstance(t, ast.Name))
    return out


JAX_MODULES = _modules(JAX)


def test_every_module_is_walked():
    assert len(JAX_MODULES) > 30
    assert "ops/decode_kernel.py" in JAX_MODULES
    assert set(NOT_PORTED) <= set(JAX_MODULES)


@pytest.mark.parametrize("module", JAX_MODULES)
def test_public_names_have_a_counterpart(module):
    want = public_defs(os.path.join(JAX, module))
    skip = NOT_PORTED.get(module, {})
    assert all(isinstance(r, str) and r for r in skip.values()), module
    # The table names only what the JAX module has.
    assert set(skip) - {"*"} <= want, sorted(set(skip) - {"*"} - want)
    port = os.path.join(PORT, module)
    if "*" in skip:
        assert not os.path.exists(port), f"{module} is ported after all"
        assert set(skip) - {"*"} == want, sorted(want ^ (set(skip) - {"*"}))
        return
    assert os.path.exists(port), f"{module} has no file in the port"
    have = bound_names(port)
    missing = sorted(want - have - set(skip))
    assert not missing, f"{module}: no counterpart of {missing}"
    listed_but_present = sorted(set(skip) & have)
    assert not listed_but_present, \
        f"{module}: {listed_but_present} are in NOT_PORTED and in the port"


def test_the_walk_sees_re_exports_and_methods(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("from .a import b as c, d\nimport x.y\nE = 1\n"
                   "def f(): pass\ndef _g(): pass\n"
                   "class K:\n    def m(self): pass\n    def _n(self): pass\n")
    assert public_defs(src) == {"f", "K", "K.m"}
    assert bound_names(src) == {"f", "K", "K.m", "c", "d", "x", "E"}
