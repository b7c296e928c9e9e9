"""The port's API against the JAX package's, name by name and argument by
argument.  Names: every public function, class and method (name not
starting with "_") of a module of minlz_tpu has a counterpart of the same
name in the same module of minlz_tpu_torch, or an entry with its reason in
minlz_tpu_torch._parity.NOT_PORTED.  A counterpart is a function, a class,
a method of the class of the same name, or a name the port's module binds
at its top (an import or an assignment: a re-export).  Arguments: a
counterpart that is a function or a method (``__init__`` included; a
re-export is followed to its def) takes the JAX function's parameters by
name, in their order and of their kind, keeps every default, and adds only
parameters with defaults, or it has an entry in
minlz_tpu_torch._parity.ARGS_DIFFER.  One case a module of minlz_tpu for
each rule.  Both packages are read with ast; neither is imported."""

import ast
import os

import pytest

from minlz_tpu_torch._parity import ARGS_DIFFER, NOT_PORTED

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


# ---- arguments ----------------------------------------------------------

_FUNCS = _DEFS[:2]


def signature(fn):
    """(positional [(name, has default)], *args, keyword-only [(name, has
    default)], **kwargs) of a def node."""
    a = fn.args
    pos = a.posonlyargs + a.args
    first_default = len(pos) - len(a.defaults)
    return ([(x.arg, i >= first_default) for i, x in enumerate(pos)],
            a.vararg is not None,
            [(x.arg, d is not None) for x, d in zip(a.kwonlyargs,
                                                    a.kw_defaults)],
            a.kwarg is not None)


def _parse(path):
    with open(path) as fh:
        return ast.parse(fh.read())


def _top_defs(tree):
    """name -> def node for the public functions, and Class.method for the
    public methods and ``__init__`` of the public classes."""
    out = {}
    for node in tree.body:
        if node.name.startswith("_") if isinstance(node, _DEFS) else True:
            continue
        if isinstance(node, _FUNCS):
            out[node.name] = node
        else:
            out.update((f"{node.name}.{m.name}", m) for m in node.body
                       if isinstance(m, _FUNCS)
                       and (not m.name.startswith("_")
                            or m.name == "__init__"))
    return out


def resolve_def(path, name, depth=0):
    """The def node that ``name`` is in the module at ``path``: its own
    def, a method, or, followed, a top-level alias (``a = b``) or a
    relative import.  None when it is no function of the package."""
    tree = _parse(path)
    defs = _top_defs(tree)
    defs.update((n.name, n) for n in tree.body if isinstance(n, _FUNCS))
    if name in defs or depth > 4 or "." in name:
        return defs.get(name)
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Name) \
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in node.targets):
            return resolve_def(path, node.value.id, depth + 1)
        if isinstance(node, ast.ImportFrom) and node.level:
            for a in node.names:
                if (a.asname or a.name) == name:
                    base = os.path.dirname(path)
                    for _ in range(node.level - 1):
                        base = os.path.dirname(base)
                    mod = os.path.join(base, *(node.module or "").split("."))
                    src = mod + ".py" if os.path.exists(mod + ".py") \
                        else os.path.join(mod, "__init__.py")
                    if os.path.exists(src):
                        return resolve_def(src, a.name, depth + 1)
    return None


def args_differ(want, have):
    """Why the port's signature ``have`` does not take every call of the
    JAX signature ``want``, or None."""
    (wp, wv, wk, ww), (hp, hv, hk, hw) = want, have
    if [n for n, _ in hp[:len(wp)]] != [n for n, _ in wp]:
        return (f"positional parameters {[n for n, _ in hp]}, JAX "
                f"{[n for n, _ in wp]}")
    lost = [n for (n, d), (_, hd) in zip(wp, hp) if d and not hd]
    if lost:
        return f"no default for {lost}"
    extra = [n for n, d in hp[len(wp):] if not d]
    if extra:
        return f"added parameters without a default: {extra}"
    if (wv, ww) != (hv, hw):
        return "*args or **kwargs differ"
    wanted = [n for n, _ in wk]
    if [n for n, _ in hk if n in wanted] != wanted:
        return (f"keyword-only parameters {[n for n, _ in hk]}, JAX "
                f"{wanted}")
    hdef = dict(hk)
    lost = [n for n, d in wk if d and not hdef[n]]
    extra = [n for n, d in hk if n not in wanted and not d]
    if lost or extra:
        return f"keyword-only defaults: lost {lost}, added without {extra}"
    return None


def param_text(sig):
    """A signature as ARGS_DIFFER writes it: "a, b=, *, c=, **kw"."""
    pos, var, kw, kwarg = sig
    out = [n + "=" * d for n, d in pos]
    if var or kw:
        out.append("*")
    out += [n + "=" * d for n, d in kw]
    if kwarg:
        out.append("**")
    return ", ".join(out)


def argument_faults(jax_path, port_path, listed):
    """Every fault of the argument rule for one module: counterparts whose
    parameters differ and are not in ``listed`` (the module's ARGS_DIFFER
    table: name -> (the port's parameters, reason)), listed ones whose
    parameters are not the listed ones, and entries that name no JAX
    function or no difference."""
    want = _top_defs(_parse(jax_path))
    faults = [f"{name}: listed, but JAX has no such function"
              for name in sorted(set(listed) - set(want))]
    for name, node in sorted(want.items()):
        have = resolve_def(port_path, name)
        why = None if have is None else args_differ(signature(node),
                                                    signature(have))
        if why and name not in listed:
            faults.append(f"{name}: {why}")
        elif name in listed and not why:
            faults.append(f"{name}: listed in ARGS_DIFFER, but the port "
                          f"takes JAX's arguments")
        elif name in listed and param_text(signature(have)) \
                != listed[name][0]:
            faults.append(f"{name}: the port takes "
                          f"({param_text(signature(have))}), ARGS_DIFFER "
                          f"lists ({listed[name][0]})")
    return faults


def test_args_differ_names_modules_of_both():
    assert set(ARGS_DIFFER) <= set(JAX_MODULES)
    for module, table in ARGS_DIFFER.items():
        assert os.path.exists(os.path.join(PORT, module)), module
        assert table and all(
            isinstance(p, str) and isinstance(r, str) and r
            for p, r in table.values()), module


@pytest.mark.parametrize("module", JAX_MODULES)
def test_arguments_match(module):
    port = os.path.join(PORT, module)
    if not os.path.exists(port):
        assert "*" in NOT_PORTED.get(module, {}), module
        assert module not in ARGS_DIFFER
        return
    faults = argument_faults(os.path.join(JAX, module), port,
                             ARGS_DIFFER.get(module, {}))
    assert not faults, f"{module}: {faults}"


JAX_SRC = """
def f(data, n, seg=4, *, level=2):
    pass
def g(x, y=1):
    pass
class K:
    def __init__(self, a):
        pass
    def m(self, b, c=0):
        pass
"""
PORT_SRC = {
    "same": JAX_SRC,
    "extras with defaults": JAX_SRC.replace(
        "seg=4, *, level=2", "seg=4, device='cuda', *, level=2, x=0"),
    "renamed": JAX_SRC.replace("def f(data,", "def f(data_flat,"),
    "dropped": JAX_SRC.replace("n, seg=4,", "seg=4,"),
    "reordered": JAX_SRC.replace("data, n,", "n, data,"),
    "default lost": JAX_SRC.replace("y=1", "y"),
    "added without a default": JAX_SRC.replace("b, c=0", "b, c=0, *, d"),
    "keyword made positional": JAX_SRC.replace(", *, level=2",
                                               ", level=2"),
    "constructor renamed": JAX_SRC.replace("self, a)", "self, b)"),
    "re-export": JAX_SRC.replace("def g(x, y=1):", "def _g(x, y=1):")
    + "g = _g\n",
    "re-export renamed": JAX_SRC.replace("def g(x, y=1):",
                                         "def _g(z, y=1):") + "g = _g\n",
}
RULE_HOLDS = {"same", "extras with defaults", "re-export"}
ARG_CASES = [(case, "ok" if case in RULE_HOLDS else "unlisted")
             for case in PORT_SRC] + [
    ("renamed", "listed"), ("renamed", "listed, changed"),
    ("same", "listed, gone"), ("same", "listed, no such function")]


def _differ(case):
    return {"renamed": "f", "dropped": "f", "reordered": "f",
            "default lost": "g", "added without a default": "K.m",
            "keyword made positional": "f", "constructor renamed":
            "K.__init__", "re-export renamed": "g"}.get(case, "f")


@pytest.mark.parametrize("case,table", ARG_CASES)
def test_the_argument_rule(tmp_path, case, table):
    """The walk fails on a difference that is not listed, on a listed one
    that has gone and on a listed function whose parameters changed again,
    and passes a listed difference and the port's allowed extras."""
    (tmp_path / "jax.py").write_text(JAX_SRC)
    (tmp_path / "port.py").write_text(PORT_SRC[case])
    listed = {"listed": {"f": ("data_flat, n, seg=, *, level=", "why")},
              "listed, changed": {"f": ("data, n, seg=, *, level=", "x")},
              "listed, gone": {"f": ("data, n, seg=, *, level=", "why")},
              "listed, no such function": {"h": ("x", "why")}}.get(table,
                                                                  {})
    faults = argument_faults(tmp_path / "jax.py", tmp_path / "port.py",
                             listed)
    if table in ("ok", "listed"):
        assert faults == []
    else:
        assert len(faults) == 1
        name = {"listed, gone": "f", "listed, changed": "f",
                "listed, no such function": "h"}.get(table, _differ(case))
        assert faults[0].startswith(f"{name}: ")


def test_the_walk_follows_imports(tmp_path):
    pkg = tmp_path / "pkg"
    (pkg / "sub").mkdir(parents=True)
    (pkg / "a.py").write_text("def k(x, y=0):\n    pass\n")
    (pkg / "sub" / "b.py").write_text("from ..a import k as j\n")
    node = resolve_def(pkg / "sub" / "b.py", "j")
    assert node is not None and node.name == "k"
    assert signature(node) == ([("x", False), ("y", True)], False, [], False)
    assert param_text(signature(node)) == "x, y="
    assert resolve_def(pkg / "sub" / "b.py", "missing") is None
