"""hamlint — AST-based protocol linter for HAM handler registrations.

Usage::

    python -m repro_torch.analysis.hamlint src/repro_torch [more roots...]
    python -m repro_torch.analysis.hamlint --list-rules
    python -m repro_torch.analysis.hamlint --select HAM001,HAM003 src/repro_torch

Walks every ``.py`` file under the given roots, extracts every
``@handler`` / ``register(...)`` site (including the repo's
registration-loop idiom — ``for name, fn, read_only in ((...), ...):``
bodies are unrolled per literal tuple element), and runs the rule set from
:mod:`repro_torch.analysis.rules`.  Exit status 0 = clean, 1 = findings (printed
as ``path:line:col: RULE message``), 2 = usage error.

What counts as a registration site
----------------------------------

* a decorator named ``handler`` (bare or called, ``@handler`` /
  ``@reg.handler(...)``);
* a call whose callee attribute is ``register`` or ``handler``, whose
  receiver is not ``atexit`` and whose first positional argument is not a
  string literal (this excludes ``atexit.register(cb)`` and the
  name-first ``DeviceHandlerTable.register("key", fn)`` family, which is a
  *device-side* table with its own validation);
* the same calls inside a ``for`` loop over a literal tuple-of-tuples —
  unrolled, so per-element ``name=`` / ``read_only=`` values resolve.

A site records whether it executes at *import time* (module level, or in a
function called at module level, transitively within the module) — the
property the same-source rule is built on.
"""

from __future__ import annotations

import ast
import os
import sys

from repro_torch.analysis.rules import (
    Finding,
    LintContext,
    ModuleInfo,
    RegistrationSite,
    all_rules,
)

__all__ = ["lint_paths", "main", "parse_module", "extract_sites"]


# --------------------------------------------------------------------------
# module parsing
# --------------------------------------------------------------------------


def _modname_for(path: str) -> str:
    """Dotted module name, derived from the nearest ``src`` or package root
    on the path; bare basename otherwise (fixture corpora)."""
    norm = os.path.normpath(os.path.abspath(path))
    parts = norm.split(os.sep)
    stem = parts[-1][:-3] if parts[-1].endswith(".py") else parts[-1]
    if "src" in parts:
        rel = parts[parts.index("src") + 1 : -1]
        dotted = ".".join(rel + ([] if stem == "__init__" else [stem]))
        if dotted:
            return dotted
    return stem


def parse_module(path: str) -> ModuleInfo | None:
    try:
        with open(path, encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=path)
    except (OSError, SyntaxError):
        return None
    mod = ModuleInfo(path=path, modname=_modname_for(path), tree=tree)

    for node in tree.body:
        _index_toplevel(mod, node)

    # functions executed at import time: called at module level, closed
    # transitively over same-module calls
    called: set[str] = set()
    _collect_calls(tree, called)
    frontier = [n for n in called if n in mod.toplevel_defs]
    seen = set(frontier)
    while frontier:
        fname = frontier.pop()
        mod.import_time_funcs.add(fname)
        inner: set[str] = set()
        _collect_calls(mod.toplevel_defs[fname], inner)
        for n in inner:
            if n in mod.toplevel_defs and n not in seen:
                seen.add(n)
                frontier.append(n)
    return mod


def _index_toplevel(mod: ModuleInfo, node: ast.AST) -> None:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        mod.toplevel_defs[node.name] = node
    elif isinstance(node, ast.Assign):
        for t in node.targets:
            if isinstance(t, ast.Name):
                mod.toplevel_assigns.add(t.id)
    elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        mod.toplevel_assigns.add(node.target.id)
    elif isinstance(node, ast.Import):
        for alias in node.names:
            mod.imports[alias.asname or alias.name.split(".")[0]] = alias.name
    elif isinstance(node, ast.ImportFrom):
        src = node.module or ""
        for alias in node.names:
            mod.imports[alias.asname or alias.name] = src
    elif isinstance(node, (ast.Try, ast.If, ast.With)):
        for child in ast.iter_child_nodes(node):
            _index_toplevel(mod, child)


def _collect_calls(node: ast.AST, out: set) -> None:
    """Names called as plain functions in code that RUNS when ``node``
    executes: nested function bodies are pruned (they only run when called
    — their decorators and defaults still evaluate here), class bodies are
    walked (they execute at definition time)."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        out.add(node.func.id)
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            for deco in getattr(child, "decorator_list", []):
                _collect_calls(deco, out)
            for default in (getattr(child, "args", None) and
                            child.args.defaults or []):
                _collect_calls(default, out)
            continue
        _collect_calls(child, out)


# --------------------------------------------------------------------------
# site extraction
# --------------------------------------------------------------------------

_REGISTER_ATTRS = {"register", "handler"}


def _const(node):
    """Literal constant value, or the sentinel ``_NOT_CONST``."""
    if isinstance(node, ast.Constant):
        return node.value
    return _NOT_CONST


_NOT_CONST = object()


def _kwargs_of(call: ast.Call) -> dict[str, ast.expr]:
    return {kw.arg: kw.value for kw in call.keywords if kw.arg is not None}


class _SiteExtractor(ast.NodeVisitor):
    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.sites: list[RegistrationSite] = []
        #: stack of enclosing function names (module level = empty)
        self.func_stack: list[str] = []
        #: parameters of the innermost enclosing function(s)
        self.param_stack: list[set[str]] = []
        #: loop-variable bindings active at this point (from unrolled loops)
        self._loop_bindings: dict[str, ast.expr] | None = None
        #: decorator Call nodes already recorded as decorator sites —
        #: generic_visit will reach them again as plain calls; skip there
        self._decorator_calls: set[int] = set()

    # -- helpers -----------------------------------------------------------

    def _import_time_here(self) -> bool:
        if not self.func_stack:
            return True
        return self.func_stack[0] in self.mod.import_time_funcs

    def _resolve_fn(self, node: ast.expr | None):
        """(fn_name, func_def, fn_is_param) for the registered-function
        expression, resolving loop bindings first."""
        if self._loop_bindings is not None and isinstance(node, ast.Name):
            node = self._loop_bindings.get(node.id, node)
        if not isinstance(node, ast.Name):
            return None, None, False
        name = node.id
        is_param = any(name in params for params in self.param_stack)
        return name, self.mod.toplevel_defs.get(name), is_param

    def _resolve_value(self, node: ast.expr | None) -> ast.expr | None:
        if self._loop_bindings is not None and isinstance(node, ast.Name):
            return self._loop_bindings.get(node.id, node)
        return node

    def _add_site(self, call: ast.Call, *, via: str, fn_expr, func_def_node=None,
                  loc=None) -> None:
        kws = _kwargs_of(call)
        name_node = self._resolve_value(kws.get("name"))
        wire_name = _const(name_node)
        ro_node = self._resolve_value(kws.get("read_only"))
        ro = _const(ro_node)
        mu_node = self._resolve_value(kws.get("mutates"))
        mu = _const(mu_node)
        specs_kw = None
        specs_node = None
        for key in ("arg_specs", "args"):
            if key in kws:
                specs_kw = key
                specs_node = self._resolve_value(kws[key])
                break
        fn_name, func_def, fn_is_param = self._resolve_fn(fn_expr)
        if func_def_node is not None:
            func_def = func_def_node
            fn_name = func_def_node.name
            fn_is_param = False
        receiver = None
        if isinstance(call.func, ast.Attribute) and isinstance(
            call.func.value, ast.Name
        ):
            receiver = call.func.value.id
        loc = loc or call
        self.sites.append(RegistrationSite(
            module=self.mod,
            line=loc.lineno,
            col=loc.col_offset,
            via=via,
            wire_name=wire_name if isinstance(wire_name, str) else None,
            fn_name=fn_name,
            func_def=func_def,
            read_only=ro if isinstance(ro, bool) else None,
            mutates=mu if isinstance(mu, bool) else None,
            specs_node=specs_node,
            specs_kw=specs_kw,
            result_specs_node=self._resolve_value(kws.get("result_specs")),
            import_time=self._import_time_here(),
            receiver=receiver,
            fn_is_param=fn_is_param,
        ))

    # -- visitors ----------------------------------------------------------

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_funcdef(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_funcdef(node)

    def _visit_funcdef(self, node) -> None:
        for deco in node.decorator_list:
            call = deco if isinstance(deco, ast.Call) else None
            target = call.func if call else deco
            is_handler = (
                isinstance(target, ast.Name) and target.id == "handler"
            ) or (
                isinstance(target, ast.Attribute) and target.attr == "handler"
            )
            if is_handler:
                synth = call if call else ast.Call(func=target, args=[],
                                                   keywords=[])
                if call is not None:
                    self._decorator_calls.add(id(call))
                self._add_site(synth, via="decorator", fn_expr=None,
                               func_def_node=node, loc=deco)
        params = {a.arg for a in (
            node.args.posonlyargs + node.args.args + node.args.kwonlyargs
        )}
        if node.args.vararg:
            params.add(node.args.vararg.arg)
        if node.args.kwarg:
            params.add(node.args.kwarg.arg)
        self.func_stack.append(node.name)
        self.param_stack.append(params)
        self.generic_visit(node)
        self.func_stack.pop()
        self.param_stack.pop()

    def visit_For(self, node: ast.For) -> None:
        unrolled = self._try_unroll(node)
        if not unrolled:
            self.generic_visit(node)

    def _try_unroll(self, node: ast.For) -> bool:
        """Unroll ``for a, b, ... in ((...), (...)):`` over register calls."""
        if not isinstance(node.iter, (ast.Tuple, ast.List)):
            return False
        if not isinstance(node.target, ast.Tuple):
            return False
        targets = node.target.elts
        if not all(isinstance(t, ast.Name) for t in targets):
            return False
        elements = node.iter.elts
        if not elements or not all(
            isinstance(e, (ast.Tuple, ast.List)) and len(e.elts) == len(targets)
            for e in elements
        ):
            return False
        calls = [
            n for n in ast.walk(node)
            if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr in _REGISTER_ATTRS
            and self._is_registration_call(n)
        ]
        if not calls:
            return False
        for element in elements:
            bindings = {
                t.id: v for t, v in zip(targets, element.elts)
            }
            prev = self._loop_bindings
            self._loop_bindings = bindings
            try:
                for call in calls:
                    self._add_site(call, via="loop",
                                   fn_expr=call.args[0] if call.args else None,
                                   loc=element)
            finally:
                self._loop_bindings = prev
        return True

    def _is_registration_call(self, call: ast.Call) -> bool:
        func = call.func
        if not isinstance(func, ast.Attribute) or \
                func.attr not in _REGISTER_ATTRS:
            return False
        if isinstance(func.value, ast.Name) and func.value.id == "atexit":
            return False
        # name-first tables (DeviceHandlerTable.register("key", fn), serve
        # tables) are a different dispatch layer — skip string-first calls
        if call.args and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, str):
            return False
        # a bare .register()/.handler() with neither a positional fn nor any
        # registration keyword is some unrelated API
        if not call.args and not call.keywords:
            return False
        return True

    def visit_Call(self, node: ast.Call) -> None:
        if self._is_registration_call(node) and \
                self._loop_bindings is None and \
                id(node) not in self._decorator_calls:
            self._add_site(node, via="call",
                           fn_expr=node.args[0] if node.args else None)
        self.generic_visit(node)


def extract_sites(mod: ModuleInfo) -> list[RegistrationSite]:
    ex = _SiteExtractor(mod)
    ex.visit(mod.tree)
    return ex.sites


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------


def _iter_py_files(roots):
    for root in roots:
        if os.path.isfile(root):
            if root.endswith(".py"):
                yield root
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(
                d for d in dirnames if d != "__pycache__"
            )
            for fname in sorted(filenames):
                if fname.endswith(".py"):
                    yield os.path.join(dirpath, fname)


def lint_paths(roots, select: set[str] | None = None) -> list[Finding]:
    modules = []
    for path in _iter_py_files(roots):
        mod = parse_module(path)
        if mod is not None:
            modules.append(mod)
    sites = []
    for mod in modules:
        sites.extend(extract_sites(mod))
    ctx = LintContext(modules=modules, sites=sites)
    findings: list[Finding] = []
    for rule_id, rule in sorted(all_rules().items()):
        if select and rule_id not in select:
            continue
        findings.extend(rule.check(ctx))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    select: set[str] | None = None
    roots: list[str] = []
    it = iter(argv)
    for arg in it:
        if not arg.startswith("-"):
            roots.append(arg)
            continue
        if arg == "--list-rules":
            for rule_id, rule in sorted(all_rules().items()):
                line = f"{rule_id}  {rule.title}"
                if rule.historical:
                    line += f"  [would have caught: {rule.historical}]"
                print(line)
            return 0
        if arg == "--select":
            val = next(it, None)
            if val is None:
                print("error: --select needs a comma-separated rule list",
                      file=sys.stderr)
                return 2
            select = set(val.split(","))
        elif arg.startswith("--select="):
            select = set(arg.split("=", 1)[1].split(","))
        else:
            print(f"error: unknown option {arg!r}", file=sys.stderr)
            return 2
    if not roots:
        print("usage: python -m repro_torch.analysis.hamlint [--select IDS] "
              "[--list-rules] ROOT [ROOT...]", file=sys.stderr)
        return 2
    missing = [r for r in roots if not os.path.exists(r)]
    if missing:
        print(f"error: no such path(s): {', '.join(missing)}", file=sys.stderr)
        return 2
    findings = lint_paths(roots, select=select)
    for f in findings:
        print(f.format())
    if findings:
        print(f"hamlint: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
