"""HAM001 — buffer-write declarations must be true of the code.

A handler registered ``read_only=True`` may be routed at (and have its
buffer pointers retargeted to) ANY replica of its buffers.  If such a
handler writes through a ``deref``'d pointer it updates one replica and
silently diverges the others — the exact bug class closed dynamically in
PR 5 by gating replica serving on the declaration.  This rule closes it
*statically*: the declaration must be true of the code.

The annotation space has three points and the rule polices two edges:

* ``read_only=True`` + a store through buffer memory — the PR 5 replica
  divergence; the finding demands the store be removed (or the
  declaration dropped);
* *no* declaration (neither ``read_only`` nor ``mutates``) + a store —
  the write lands on the primary but its replicas are never invalidated,
  so a replica-served read observes stale bytes; the finding names the
  fix: **declare** ``mutates=True`` so the scheduler routes the call at
  the primary and commits/invalidates on completion (the Active Access
  write path — dataplane module docs);
* ``mutates=True`` + a store — declared and coherent: **no finding**.

Taint model: every value produced by ``deref(...)`` — and every alias
derived from one — is buffer memory.  Aliases come from plain assignment,
subscripting/slicing, attribute chains (``.T``, ``.data``), view-returning
methods (numpy's ``reshape``/``ravel``/``view``/``transpose``; torch's
``narrow``/``select``/``permute``/``expand``/``as_strided``/``unfold``/...,
and ``split``/``chunk``/``unbind``, whose results are tuples of views),
methods that may return their receiver (``detach``, ``contiguous``, ``to``,
``cpu``, ``numpy`` and the dtype casts, when nothing changes; every
in-place method returns its receiver), the function forms of those views
(``torch.narrow(x, ...)``), and ``torch.from_numpy`` / ``torch.as_tensor``
/ ``np.asarray`` of buffer memory.

A store through tainted memory is a violation: subscript/attribute
assignment, augmented assignment, an in-place method (numpy's ``fill``/
``sort``/...; torch's every method whose name ends in ``_``, ``set_``
included), an in-place function on it (``np.copyto``, ``torch.relu_``,
``torch.nn.init.normal_``, anything ``inplace=True``), or an ``out=``
kwarg — anywhere in a statement, not only as the statement itself.  So is
alias-escaping a tainted view into module-global state (the write then
merely happens later, off-site); container capture (``append``/``add``/
...) counts only on a module global: torch's out-of-place ``add``/``mul``
on a local tensor stores nothing.  Reading, reducing (``.sum()``), copying
(``.clone()``) and returning tainted values are fine — the wire layer
copies results.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.rules import Finding, LintContext, rule

#: ndarray methods that mutate the receiver in place (torch's in-place
#: methods are recognised by their trailing underscore: _writes_in_place)
_INPLACE_METHODS = {
    "fill", "sort", "put", "resize", "setfield", "itemset", "partition",
    "byteswap", "setflags",
}
#: methods returning a view of (i.e. aliasing) the receiver; ``split``,
#: ``chunk``, ``unbind`` and friends return tuples of views
_VIEW_METHODS = {
    # numpy (the reference's)
    "reshape", "ravel", "view", "transpose", "swapaxes", "squeeze",
    "diagonal",
    # torch
    "view_as", "flatten", "unflatten", "narrow", "select", "unsqueeze",
    "permute", "t", "expand", "expand_as", "as_strided", "unfold", "movedim",
    "moveaxis", "swapdims", "split", "split_with_sizes", "tensor_split",
    "chunk", "unbind", "hsplit", "vsplit", "dsplit", "view_as_real",
    "view_as_complex",
}
#: methods that may return the receiver itself (when nothing changes)
_SELF_METHODS = {
    "detach", "contiguous", "to", "cpu", "cuda", "numpy", "type", "type_as",
    "float", "double", "half", "bfloat16", "int", "long", "short", "byte",
    "char", "bool",
}
#: free functions returning an alias of their FIRST argument, besides the
#: function forms of the view and may-return-self methods
_ALIAS_FUNCS = {"from_numpy", "as_tensor", "asarray", "from_dlpack"}
#: free functions whose FIRST argument is written in place, besides the
#: trailing-underscore ones
_INPLACE_FUNCS = {"copyto"}
#: container methods that capture a reference to their argument
_CAPTURE_METHODS = {"append", "add", "insert", "extend", "setdefault",
                    "update"}
#: attributes that are metadata, not memory
_META_ATTRS = {"shape", "dtype", "device", "ndim", "size", "nbytes",
               "itemsize", "strides", "is_cuda", "requires_grad", "layout"}


def _writes_in_place(name: str) -> bool:
    """Does a method or function of this name write its receiver (or its
    first argument) in place?"""
    return name in _INPLACE_METHODS or (name.endswith("_")
                                        and not name.endswith("__"))


def _root_name(node: ast.expr) -> str | None:
    """Innermost Name of a Subscript/Attribute chain."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def _label(node: ast.expr) -> str:
    """How a finding names the memory written: the chain's root name, or
    the expression itself when the chain starts at a call."""
    return _root_name(node) or ast.unparse(node)


def _call_name(func: ast.expr) -> str | None:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


class _PurityChecker:
    def __init__(self, func_def, module_globals: set, path: str,
                 wire_name: str, declared_read_only: bool = True,
                 module_names: set | None = None):
        self.func = func_def
        self.module_globals = set(module_globals)
        #: names bound to imported modules (``torch``, ``np``, ``F``): an
        #: attribute call on one is a free function, not a method
        self.module_names = set(module_names or ())
        self.path = path
        self.wire_name = wire_name
        #: True: the site says read_only=True (PR 5 divergence message);
        #: False: the site declares nothing (undeclared-mutation message
        #: naming the mutates=True fix — module docs)
        self.declared_read_only = declared_read_only
        self.tainted: set[str] = set()
        self.declared_global: set[str] = set()
        self.findings: list[Finding] = []

    def run(self) -> list[Finding]:
        # two passes: the first only propagates taint (assign chains are
        # short, one pass reaches fixpoint for straight-line code); the
        # second reports, so a store textually above the assignment that
        # tainted its target still fires
        for report in (False, True):
            self.findings = []
            for node in self.func.body:
                self._stmt(node, report)
        return self.findings

    # -- taint -------------------------------------------------------------

    def _is_function_form(self, func: ast.expr) -> bool:
        """An imported ``f(x)`` or ``torch.f(x)`` / ``np.f(x)``: a free
        function, whose first argument is its operand (not a method of a
        local, not a builtin such as ``float``)."""
        if isinstance(func, ast.Name):
            return func.id in self.module_names
        return (isinstance(func, ast.Attribute)
                and _root_name(func.value) in self.module_names)

    def _is_tainted(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            # a field of buffer memory (``.T``, ``.data``) aliases it;
            # its metadata does not
            return node.attr not in _META_ATTRS and \
                self._is_tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self._is_tainted(node.value)
        if isinstance(node, ast.Call):
            func = node.func
            name = _call_name(func)
            if isinstance(func, ast.Name) and func.id == "deref":
                return True
            aliasing = name is not None and (
                name in _VIEW_METHODS or name in _SELF_METHODS
                or _writes_in_place(name))
            if isinstance(func, ast.Attribute) and aliasing and \
                    self._is_tainted(func.value):
                return True
            if (aliasing or name in _ALIAS_FUNCS) and node.args and \
                    self._is_function_form(func) and \
                    self._is_tainted(node.args[0]):
                return True
        if isinstance(node, ast.Starred):
            return self._is_tainted(node.value)
        return False

    # -- statement walk ----------------------------------------------------

    def _stmt(self, node: ast.stmt, report: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs run only when called
        if isinstance(node, ast.Import):
            self.module_names.update(
                a.asname or a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            self.module_names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Global):
            self.declared_global.update(node.names)
        elif isinstance(node, ast.Assign):
            self._assign(node, report)
        elif isinstance(node, ast.AugAssign):
            self._aug_assign(node, report)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            if isinstance(node.target, ast.Name) and \
                    self._is_tainted(node.value):
                self.tainted.add(node.target.id)
        # every call in the statement's own expressions (compound
        # statements: their headers; bodies are walked below)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._calls(child, report)
            elif isinstance(child, ast.withitem):
                self._calls(child.context_expr, report)
        if isinstance(node, (ast.If, ast.While, ast.For, ast.AsyncFor,
                             ast.With, ast.AsyncWith, ast.Try)):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.stmt):
                    self._stmt(child, report)
                elif isinstance(child, ast.ExceptHandler):
                    for sub in child.body:
                        self._stmt(sub, report)
            if isinstance(node, (ast.For, ast.AsyncFor)) and \
                    isinstance(node.target, ast.Name) and \
                    self._is_tainted(node.iter):
                # iterating rows of buffer memory yields views
                self.tainted.add(node.target.id)
        # Return / Raise / Pass: nothing more to do (returning a view is
        # legal — the wire layer copies)

    def _assign(self, node: ast.Assign, report: bool) -> None:
        value_tainted = self._is_tainted(node.value)
        for target in node.targets:
            if isinstance(target, ast.Name):
                is_global = (target.id in self.declared_global
                             or target.id in self.module_globals)
                if value_tainted and is_global and report:
                    self._report(
                        node,
                        f"stores a buffer view into module global "
                        f"'{target.id}' (alias escape)",
                    )
                if value_tainted:
                    self.tainted.add(target.id)
                else:
                    self.tainted.discard(target.id)  # rebound to clean value
            elif isinstance(target, (ast.Subscript, ast.Attribute)):
                root = _root_name(target)
                if self._is_tainted(target.value):
                    if report:
                        self._report(
                            node,
                            f"writes through buffer-derived "
                            f"'{_label(target.value)}' (offending store at "
                            f"line {node.lineno})",
                        )
                elif value_tainted and report and root is not None and (
                    root in self.module_globals
                    or root in self.declared_global
                ):
                    self._report(
                        node,
                        f"stores a buffer view into module global "
                        f"'{root}' (alias escape)",
                    )
            elif isinstance(target, ast.Tuple) and value_tainted:
                for el in target.elts:
                    if isinstance(el, ast.Name):
                        self.tainted.add(el.id)

    def _aug_assign(self, node: ast.AugAssign, report: bool) -> None:
        target = node.target
        written = target.value if isinstance(
            target, (ast.Subscript, ast.Attribute)) else target
        if self._is_tainted(written) and report:
            self._report(
                node,
                f"augmented assignment mutates buffer-derived "
                f"'{_label(written)}' in place (offending store at line "
                f"{node.lineno})",
            )

    def _calls(self, expr: ast.expr, report: bool) -> None:
        """Report every call in ``expr`` that writes buffer memory or
        captures it into module-global state."""
        if not report:
            return
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                self._call(node)

    def _call(self, node: ast.Call) -> None:
        func = node.func
        name = _call_name(func)
        first_tainted = bool(node.args) and self._is_tainted(node.args[0])
        function_form = self._is_function_form(func)
        if isinstance(func, ast.Attribute) and not function_form:
            if _writes_in_place(func.attr) and self._is_tainted(func.value):
                self._report(
                    node,
                    f"in-place method '.{func.attr}()' mutates "
                    f"buffer-derived '{_label(func.value)}'",
                )
            recv_root = _root_name(func.value)
            if func.attr in _CAPTURE_METHODS and \
                    recv_root is not None and \
                    recv_root in self.module_globals and \
                    any(self._is_tainted(a) for a in node.args):
                self._report(
                    node,
                    f"captures a buffer view into module global "
                    f"'{recv_root}' (alias escape)",
                )
        if name is not None and first_tainted and (
            name in _INPLACE_FUNCS
            or (function_form and _writes_in_place(name))
        ):
            self._report(
                node,
                f"'{name}' writes into its first argument, which is "
                "buffer-derived",
            )
        for kw in node.keywords:
            if kw.arg == "out" and self._is_tainted(kw.value):
                self._report(node, "out= targets a buffer-derived array")
            elif kw.arg == "inplace" and first_tainted and \
                    isinstance(kw.value, ast.Constant) and \
                    kw.value.value is True:
                self._report(
                    node,
                    f"'{name}' with inplace=True writes into its first "
                    "argument, which is buffer-derived",
                )

    def _report(self, node: ast.AST, detail: str) -> None:
        if self.declared_read_only:
            message = (
                f"handler {self.wire_name!r} is declared read_only=True "
                f"but {detail}; a replica-served call would diverge the "
                "other replicas (PR 5 bug class)"
            )
        else:
            message = (
                f"handler {self.wire_name!r} {detail} but declares "
                "neither read_only=True nor mutates=True; declare "
                "mutates=True so the scheduler routes the call at the "
                "buffer's primary and invalidates replicas when it "
                "completes — undeclared, replica holders keep serving "
                "the overwritten bytes (docs/failure-model.md, 'Write "
                "visibility and convergence')"
            )
        self.findings.append(Finding(
            rule="HAM001",
            path=self.path,
            line=node.lineno,
            col=node.col_offset,
            message=message,
        ))


@rule(
    "HAM001",
    title="buffer writes must match the handler's declaration: "
          "read_only=True handlers must not mutate or alias-escape "
          "BufferPtr-derived memory, and a handler that does must "
          "declare mutates=True",
    historical="PR 5: an undeclared-mutation handler served from a replica "
               "silently diverged the other replicas",
)
def check(ctx: LintContext) -> list[Finding]:
    findings: list[Finding] = []
    for site in ctx.sites:
        if site.func_def is None or site.mutates is True:
            # mutates=True declares the store — in-place writes are the
            # point of the annotation (Active Access), nothing to police
            continue
        checker = _PurityChecker(
            site.func_def,
            site.module.toplevel_assigns,
            site.module.path,
            site.wire_name or site.fn_name or "<anonymous>",
            declared_read_only=site.read_only is True,
            module_names=set(site.module.imports),
        )
        findings.extend(checker.run())
    return findings
