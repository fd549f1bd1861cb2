"""HAM002 — static-spec / signature coherence.

A static spec tuple IS the wire layout: the sender packs ``len(arg_specs)``
leaves and the receiver applies them positionally to the handler.  An arity
mismatch means the payload and the call disagree — caught today only when
``init()`` compiles the plan or, worse, when the dispatch explodes on a
live frame.  This rule checks at lint time that

* a literal ``arg_specs=(...)`` / ``args=(...)`` tuple has exactly as many
  leaves as the function has positional parameters (``*args`` signatures
  are exempt), and
* every ``ScalarSpec(...)`` leaf names a wire-plan-compilable kind — the
  fused-scalar struct only speaks ``i8`` / ``f8`` / ``b1``
  (``repro_torch.core.wireplan``).

The call-time twin lives in ``HandlerRegistry.register`` (the dynamic path
and this static pass can never disagree silently).
"""

from __future__ import annotations

import ast

from repro_torch.analysis.rules import Finding, LintContext, rule

_SCALAR_KINDS = {"i8", "f8", "b1"}


def _positional_arity(func_def) -> tuple[int, bool]:
    """(positional parameter count, has *args)."""
    a = func_def.args
    return len(a.posonlyargs) + len(a.args), a.vararg is not None


def _scalar_kind_findings(tup: ast.expr, path: str, wire_name: str):
    if not isinstance(tup, (ast.Tuple, ast.List)):
        return
    for leaf in tup.elts:
        if not (isinstance(leaf, ast.Call) and
                isinstance(leaf.func, ast.Name) and
                leaf.func.id == "ScalarSpec"):
            continue
        kind = None
        if leaf.args and isinstance(leaf.args[0], ast.Constant):
            kind = leaf.args[0].value
        for kw in leaf.keywords:
            if kw.arg == "kind" and isinstance(kw.value, ast.Constant):
                kind = kw.value.value
        if isinstance(kind, str) and kind not in _SCALAR_KINDS:
            yield Finding(
                rule="HAM002",
                path=path,
                line=leaf.lineno,
                col=leaf.col_offset,
                message=(
                    f"handler {wire_name!r}: ScalarSpec kind {kind!r} is not "
                    f"wire-plan compilable (known kinds: "
                    f"{', '.join(sorted(_SCALAR_KINDS))})"
                ),
            )


@rule(
    "HAM002",
    title="static spec tuples must match the handler signature and be "
          "wire-plan compilable",
    historical="arity drift between a spec tuple and its handler surfaces "
               "as a SpecMismatchError on a live frame, far from the "
               "registration that caused it",
)
def check(ctx: LintContext) -> list[Finding]:
    findings: list[Finding] = []
    for site in ctx.sites:
        wire_name = site.wire_name or site.fn_name or "<anonymous>"
        if site.specs_node is not None and \
                isinstance(site.specs_node, (ast.Tuple, ast.List)) and \
                site.func_def is not None:
            n_leaves = len(site.specs_node.elts)
            n_params, has_varargs = _positional_arity(site.func_def)
            if not has_varargs and n_leaves != n_params:
                findings.append(Finding(
                    rule="HAM002",
                    path=site.module.path,
                    line=site.line,
                    col=site.col,
                    message=(
                        f"handler {wire_name!r}: spec tuple declares "
                        f"{n_leaves} leaves but "
                        f"'{site.func_def.name}' takes {n_params} positional "
                        "parameters — payload and call disagree"
                    ),
                ))
        for node in (site.specs_node, site.result_specs_node):
            if node is not None:
                findings.extend(
                    _scalar_kind_findings(node, site.module.path, wire_name)
                )
    return findings
