"""Pluggable rule registry for ``hamlint``.

A rule is a function ``check(ctx: LintContext) -> list[Finding]`` declared
with the :func:`rule` decorator.  Rules see the *whole* parsed tree (every
module, every extracted registration site), so cross-module invariants
(same-source coverage, wire-constant collisions) are first-class.

To add a rule: create a module in this package, decorate a function with
``@rule("HAM0xx", title=..., historical=...)``, and import the module at
the bottom of this ``__init__`` (the import *is* the registration — the
same static-initialisation idiom as the handler registry itself).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Callable

__all__ = [
    "Finding",
    "LintContext",
    "ModuleInfo",
    "RegistrationSite",
    "Rule",
    "all_rules",
    "rule",
]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: ``path:line:col: RULE message``."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


@dataclasses.dataclass
class ModuleInfo:
    """One parsed source module plus the lookup tables rules need."""

    path: str
    modname: str                 # dotted name ('' when not under a package root)
    tree: ast.Module
    #: local name -> source module, for names bound by import statements
    imports: dict[str, str] = dataclasses.field(default_factory=dict)
    #: module-level function defs by name
    toplevel_defs: dict[str, ast.AST] = dataclasses.field(default_factory=dict)
    #: names assigned at module level (module-global state)
    toplevel_assigns: set[str] = dataclasses.field(default_factory=set)
    #: local functions executed at import time (called at module level,
    #: transitively within this module)
    import_time_funcs: set[str] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class RegistrationSite:
    """One ``@handler`` / ``register(...)`` occurrence (loop sites are
    unrolled: one site per literal tuple element)."""

    module: ModuleInfo
    line: int
    col: int
    via: str                     # 'decorator' | 'call' | 'loop'
    wire_name: str | None        # literal name= if present
    fn_name: str | None          # identifier of the registered function
    func_def: ast.AST | None     # same-module def, when resolvable
    read_only: bool | None       # literal read_only= value; None if absent
    mutates: bool | None         # literal mutates= value; None if absent
    specs_node: ast.expr | None  # arg_specs= / args= expression
    specs_kw: str | None         # which keyword carried the specs
    result_specs_node: ast.expr | None
    import_time: bool            # executes when the module is imported
    receiver: str | None         # receiver identifier of a .register call
    fn_is_param: bool            # registered fn is a parameter of the
                                 # enclosing function (dynamic path)


@dataclasses.dataclass
class LintContext:
    modules: list[ModuleInfo]
    sites: list[RegistrationSite]


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    title: str
    historical: str              # the shipped bug this rule would have caught
    check: Callable[[LintContext], list[Finding]]


_RULES: dict[str, Rule] = {}


def rule(rule_id: str, *, title: str, historical: str = ""):
    def deco(fn):
        if rule_id in _RULES:
            raise ValueError(f"duplicate rule id {rule_id}")
        _RULES[rule_id] = Rule(rule_id, title, historical, fn)
        return fn
    return deco


def all_rules() -> dict[str, Rule]:
    return dict(_RULES)


# importing the submodules registers the rules (static initialisation)
from repro_torch.analysis.rules import (  # noqa: E402,F401
    read_only_purity,
    same_source,
    spec_coherence,
    wire_constants,
)
