"""HAM004 — wire-constant soundness.

The u16 flags field and the u64 msg_id space are tiny shared namespaces
spanning every process in a fleet; a colliding ``FLAG_*`` bit or a replay
sentinel drifting into live msg_id space is a cross-version wire-corruption
bug with no local symptom.  ``repro_torch.core.flags`` is the single declared
source of truth (with import-time assertions); this rule enforces that it
stays the *only* source:

* any literal assignment to a ``FLAG_*`` / ``MSG_ID_*`` name outside the
  canonical module is flagged (re-exports via ``import`` are fine —
  imports cannot drift from the table);
* the canonical table itself is re-verified here (distinct bits, bits
  inside the flags field, sentinels at/above the reserved floor) so a CI
  run reports a diagnostic with file:line instead of an ImportError
  traceback.
"""

from __future__ import annotations

import ast
import re

from repro_torch.analysis.rules import Finding, LintContext, rule

_CANONICAL_SUFFIX = "repro_torch/core/flags.py"
_NAME_RE = re.compile(r"^(FLAG_[A-Z0-9_]+|MSG_ID_[A-Z0-9_]+|FLUSH)$")


def _fold_int(node: ast.expr):
    """Constant-fold int literals and the shift/or/add arithmetic wire
    constants are written in; None when not a literal expression."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.BinOp):
        left, right = _fold_int(node.left), _fold_int(node.right)
        if left is None or right is None:
            return None
        if isinstance(node.op, ast.LShift):
            return left << right
        if isinstance(node.op, ast.BitOr):
            return left | right
        if isinstance(node.op, ast.Add):
            return left + right
        if isinstance(node.op, ast.Sub):
            return left - right
        if isinstance(node.op, ast.Mult):
            return left * right
    return None


def _literal_wire_assignments(tree: ast.Module):
    """Yield ``(name, value, node)`` for FLAG_*/sentinel-name assignments
    with literal integer values, anywhere in the module (class bodies
    included — ``ReplayCache.FLUSH = 1 << 61`` was exactly the pattern)."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        value = _fold_int(node.value)
        if value is None:
            continue
        for target in node.targets:
            if isinstance(target, ast.Name) and _NAME_RE.match(target.id):
                yield target.id, value, node


@rule(
    "HAM004",
    title="wire constants (flag bits, msg_id sentinels) live only in the "
          "centralized registry and must not collide",
    historical="FLAG_SEG_SRC and the replay FLUSH sentinel were each added "
               "by grepping message.py for the highest bit in use — one "
               "missed module and two fleet versions disagree on a bit",
)
def check(ctx: LintContext) -> list[Finding]:
    findings: list[Finding] = []

    # the authoritative table — import the real module so the rule can
    # never drift from what the runtime actually uses
    from repro_torch.core import flags as canonical

    canonical_bits = dict(canonical.FLAG_BITS)
    bit_owner = {bit: name for name, bit in canonical_bits.items()}

    for mod in ctx.modules:
        is_canonical = mod.path.replace("\\", "/").endswith(_CANONICAL_SUFFIX)
        for name, value, node in _literal_wire_assignments(mod.tree):
            if is_canonical:
                continue
            detail = ""
            if name.startswith("FLAG_"):
                bit = value.bit_length() - 1
                if value > 0 and value == (1 << bit) and bit in bit_owner:
                    detail = (f" — and its bit {bit} collides with "
                              f"{bit_owner[bit]}")
                findings.append(Finding(
                    rule="HAM004", path=mod.path, line=node.lineno,
                    col=node.col_offset,
                    message=(
                        f"flag constant '{name}' defined outside the "
                        "centralized registry (repro_torch.core.flags); declare "
                        f"the bit there and import it{detail}"
                    ),
                ))
            else:
                in_reserved = (canonical.MSG_ID_RESERVED_FLOOR <= value
                               < (1 << canonical.MSG_ID_FIELD_WIDTH))
                detail = ("" if in_reserved else
                          " — and its value is INSIDE live msg_id space "
                          f"(reserved floor is "
                          f"{canonical.MSG_ID_RESERVED_FLOOR:#x})")
                findings.append(Finding(
                    rule="HAM004", path=mod.path, line=node.lineno,
                    col=node.col_offset,
                    message=(
                        f"msg_id sentinel '{name}' defined outside the "
                        "centralized registry (repro_torch.core.flags); declare "
                        f"it there and import it{detail}"
                    ),
                ))

    # re-verify the canonical table itself, diagnosably
    canonical_path = next(
        (m.path for m in ctx.modules
         if m.path.replace("\\", "/").endswith(_CANONICAL_SUFFIX)),
        _CANONICAL_SUFFIX,
    )
    seen: dict[int, str] = {}
    for name, bit in canonical_bits.items():
        if bit in seen:
            findings.append(Finding(
                rule="HAM004", path=canonical_path, line=1, col=0,
                message=f"colliding flag bits: {name} and {seen[bit]} both "
                        f"claim bit {bit}",
            ))
        seen[bit] = name
        if not 0 <= bit < canonical.FLAGS_FIELD_WIDTH:
            findings.append(Finding(
                rule="HAM004", path=canonical_path, line=1, col=0,
                message=f"{name} bit {bit} outside the "
                        f"u{canonical.FLAGS_FIELD_WIDTH} flags field",
            ))
    for name, value in canonical.MSG_ID_SENTINELS.items():
        if not (canonical.MSG_ID_RESERVED_FLOOR <= value
                < (1 << canonical.MSG_ID_FIELD_WIDTH)):
            findings.append(Finding(
                rule="HAM004", path=canonical_path, line=1, col=0,
                message=f"msg_id sentinel {name} = {value:#x} is inside "
                        "live msg_id space",
            ))
    return findings
