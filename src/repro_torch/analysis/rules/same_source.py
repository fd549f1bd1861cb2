"""HAM003 — same-source coverage.

Workers derive their import list from the *defining module* of every
registered handler (``registered_setup_modules``: ``fn.__module__`` over
the pending records).  The invariant that makes this correct: importing a
handler's defining module must re-run its registration.  Two static
violations break it — both are the PR 2 divergence class, where host and
worker silently derive different key maps:

* **cross-module registration at import time** — module A registers, at
  import, a function *defined in* module B.  The worker imports B (that is
  where ``fn.__module__`` points), A's registration statement never runs,
  the handler is missing, and the key-map digests diverge at attach.

* **registration not executed at import** — module M defines handlers and
  a ``register_*`` helper, but nothing calls the helper at module level.
  A worker importing M gets the defs and not the registrations.  (Helpers
  that register *caller-supplied* functions — the ``l2f`` / ``offloaded``
  dynamic paths — are exempt: there is no module-level def to cover.)

Both fixes are one line: register in the defining module, or add the
guarded module-level call (see ``offload/dataplane.py`` for the idiom).
"""

from __future__ import annotations

from repro_torch.analysis.rules import Finding, LintContext, rule


@rule(
    "HAM003",
    title="every registering module must re-register on import "
          "(registered_setup_modules coverage)",
    historical="PR 2: a registration living outside the handler's defining "
               "module made workers derive a different key map than the "
               "host (digest mismatch at attach)",
)
def check(ctx: LintContext) -> list[Finding]:
    findings: list[Finding] = []
    for site in ctx.sites:
        # dynamic paths register functions they were handed — the caller
        # owns coverage; nothing to check statically
        if site.fn_is_param or site.receiver in ("self", "cls"):
            continue
        if site.import_time:
            if site.fn_name is not None and site.func_def is None and \
                    site.fn_name in site.module.imports:
                origin = site.module.imports[site.fn_name]
                findings.append(Finding(
                    rule="HAM003",
                    path=site.module.path,
                    line=site.line,
                    col=site.col,
                    message=(
                        f"import-time registration of '{site.fn_name}', "
                        f"which is defined in '{origin}': workers import a "
                        "handler's *defining* module "
                        "(registered_setup_modules), so this registration "
                        "will not run there and key maps diverge (PR 2 "
                        "class) — register it from "
                        f"'{origin}' instead"
                    ),
                ))
        elif site.func_def is not None:
            findings.append(Finding(
                rule="HAM003",
                path=site.module.path,
                line=site.line,
                col=site.col,
                message=(
                    f"registration of "
                    f"'{site.wire_name or site.fn_name}' never executes at "
                    "import time: a worker importing "
                    f"'{site.module.modname or site.module.path}' re-runs "
                    "module-level statements only, so it would derive a key "
                    "map missing this handler (PR 2 class) — call the "
                    "registering function at module level, guarded with "
                    "RegistrySealedError (see offload/dataplane.py)"
                ),
            ))
    return findings
