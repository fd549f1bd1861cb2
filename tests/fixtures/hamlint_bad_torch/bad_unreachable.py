"""hamlint fixture: two same-source violations (the PR 2 divergence class).
Never imported — parsed by the linter only."""

from _bad_unreachable_helper import helper_handler

from repro_torch.core.registry import default_registry

_reg = default_registry()

# import-time registration of a function DEFINED ELSEWHERE: workers import
# the defining module (_bad_unreachable_helper), where this statement does
# not exist — key maps diverge
_reg.register(helper_handler, name="bad/foreign_fn")


def local_handler(x):
    return x


def register_late(registry=None):
    # never called at module level: a worker importing this module would
    # not run this registration
    reg = registry or default_registry()
    reg.register(local_handler, name="bad/never_at_import")
