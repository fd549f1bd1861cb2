"""hamlint fixture: spec/signature arity mismatch and a bad scalar kind.
Never imported — parsed by the linter only."""

from repro_torch.core.migratable import ScalarSpec
from repro_torch.core.registry import default_registry

_reg = default_registry()


def takes_two(a, b):
    return a + b


# three leaves, two parameters — the payload and the call disagree
_reg.register(
    takes_two,
    arg_specs=(ScalarSpec("i8"), ScalarSpec("i8"), ScalarSpec("f8")),
    name="bad/arity",
)


def takes_one(a):
    return a


# 'u4' is not a wire-plan-compilable scalar kind
_reg.register(
    takes_one,
    arg_specs=(ScalarSpec("u4"),),
    name="bad/scalar_kind",
)
