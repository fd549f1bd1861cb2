"""Transferable closures — the ``function<Sig, FnPtr>`` template and ``f2f``.

Paper mapping (§5.1): the function pointer is a *template value parameter* —
part of the closure's **type**, never a data member — so no code address ever
crosses an address space.  Here, the function's identity is its **stable
name** in the handler registry; a :class:`Function` closure stores only the
key-resolvable identity plus the packed arguments.  On the receiving side the
handler (which *is* the function, registered under the same stable name)
unpacks the arguments from its statically known spec and executes.

``f2f(fn, *args)`` builds a closure from a registered handler.
``l2f(name, fn)`` registers an anonymous function under an explicit name
first (the paper's lambda workaround), then behaves like ``f2f``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.core import migratable as mig
from repro_torch.core.errors import SpecMismatchError
from repro_torch.core.registry import HandlerRecord, HandlerRegistry, default_registry


@dataclasses.dataclass
class Function:
    """A transferable closure: handler identity + packed arguments."""

    record: HandlerRecord
    args: tuple

    def __call__(self) -> Any:
        """Local execution (``Result operator()() const``)."""
        return self.record.fn(*self.args)

    # -- wire form ---------------------------------------------------------

    @property
    def is_static(self) -> bool:
        return self.record.is_static

    def pack_payload(self) -> bytes:
        if self.record.is_static:
            return mig.pack_static(self.args, self.record.arg_specs)
        return mig.pack_dynamic(list(self.args))

    @staticmethod
    def unpack_args(record: HandlerRecord, payload) -> tuple:
        if record.is_static:
            return mig.unpack_static(payload, record.arg_specs)
        out = mig.unpack_dynamic(payload)
        return tuple(out)


def f2f(
    fn: Callable | str,
    *args: Any,
    registry: HandlerRegistry | None = None,
) -> Function:
    """"function to functor": build a transferable closure.

    ``fn`` must already be a registered handler (its registration is the
    analogue of the template instantiation happening in every binary).
    Arguments are validated against the handler's static spec *now*, at
    construction — the paper's compile-time ``is_bitwise_copyable`` trap.
    """
    reg = registry or default_registry()
    record = reg.table.record_of(fn)
    if record.is_static:
        if len(args) != len(record.arg_specs):
            raise SpecMismatchError(
                f"{record.stable_name}: expected {len(record.arg_specs)} args, "
                f"got {len(args)}"
            )
        for a, s in zip(args, record.arg_specs):
            mig.check_against_spec(a, s)
    else:
        for a in args:
            # dynamic path still requires migratable leaves; fail fast here
            mig.pack_dynamic(a) if not mig.is_bitwise_migratable(a) else None
    return Function(record, args)


def l2f(
    name: str,
    fn: Callable,
    *,
    args: tuple | None = None,
    registry: HandlerRegistry | None = None,
) -> Callable:
    """"lambda to functor": register an anonymous function under an explicit
    stable name (paper §5.1 — the route around compiler-internal lambda
    names), returning the function for later ``f2f`` use.

    Must be called during the registration phase (before ``init()``), in
    *every* process, with the same ``name`` — the same-source assumption.
    """
    reg = registry or default_registry()
    specs = tuple(mig.spec_of(a) for a in args) if args is not None else None
    reg.register(fn, arg_specs=specs, name=name)
    return fn
