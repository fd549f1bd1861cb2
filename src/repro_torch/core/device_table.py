"""Device-side handler tables: HAM's key dispatch over device step functions.

Port of ``repro.core.device_table``.  The reference compiles the handler
vector into one XLA executable (a ``lax.switch``); PyTorch runs eagerly, so
here the table is a list of branches indexed by the key, and each branch
launches its own kernels on the card.  What carries over unchanged:

* keys are assigned by sorting stable names, so two processes agree on every
  key with no communication;
* all branches take the same payload structure and must return the same
  result structure ("fixed payload spec handler class").

``jax.eval_shape`` has no counterpart that can run a branch closing over real
parameters, so result specs are checked **on the first call of each branch**:
the dispatch returned by :meth:`DeviceHandlerTable.build` compares the first
result of every branch with the spec the table recorded, and
:meth:`DeviceHandlerTable.validate` runs every branch once on a payload the
caller supplies (for branches that are pure tensor code, ``meta`` tensors
cost no device memory).  :meth:`DeviceHandlerTable.lower` stands where the
reference lowers the switch without running it: every branch runs once on
``meta`` tensors under ``launch.op_analysis`` (the kernels' plain versions,
nothing allocated), giving the result spec and each branch's cost.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.errors import RegistryError, UnknownHandlerError


@dataclasses.dataclass(frozen=True)
class DeviceHandler:
    stable_name: str
    fn: Callable  # payload pytree -> result pytree


def _spec_of(tree: Any):
    """(structure, leaf specs) of a pytree: ``(shape, dtype)`` for tensors,
    the type for any other leaf."""
    leaves, structure = pytree.tree_flatten(tree)
    specs = [
        (tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor) else type(x)
        for x in leaves
    ]
    return structure, specs


class DeviceHandlerTable:
    """Builds ``dispatch(key, payload)`` = ``branches[key](payload)`` over
    handlers sorted by stable name."""

    def __init__(self):
        self._entries: dict[str, Callable] = {}
        self._sealed: list[DeviceHandler] | None = None
        self._result_spec = None  # (name, structure, leaf specs) of the first checked result

    def register(self, name: str, fn: Callable) -> Callable:
        if self._sealed is not None:
            raise RegistryError("device table already built")
        if name in self._entries and self._entries[name] is not fn:
            raise RegistryError(f"device handler name collision: {name!r}")
        self._entries[name] = fn
        return fn

    # -- init: sort -> keys (communication-free, as in the host registry) ---

    def seal(self) -> None:
        self._sealed = [
            DeviceHandler(n, self._entries[n]) for n in sorted(self._entries)
        ]

    @property
    def handlers(self) -> list[DeviceHandler]:
        if self._sealed is None:
            self.seal()
        return self._sealed

    def key_of(self, name: str) -> int:
        for i, h in enumerate(self.handlers):
            if h.stable_name == name:
                return i
        raise UnknownHandlerError(f"no device handler named {name!r}")

    def __len__(self) -> int:
        return len(self.handlers)

    # -- result-spec checks -------------------------------------------------

    def _check(self, h: DeviceHandler, result: Any) -> None:
        structure, specs = _spec_of(result)
        if self._result_spec is None:
            self._result_spec = (h.stable_name, structure, specs)
            return
        ref_name, ref_structure, ref_specs = self._result_spec
        if structure != ref_structure:
            raise RegistryError(
                f"device handler {h.stable_name!r} result tree structure "
                f"differs from {ref_name!r}"
            )
        for a, b in zip(specs, ref_specs):
            if a != b:
                raise RegistryError(
                    f"device handler {h.stable_name!r} result leaf {a} != {b} "
                    f"of {ref_name!r}"
                )

    def validate(self, payload: Any) -> Any:
        """Run every branch once on ``payload`` and require that all agree on
        the result spec; returns it.  The branches really run, so pass a
        payload they may consume (``meta`` tensors for pure tensor code)."""
        for h in self.handlers:
            self._check(h, h.fn(payload))
        return self._result_spec[1:]

    def build(self) -> Callable:
        """``dispatch(key, payload)``: index the sorted branch list.  The
        first result of each branch is checked against the table's result
        spec (see the module docstring); later calls pay one list index."""
        branches = [h.fn for h in self.handlers]
        unchecked = set(range(len(branches)))

        def dispatch(key: int, payload: Any) -> Any:
            if not 0 <= key < len(branches):
                raise UnknownHandlerError(f"device key {key} out of range")
            out = branches[key](payload)
            if key in unchecked:
                self._check(self.handlers[key], out)
                unchecked.discard(key)
            return out

        return dispatch

    def lower(self, payload_spec: Any, key_spec=None) -> LoweredTable:
        """Validate ``payload_spec`` (a tree of tensors or ``(shape, dtype)``
        pairs) against every branch on ``meta`` tensors and count each branch's
        cost; nothing executes on a device.  ``key_spec``, if given, must be a
        scalar int32 spec (the reference's default)."""
        from repro_torch.launch.op_analysis import analyze

        if key_spec is not None:
            key = _as_meta(key_spec)
            if tuple(key.shape) != () or key.dtype != torch.int32:
                raise RegistryError(f"device key spec must be a scalar int32, got {key_spec!r}")
        costs = {}
        for h in self.handlers:
            out, cost = analyze(h.fn, _as_meta(payload_spec))
            self._check(h, out)
            costs[h.stable_name] = cost
        worst = max(costs.values(), key=lambda c: c.flops)
        return LoweredTable(self._result_spec[1:], costs, worst)


@dataclasses.dataclass
class LoweredTable:
    """What :meth:`DeviceHandlerTable.lower` returns: the branches' common
    result spec (structure, leaf specs), each branch's ``OpCost`` by name,
    and ``cost``, the costliest branch's (a switch runs one branch)."""

    result_spec: Any
    branch_costs: dict
    cost: Any


def _as_meta(tree: Any) -> Any:
    """A payload spec as ``meta`` tensors: tensors keep their shape and dtype,
    ``(shape, dtype)`` pairs become tensors of them."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return torch.empty(x.shape, dtype=x.dtype, device="meta")
        return x

    def walk(x):
        if (isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], torch.dtype)
                and isinstance(x[0], (tuple, list, torch.Size))):
            return torch.empty(tuple(x[0]), dtype=x[1], device="meta")
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(walk(v) for v in x)
        return leaf(x)

    return walk(tree)

