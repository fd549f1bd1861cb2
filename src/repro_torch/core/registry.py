"""Deterministic handler registry — the heart of HAM (paper §4.3, §5.2).

The paper's mechanism:

1. Every active-message type registers its handler during *static
   initialisation* (before ``main()``), keyed by the ``typeid`` mangled name.
2. An explicit ``init()`` call sorts the collected entries by name,
   lexicographically, and assigns the sorted index as the **global handler
   key** — so *all processes derive the identical key map without any
   communication*, as long as they were built from the same source.
3. Sending side: type -> key in O(1) (static member).  Receiving side:
   key -> handler address in O(1) (vector index).  (Fig. 6.)

Python translation:

* "static initialisation"  -> import time; the :func:`handler` decorator
  registers into a module-level pending set.
* ``typeid`` mangled name  -> **stable name** ``module:qualname#spec-digest``.
  The spec digest covers the argument/result specs, mirroring how the C++
  mangled name of ``function<Result(*)(Pars...), FnPtr>`` encodes the
  signature.  Lambdas and closures (``<lambda>`` / ``<locals>`` in the
  qualname) are rejected unless an explicit ``name=`` is supplied — the exact
  caveat the paper hits with compiler-internal lambda names (§5.1), except we
  diagnose it instead of miscompiling.
* ``init()`` -> :meth:`HandlerRegistry.init`, which seals the registry and
  produces the sorted key table plus a **key-map digest** (sha256 over the
  ordered stable names).  The digest lets heterogeneous peers *verify* the
  same-source assumption with one 32-byte compare — the paper merely assumes
  ABI-compatible name mangling; we turn the assumption into a cheap check.

The registry is also re-initialisable with a changed handler set, which is
what makes elastic membership changes cheap at pod scale: a new process
joining a fleet derives the same keys locally, no negotiation (see
``train/ft.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Any, Callable, Sequence

from repro_torch.core.errors import (
    RegistryError,
    RegistrySealedError,
    UnknownHandlerError,
    UnstableNameError,
)
from repro_torch.core.migratable import Spec, canonical_spec_string, spec_of
from repro_torch.core.wireplan import compile_plan


@dataclasses.dataclass(frozen=True)
class HandlerRecord:
    """One registered handler — the analogue of one ``active_msg`` type.

    ``read_only`` declares that the handler never writes through a
    ``buffer_ptr`` argument (it may read via ``deref``, and may mutate its
    own locals freely).  The declaration is a *routing contract*, not a
    sandbox: a replicated-data-plane scheduler may serve a read-only call
    from ANY replica of its buffers, while a call without the declaration
    has its pointers pinned to the primary copy — so a mutating handler
    can never silently update one replica and diverge the others.  It does
    not participate in the stable name (peers may disagree about it
    without breaking key agreement; routing is a sender-side concern).

    ``mutates`` is the write-side twin (Active Access: ship the mutation
    to the data): the handler *intends* to write through its buffer
    arguments in place.  The scheduler pins such a call to the primary and
    the data plane **commits** the write on return — the buffer's dirty
    epoch is bumped and replica holders are invalidated/refreshed, so the
    mutation becomes visible cluster-wide without the host round-tripping
    the bytes (docs/failure-model.md, "Write visibility and convergence").
    Like ``read_only`` it is routing metadata, excluded from the stable
    name.  The two are mutually exclusive.
    """

    stable_name: str
    fn: Callable
    arg_specs: tuple | None      # None => dynamic (self-describing) payload
    result_specs: tuple | None   # None => dynamic result
    doc: str = ""
    read_only: bool = False
    mutates: bool = False

    @property
    def is_static(self) -> bool:
        return self.arg_specs is not None


class HandlerTable:
    """Sealed, initialised key<->handler mapping (paper Fig. 6).

    * ``key_of``   : type -> key, O(1)  (sending side)
    * ``handler_at``: key -> handler, O(1) list index (receiving side)

    Init also *compiles* the wire plans (``repro_torch.core.wireplan``): for every
    static-spec handler, ``arg_plans[key]`` / ``result_plans[key]`` hold the
    precompiled payload codec (fused scalar struct, fixed array extents,
    exact ``payload_nbytes``); dynamic sides hold ``None``.  The dense
    key-indexed arrays are what the runtime hot path dispatches off —
    no per-message record attribute walks.
    """

    def __init__(self, records: Sequence[HandlerRecord]):
        ordered = sorted(records, key=lambda r: r.stable_name)
        self._records: list[HandlerRecord] = list(ordered)
        #: key-indexed views for the runtime hot path (records is the same
        #: list handler_at indexes; plans are compiled once, here)
        self.records: list[HandlerRecord] = self._records
        self.arg_plans = [compile_plan(r.arg_specs) for r in ordered]
        self.result_plans = [compile_plan(r.result_specs) for r in ordered]
        self._key_by_name: dict[str, int] = {
            r.stable_name: i for i, r in enumerate(ordered)
        }
        # base-name aliases (stable name minus the spec digest) where
        # unambiguous — convenience lookup, never used for key derivation
        base_counts: dict[str, int] = {}
        for r in ordered:
            base = r.stable_name.rsplit("#", 1)[0]
            base_counts[base] = base_counts.get(base, 0) + 1
        for i, r in enumerate(ordered):
            base = r.stable_name.rsplit("#", 1)[0]
            if base_counts[base] == 1 and base not in self._key_by_name:
                self._key_by_name[base] = i
        self._key_by_fn: dict[Any, int] = {r.fn: i for i, r in enumerate(ordered)}
        h = hashlib.sha256()
        for r in ordered:
            h.update(r.stable_name.encode("utf-8"))
            h.update(b"\x00")
        self.digest: bytes = h.digest()

    def __len__(self) -> int:
        return len(self._records)

    def __iter__(self):
        return iter(self._records)

    def key_of(self, fn_or_name) -> int:
        if isinstance(fn_or_name, str):
            try:
                return self._key_by_name[fn_or_name]
            except KeyError:
                raise UnknownHandlerError(f"no handler named {fn_or_name!r}") from None
        try:
            return self._key_by_fn[fn_or_name]
        except (KeyError, TypeError):
            raise UnknownHandlerError(
                f"function {getattr(fn_or_name, '__qualname__', fn_or_name)!r} is "
                "not a registered handler; decorate it with @ham.handler"
            ) from None

    def handler_at(self, key: int) -> HandlerRecord:
        if not 0 <= key < len(self._records):
            raise UnknownHandlerError(
                f"handler key {key} outside local table of size {len(self._records)}; "
                "peer key maps diverge (same-source assumption violated)"
            )
        return self._records[key]

    def record_of(self, fn_or_name) -> HandlerRecord:
        return self._records[self.key_of(fn_or_name)]

    def dump(self) -> str:
        """Human-readable handler map + vector, mirroring the paper's Fig. 7."""
        lines = ["======== BEGIN HANDLER MAP ========"]
        for r in self._records:
            lines.append(f"stable_name: {r.stable_name}")
            lines.append(f"handler: {r.fn!r}")
        lines.append("======== END HANDLER MAP ==========")
        lines.append("====== BEGIN HANDLER VECTOR =======")
        for i, r in enumerate(self._records):
            lines.append(f"index: {i}, handler: {r.fn.__qualname__}")
        lines.append("====== END HANDLER VECTOR =========")
        return "\n".join(lines)


def _derive_stable_name(fn: Callable, specs: tuple | None, explicit: str | None) -> str:
    if explicit is not None:
        base = explicit
    else:
        qualname = getattr(fn, "__qualname__", None)
        module = getattr(fn, "__module__", None)
        if qualname is None or module is None:
            raise UnstableNameError(
                f"cannot derive a stable name for {fn!r}; pass name= explicitly"
            )
        if "<lambda>" in qualname or "<locals>" in qualname:
            raise UnstableNameError(
                f"{module}:{qualname} is not stable across processes (the "
                "paper's lambda caveat, §5.1): lambdas and closures get "
                "compiler/interpreter-internal names.  Register with an "
                "explicit name= (the l2f route)."
            )
        base = f"{module}:{qualname}"
    if specs is None:
        return base + "#dyn"
    digest = hashlib.sha256(canonical_spec_string(specs).encode()).hexdigest()[:12]
    return f"{base}#{digest}"


def _validate_registration(fn, arg_specs, result_specs, name) -> None:
    """Call-time twin of the static checks in ``repro_torch.analysis.hamlint``:
    everything hamlint rejects statically that is *cheap* to verify here is
    rejected at the registration site too, so the dynamic path and the
    static pass can never disagree silently.

    Two checks: (1) a static ``arg_specs`` tuple must match the function's
    positional arity (skipped for ``*args`` signatures and C callables
    without introspectable signatures); (2) static specs must actually be
    wire-plan-compilable — a bad leaf fails HERE, naming the handler, not
    at ``init()`` in a different stack frame.
    """
    import inspect

    if arg_specs is not None:
        try:
            sig = inspect.signature(fn)
        except (TypeError, ValueError):
            sig = None
        if sig is not None:
            params = list(sig.parameters.values())
            has_varargs = any(
                p.kind is inspect.Parameter.VAR_POSITIONAL for p in params
            )
            positional = [
                p for p in params
                if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                              inspect.Parameter.POSITIONAL_OR_KEYWORD)
            ]
            if not has_varargs and len(arg_specs) != len(positional):
                raise RegistryError(
                    f"handler {name or getattr(fn, '__qualname__', fn)!r}: "
                    f"arg_specs declares {len(arg_specs)} leaves but the "
                    f"function takes {len(positional)} positional "
                    "parameters — the wire payload and the call would "
                    "disagree (hamlint: spec-coherence)"
                )
    for label, specs in (("arg_specs", arg_specs),
                         ("result_specs", result_specs)):
        if specs is None:
            continue
        try:
            compile_plan(specs)
        except Exception as e:
            raise RegistryError(
                f"handler {name or getattr(fn, '__qualname__', fn)!r}: "
                f"{label} is not wire-plan compilable: {e}"
            ) from e


class HandlerRegistry:
    """Collects handler registrations, then seals into a :class:`HandlerTable`.

    ``construct on first use``: the default process-global registry is created
    lazily by :func:`default_registry`, mirroring the paper's idiom for
    guaranteeing static-initialisation order.
    """

    def __init__(self):
        self._pending: dict[str, HandlerRecord] = {}
        self._table: HandlerTable | None = None
        self._lock = threading.Lock()
        self._allow_late = False  # elastic mode: permit re-init after seal

    # -- registration (static-init phase) ---------------------------------

    def register(
        self,
        fn: Callable,
        *,
        arg_specs: tuple | None = None,
        result_specs: tuple | None = None,
        name: str | None = None,
        doc: str = "",
        read_only: bool = False,
        mutates: bool = False,
    ) -> HandlerRecord:
        _validate_registration(fn, arg_specs, result_specs, name)
        if read_only and mutates:
            raise RegistryError(
                f"handler {name or getattr(fn, '__qualname__', fn)!r}: "
                "read_only=True and mutates=True are mutually exclusive — "
                "a handler either never writes through its buffers or "
                "declares that it does"
            )
        stable = _derive_stable_name(fn, arg_specs, name)
        record = HandlerRecord(stable, fn, arg_specs, result_specs, doc,
                               read_only, mutates)
        with self._lock:
            if self._table is not None and not self._allow_late:
                raise RegistrySealedError(
                    f"registry already initialised; cannot register {stable!r}. "
                    "Re-init explicitly for elastic membership changes."
                )
            existing = self._pending.get(stable)
            if existing is not None and existing.fn is not fn:
                raise RegistryError(
                    f"stable-name collision: {stable!r} registered twice with "
                    "different functions"
                )
            self._pending[stable] = record
            if self._table is not None:
                # late registration in elastic mode invalidates the seal
                self._table = None
        return record

    def handler(
        self,
        fn: Callable | None = None,
        *,
        args: Sequence[Any] | None = None,
        arg_specs: tuple | None = None,
        result_specs: tuple | None = None,
        name: str | None = None,
        read_only: bool = False,
        mutates: bool = False,
    ):
        """Decorator form.  ``args=`` gives example values to derive a static
        spec from (the ``Pars...`` of the closure template); ``arg_specs=``
        passes specs directly; neither => dynamic payload.  ``read_only=True``
        declares the handler never writes through a ``buffer_ptr`` argument
        (see :class:`HandlerRecord`) — it is what allows a replicated data
        plane to serve the call from any replica.  ``mutates=True`` declares
        the opposite intent: the handler writes buffers in place, the call is
        pinned to the primary, and the data plane commits the write (dirty
        epoch bump + replica invalidation) when it returns."""

        def wrap(f: Callable) -> Callable:
            specs = arg_specs
            if specs is None and args is not None:
                specs = tuple(spec_of(a) for a in args)
            self.register(f, arg_specs=specs, result_specs=result_specs,
                          name=name, read_only=read_only, mutates=mutates)
            return f

        if fn is not None:
            return wrap(fn)
        return wrap

    # -- init (explicit, like the paper's init() from main()) --------------

    def init(self, *, allow_late_registration: bool = False) -> HandlerTable:
        with self._lock:
            self._allow_late = allow_late_registration
            self._table = HandlerTable(list(self._pending.values()))
            return self._table

    def reinit(self) -> HandlerTable:
        """Re-seal after late registrations — the elastic-membership path.

        A process that registered handlers after ``init()`` (in
        ``allow_late_registration`` mode) re-derives the key table here,
        keeping its late-registration setting; every other member derives
        the identical table from the same source, no negotiation (paper
        §5.2).  Whether members actually agree is checked separately:
        ``verify_peer_digest`` compares table digests, and
        ``ClusterPool.add_node`` runs that check on every elastic join.
        """
        return self.init(allow_late_registration=self._allow_late)

    @property
    def table(self) -> HandlerTable:
        if self._table is None:
            raise RegistryError(
                "registry not initialised; call init() before exchanging "
                "active messages (paper §5.2, step two)"
            )
        return self._table

    @property
    def initialised(self) -> bool:
        return self._table is not None

    def pending_names(self) -> list[str]:
        with self._lock:
            return sorted(self._pending)

    def pending_records(self) -> list[HandlerRecord]:
        with self._lock:
            return [self._pending[k] for k in sorted(self._pending)]

    def fork(self) -> "HandlerRegistry":
        """Copy of the pending set (for tests / simulated processes)."""
        clone = HandlerRegistry()
        with self._lock:
            clone._pending = dict(self._pending)
        return clone


# -- process-global default registry ("construct on first use") -----------

_default: HandlerRegistry | None = None
_default_lock = threading.Lock()


def default_registry() -> HandlerRegistry:
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = HandlerRegistry()
    return _default


def handler(fn=None, **kw):
    """``@ham.handler`` — register into the process-global registry."""
    return default_registry().handler(fn, **kw)


def init(**kw) -> HandlerTable:
    """``ham.init()`` — seal the process-global registry (call from main)."""
    return default_registry().init(**kw)


def verify_peer_digest(local: HandlerTable, peer_digest: bytes) -> None:
    """32-byte handshake that *verifies* the paper's same-source assumption."""
    if local.digest != peer_digest:
        from repro_torch.core.errors import KeyMapMismatchError

        raise KeyMapMismatchError(
            "peer handler-table digest differs from local digest; processes "
            "were built from different handler sets (the heterogeneous "
            "same-source assumption is violated)"
        )
