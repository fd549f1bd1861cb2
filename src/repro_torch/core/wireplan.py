"""Compiled per-handler wire plans — the static-payload fast path.

Paper mapping (§4.3): a static-spec handler's argument (and result) layout is
part of the *message type*, known to both sides at registration time.  The
generic :func:`repro_torch.core.migratable.pack_static` walks the spec tuple per
message — isinstance dispatch, ``str(dtype)`` comparisons, one ``struct``
call per scalar leaf.  A :class:`WirePlan` hoists that walk to
``HandlerTable`` init: the spec tuple is compiled **once** into

* one fused :class:`struct.Struct` per *run* of consecutive scalar leaves
  (an all-scalar spec becomes a single ``pack_into``/``unpack_from``),
* fixed ``(offset, nbytes, dtype, shape)`` extents for array leaves
  (encode = one slice copy, decode = one zero-copy ``np.frombuffer`` view),
* fixed extents + codec hooks for opaque leaves,

plus the exact ``payload_nbytes`` — so the per-message cost is one closure
call, no spec traversal.  The wire layout is byte-identical to
``pack_static`` (raw leaf concatenation, little-endian), which is what makes
the ``FLAG_STATIC`` header bit *informational*: a plan-packed frame decodes
with ``unpack_static`` and vice versa (wire compat with pre-plan peers).

Result plans reuse the same layout with an arity convention mirroring
Python returns: ``result_specs=()`` ⇒ the handler returns ``None`` (0-byte
reply), one spec ⇒ the bare value, N specs ⇒ an N-tuple.
"""

from __future__ import annotations

import struct

import numpy as np

from repro_torch.core.errors import MigratableError, SpecMismatchError
from repro_torch.core.migratable import (
    _CODECS_BY_NAME,
    ArraySpec,
    OpaqueSpec,
    ScalarSpec,
    as_numpy,
    static_payload_nbytes,
)

_SCALAR_FMT = {"i8": "q", "f8": "d", "b1": "?"}
#: pack-side coercions matching ``pack_static`` (np scalars, bools, ints all
#: land on the pinned fixed-width wire types)
_SCALAR_CONV = {"i8": int, "f8": float, "b1": bool}


class _ScalarRun:
    """A run of consecutive scalar leaves fused into one struct."""

    __slots__ = ("offset", "st", "convs", "n")

    def __init__(self, offset: int, kinds: list[str]):
        self.offset = offset
        self.st = struct.Struct("<" + "".join(_SCALAR_FMT[k] for k in kinds))
        self.convs = tuple(_SCALAR_CONV[k] for k in kinds)
        self.n = len(kinds)


class _ArrayLeaf:
    __slots__ = ("offset", "nbytes", "shape", "dtype", "reshape")

    def __init__(self, offset: int, spec: ArraySpec):
        self.offset = offset
        self.nbytes = spec.nbytes
        self.shape = spec.shape
        self.dtype = np.dtype(spec.dtype)
        n = self.nbytes // self.dtype.itemsize
        self.reshape = self.shape != (n,)


class _OpaqueLeaf:
    __slots__ = ("offset", "nbytes", "type_name")

    def __init__(self, offset: int, spec: OpaqueSpec):
        self.offset = offset
        self.nbytes = spec.nbytes_fixed
        self.type_name = spec.type_name

    def _codec(self):
        codec = _CODECS_BY_NAME.get(self.type_name)
        if codec is None:
            raise MigratableError(
                f"no codec registered locally for {self.type_name}; "
                "heterogeneous processes must register the same migratable "
                "specialisations (same-source assumption)"
            )
        return codec

    def pack(self, buf, base: int, args, i: int) -> None:
        raw = self._codec().encode(args[i])
        if len(raw) != self.nbytes:
            raise SpecMismatchError(
                f"codec {self.type_name} produced {len(raw)} bytes, "
                f"spec says {self.nbytes}"
            )
        off = base + self.offset
        buf[off : off + self.nbytes] = raw

    def unpack_one(self, view):
        return self._codec().decode(
            bytes(view[self.offset : self.offset + self.nbytes])
        )


def _compile_ops(specs):
    ops = []
    off = 0
    run_kinds: list[str] = []
    run_off = 0
    for spec in specs:
        if isinstance(spec, ScalarSpec):
            if not run_kinds:
                run_off = off
            run_kinds.append(spec.kind)
            off += spec.nbytes
            continue
        if run_kinds:
            ops.append(_ScalarRun(run_off, run_kinds))
            run_kinds = []
        if isinstance(spec, ArraySpec):
            ops.append(_ArrayLeaf(off, spec))
        elif isinstance(spec, OpaqueSpec):
            ops.append(_OpaqueLeaf(off, spec))
        else:
            raise MigratableError(f"unknown spec {spec!r}")
        off += spec.nbytes
    if run_kinds:
        ops.append(_ScalarRun(run_off, run_kinds))
    return ops, off


def _raise_nargs(expected: int, got: int):
    raise SpecMismatchError(f"expected {expected} args, got {got}")


def _raise_short(expected: int, got: int):
    raise SpecMismatchError(f"static payload too short: {got} < {expected}")


def _raise_scalar(e):
    raise SpecMismatchError(f"scalar leaf pack failed: {e}") from None


def _raise_array(leaf: _ArrayLeaf, arr):
    raise SpecMismatchError(
        f"array leaf mismatch: expected {leaf.dtype}{leaf.shape}, "
        f"got {arr.dtype}{tuple(arr.shape)}"
    )


def _gen_codecs(specs, ops, nbytes):
    """exec-generate straight-line ``pack(buf, off, args)`` and
    ``unpack(view)`` functions for a spec tuple.

    This is the "compiled" in compiled wire plans: the per-message cost is
    one specialised function whose body is the layout — no spec traversal,
    no per-leaf dispatch, every helper pre-bound in the closure namespace
    (the same technique ``collections.namedtuple`` uses).  Opaque leaves
    keep calling their leaf op (codec resolution stays lazy).
    """
    ns = {
        "_np": np,
        "_frombuffer": np.frombuffer,
        "_ndarray": np.ndarray,
        "_asarray": as_numpy,
        "_ascontig": np.ascontiguousarray,
        "_copyto": np.copyto,
        "_uint8": np.uint8,
        "_struct_error": struct.error,
        "_raise_nargs": _raise_nargs,
        "_raise_short": _raise_short,
        "_raise_scalar": _raise_scalar,
        "_raise_array": _raise_array,
    }
    pack_lines = [
        "def _pack(buf, off, args):",
        f"    if len(args) != {len(specs)}: _raise_nargs({len(specs)}, len(args))",
    ]
    unpack_parts: list[str] = []
    i = 0
    for k, op in enumerate(ops):
        if isinstance(op, _ScalarRun):
            ns[f"_p{k}"] = op.st.pack_into
            ns[f"_u{k}"] = op.st.unpack_from
            vals = []
            for j, conv in enumerate(op.convs):
                cname = f"_c{k}_{j}"
                ns[cname] = conv
                vals.append(f"{cname}(args[{i + j}])")
            pack_lines += [
                "    try:",
                f"        _p{k}(buf, off + {op.offset}, {', '.join(vals)})",
                "    except (_struct_error, TypeError, ValueError) as e:",
                "        _raise_scalar(e)",
            ]
            unpack_parts.append(f"*_u{k}(view, {op.offset})")
            i += op.n
        elif isinstance(op, _ArrayLeaf):
            ns[f"_leaf{k}"] = op
            ns[f"_dt{k}"] = op.dtype
            pack_lines += [
                f"    a = args[{i}]",
                "    if not isinstance(a, _ndarray): a = _asarray(a)",
                "    d = a.dtype",
                f"    if (d is not _dt{k} and d != _dt{k}) "
                f"or a.shape != {op.shape!r}: _raise_array(_leaf{k}, a)",
            ]
            if op.nbytes <= 4096:
                # small leaf: one C-level tobytes + slice assign beats
                # building two view arrays (and handles non-contiguous
                # inputs for free)
                pack_lines.append(
                    f"    buf[off + {op.offset} : off + {op.offset + op.nbytes}]"
                    " = a.tobytes()"
                )
            else:
                # big leaf: single copy straight into the frame, no
                # temporary — frombuffer rather than slice assignment
                # (bytearray slices reject ndarrays)
                pack_lines += [
                    "    if not a.flags.c_contiguous: a = _ascontig(a)",
                    f"    _copyto(_frombuffer(buf, _uint8, {op.nbytes}, "
                    f"off + {op.offset}), a.view(_uint8).reshape(-1))",
                ]
            count = op.nbytes // op.dtype.itemsize
            expr = f"_frombuffer(view, _dt{k}, {count}, {op.offset})"
            if op.reshape:
                expr += f".reshape({op.shape!r})"
            unpack_parts.append(expr)
            i += 1
        else:  # _OpaqueLeaf: codec resolution stays lazy behind the op
            ns[f"_leaf{k}"] = op
            pack_lines.append(f"    _leaf{k}.pack(buf, off, args, {i})")
            unpack_parts.append(f"_leaf{k}.unpack_one(view)")
            i += 1
    body = ", ".join(unpack_parts)
    unpack_lines = [
        "def _unpack(view):",
        f"    if len(view) < {nbytes}: _raise_short({nbytes}, len(view))",
        f"    return ({body}{',' if len(unpack_parts) == 1 else ''})",
    ]
    if not unpack_parts:
        unpack_lines[-1] = "    return ()"
    exec("\n".join(pack_lines), ns)          # noqa: S102 — trusted codegen
    exec("\n".join(unpack_lines), ns)        # noqa: S102
    return ns["_pack"], ns["_unpack"]


class WirePlan:
    """Precompiled codec for one static spec tuple (see module docs).

    ``pack_args``/``unpack_args`` are exec-generated straight-line functions
    specialised to the layout; the ``*_result`` variants apply the
    result-arity convention on the same layout.  Array leaves decode as
    zero-copy views into the payload — the caller owns the lifetime rule
    (copy anything that outlives the frame).
    """

    __slots__ = ("specs", "nbytes", "n_args", "_ops", "_solo_st",
                 "_solo_conv", "pack_args", "unpack_args")

    def __init__(self, specs: tuple):
        self.specs = tuple(specs)
        self._ops, self.nbytes = _compile_ops(self.specs)
        assert self.nbytes == static_payload_nbytes(self.specs)
        self.n_args = len(self.specs)
        self.pack_args, self.unpack_args = _gen_codecs(
            self.specs, self._ops, self.nbytes
        )
        # hottest result shape: a single scalar (one struct call, no tuple
        # wrapping on the reply hot path)
        if self.n_args == 1 and isinstance(self._ops[0], _ScalarRun):
            self._solo_st = self._ops[0].st
            self._solo_conv = self._ops[0].convs[0]
        else:
            self._solo_st = self._solo_conv = None

    # -- result side (arity convention) ------------------------------------

    def pack_result(self, buf, off: int, result) -> None:
        n = self.n_args
        if n == 1:
            st = self._solo_st
            if st is not None:
                try:
                    st.pack_into(buf, off, self._solo_conv(result))
                except (struct.error, TypeError, ValueError) as e:
                    raise SpecMismatchError(
                        f"scalar result pack failed: {e}"
                    ) from None
                return
            self.pack_args(buf, off, (result,))
        elif n == 0:
            if result is not None:
                raise SpecMismatchError(
                    f"handler declared result_specs=() but returned {result!r}"
                )
        else:
            if not isinstance(result, (tuple, list)):
                raise SpecMismatchError(
                    f"handler declared {n} result leaves but returned "
                    f"{type(result).__name__}"
                )
            self.pack_args(buf, off, result)

    def unpack_result(self, payload):
        n = self.n_args
        if n == 0:
            return None
        st = self._solo_st
        if st is not None:
            return st.unpack_from(payload, 0)[0]
        values = self.unpack_args(payload)
        return values[0] if n == 1 else values


def compile_plan(specs) -> WirePlan | None:
    """``None`` specs (dynamic handler side) compile to no plan."""
    return None if specs is None else WirePlan(specs)


# ---------------------------------------------------------------------------
# Shape-keyed plan cache (the FLAG_SHAPED dynamic fast path)
# ---------------------------------------------------------------------------
#
# Dynamic handlers have no registered spec, so every call used to walk the
# TLV codec per leaf (~25 µs of interpreter for a small pytree).  But real
# dynamic traffic repeats its *shape* call-to-call: same scalars, same array
# dtypes/shapes, different values.  spec_of() already maps a value to a
# hashable frozen Spec, so the value tuple's spec tuple is a cache key, and
# a cached exec-generated WirePlan gives repeat shapes the same
# straight-line pack/unpack as static specs.
#
# The wire carries a compact *signature* so the receiver can rebuild (and
# cache) the identical plan without any registration handshake:
#
#     signature := arity_tag canonical_spec_string
#     arity_tag := "A"   args tuple        (request: unpack -> tuple)
#                | "V"   bare value        (reply: unpack -> values[0])
#                | "T"   tuple result      (reply: unpack -> tuple)
#
# The tag disambiguates the one case the spec tuple cannot: a handler that
# returned a 1-tuple vs a bare value.  ``None`` results and shapes the spec
# grammar cannot express (str/bytes/lists/dicts/None leaves) stay on TLV —
# FLAG_SHAPED is an opportunistic overlay, never a requirement.

_SIG_ARITIES = ("A", "V", "T")
_SIG_LEAF_RE = None  # compiled lazily (re import cost off the hot path)


def spec_signature(specs, arity: str) -> bytes:
    """Wire signature for a spec tuple (grammar above)."""
    if arity not in _SIG_ARITIES:
        raise MigratableError(f"bad signature arity {arity!r}")
    from repro_torch.core.migratable import canonical_spec_string

    return (arity + canonical_spec_string(specs)).encode("ascii")


def parse_signature(sig: bytes) -> tuple[str, tuple]:
    """Inverse of :func:`spec_signature`: ``(arity, spec_tuple)``.

    Raises :class:`MigratableError` on any malformed signature — the caller
    treats that as a protocol error, not a fallback.
    """
    global _SIG_LEAF_RE
    if _SIG_LEAF_RE is None:
        import re

        # leaf tokens never contain ']' internally: scalar kinds are [a-z0-9],
        # dtypes come from str(np.dtype) of a biufc-kind array, opaque names
        # are module:qualname
        _SIG_LEAF_RE = re.compile(
            rb"scalar\[([^\]]*)\]|array\[([^;\]]*);([^\]]*)\]|opaque\[([^;\]]*);(\d+)\]"
        )
    try:
        text = sig.decode("ascii")
    except UnicodeDecodeError as e:
        raise MigratableError(f"undecodable shape signature: {e}") from None
    if not text or text[0] not in _SIG_ARITIES:
        raise MigratableError(f"bad shape signature arity in {text[:32]!r}")
    arity, body = text[0], text[1:]
    if not (body.startswith("(") and body.endswith(")")):
        raise MigratableError(f"bad shape signature body {body[:32]!r}")
    specs = []
    for m in _SIG_LEAF_RE.finditer(sig, 1):
        kind, adtype, dims, oname, onbytes = m.groups()
        if kind is not None:
            if kind.decode() not in _SCALAR_FMT:
                raise MigratableError(f"unknown scalar kind {kind!r}")
            specs.append(ScalarSpec(kind.decode()))
        elif adtype is not None:
            shape = tuple(int(d) for d in dims.split(b",")) if dims else ()
            specs.append(ArraySpec(shape, adtype.decode()))
        else:
            specs.append(OpaqueSpec(oname.decode(), int(onbytes)))
    # reject trailing garbage / unrecognised leaves: rebuilding the body
    # from what parsed must reproduce the wire bytes exactly
    if "(" + ",".join(s.canonical() for s in specs) + ")" != body:
        raise MigratableError(f"unparseable shape signature {body[:64]!r}")
    return arity, tuple(specs)


class ShapeCache:
    """Bounded LRU of shape-keyed :class:`WirePlan` s, both directions.

    Send side keys on the *spec tuple* (derived from live values via
    ``spec_of`` — a few hundred ns for small pytrees); receive side keys on
    the raw signature bytes from the wire.  Entries are tiny (a compiled
    plan + signature), so the default bound of 256 distinct shapes per side
    is generous; eviction is plain LRU under one lock (both hooks are
    called from runtime loop threads *and* user threads).
    """

    __slots__ = ("maxsize", "_lock", "_by_key", "_by_sig",
                 "hits", "misses", "evictions")

    def __init__(self, maxsize: int = 256):
        from collections import OrderedDict
        from threading import Lock

        self.maxsize = maxsize
        self._lock = Lock()
        self._by_key: dict = OrderedDict()   # spec-tuple+arity -> (sig, plan)
        self._by_sig: dict = OrderedDict()   # sig bytes -> (arity, plan)
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- send side ---------------------------------------------------------
    @staticmethod
    def _fast_key(values, arity: str):
        """Hashable shape key without constructing Spec objects (~0.3 µs per
        leaf vs ~3 µs for ``spec_of``).  ``None`` -> take the spec_of path
        (np scalar subtypes, codec'd opaques, array-likes)."""
        key = [arity]
        append = key.append
        for v in values:
            t = type(v)
            if t is int:
                append("i")
            elif t is float:
                append("f")
            elif t is bool:
                append("b")
            elif t is np.ndarray and v.dtype.kind in "biufc":
                append((v.dtype, v.shape))
            else:
                return None
        return tuple(key)

    def for_values(self, values, arity: str):
        """``(signature, plan)`` for a tuple of leaf values, or ``None``
        when any leaf is outside the spec grammar (caller falls back to
        TLV).  ``arity`` is the wire tag ("A"/"V"/"T")."""
        key = self._fast_key(values, arity)
        if key is None:
            from repro_torch.core.migratable import spec_of

            try:
                key = (arity, tuple(spec_of(v) for v in values))
            except MigratableError:
                return None
        with self._lock:
            ent = self._by_key.get(key)
            if ent is not None:
                self._by_key.move_to_end(key)
                self.hits += 1
                return ent
        # miss: derive the authoritative spec tuple (the fast key maps 1:1
        # onto it — exact int/float/bool/ndarray types only)
        from repro_torch.core.migratable import spec_of

        try:
            specs = tuple(spec_of(v) for v in values)
        except MigratableError:
            return None
        sig = spec_signature(specs, arity)
        plan = WirePlan(specs)
        with self._lock:
            self.misses += 1
            self._by_key[key] = (sig, plan)
            if len(self._by_key) > self.maxsize:
                self._by_key.popitem(last=False)
                self.evictions += 1
        return sig, plan

    def for_result(self, result):
        """Shape entry for a reply value (``None``/non-speccable -> TLV)."""
        if result is None:
            return None
        if isinstance(result, tuple):
            return self.for_values(result, "T")
        return self.for_values((result,), "V")

    # -- receive side ------------------------------------------------------
    def for_signature(self, sig: bytes):
        """``(arity, plan)`` for raw signature bytes off the wire.

        Malformed signatures raise :class:`MigratableError` (protocol
        error); unknown-but-wellformed shapes compile and cache."""
        with self._lock:
            ent = self._by_sig.get(sig)
            if ent is not None:
                self._by_sig.move_to_end(sig)
                self.hits += 1
                return ent
        arity, specs = parse_signature(sig)
        plan = WirePlan(specs)
        with self._lock:
            self.misses += 1
            self._by_sig[sig] = (arity, plan)
            if len(self._by_sig) > self.maxsize:
                self._by_sig.popitem(last=False)
                self.evictions += 1
        return arity, plan

    def unpack_shaped(self, payload, *, expect_args: bool):
        """Decode a FLAG_SHAPED payload: u16 sig_len | sig | packed leaves.

        ``expect_args=True`` (request side) returns a tuple regardless of
        tag; the reply side honours the V/T arity convention.
        """
        (sig_len,) = SIG_LEN_STRUCT.unpack_from(payload, 0)
        sig = bytes(payload[2 : 2 + sig_len])
        arity, plan = self.for_signature(sig)
        values = plan.unpack_args(payload[2 + sig_len :])
        if expect_args or arity == "T":
            return values
        if arity == "V":
            return values[0]
        return values  # "A" payload surfacing on the reply path

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "send_entries": len(self._by_key),
                "recv_entries": len(self._by_sig),
            }


#: length prefix of the signature in a FLAG_SHAPED payload
SIG_LEN_STRUCT = struct.Struct("<H")
SIG_LEN_NBYTES = SIG_LEN_STRUCT.size  # 2


def pack_shaped(sig: bytes, plan: WirePlan, values) -> bytearray:
    """Standalone FLAG_SHAPED payload (the fused-segment path; the
    standalone-frame path packs straight into the frame buffer)."""
    buf = bytearray(SIG_LEN_NBYTES + len(sig) + plan.nbytes)
    SIG_LEN_STRUCT.pack_into(buf, 0, len(sig))
    buf[SIG_LEN_NBYTES : SIG_LEN_NBYTES + len(sig)] = sig
    plan.pack_args(buf, SIG_LEN_NBYTES + len(sig), values)
    return buf
