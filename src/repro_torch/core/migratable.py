"""Migratable values: per-type serialisation between address spaces.

Paper mapping (§4.3, §5.1):

* ``migratable<T>``      -> the codec registry in this module.  A type that
  cannot be bitwise-copied provides an *encode* hook (converting constructor)
  and a *decode* hook (conversion operator).
* ``is_bitwise_copyable`` -> :func:`is_bitwise_migratable`; violations raise
  :class:`NotBitwiseMigratableError` at closure-construction time, the
  Python analogue of the paper's compile-time trap.
* The tuple ``std::tuple<migratable<Pars>...>`` storing a closure's arguments
  corresponds to the **static pack** path: the receiving side knows the
  argument specs *from the handler's registration* (the message type), so the
  payload is a raw concatenation of fixed-size leaf bytes — no per-message
  descriptors, which is what makes the fast path fast.
* A **dynamic (self-describing) pack** path exists for `put`/`get` of
  arbitrary pytrees, analogous to serialising a non-trivial type through a
  ``migratable`` specialisation.

Endianness is pinned little-endian; implementation-defined-width Python ints
are pinned to int64 (the paper's §6 advice: avoid ``int``/``long double``,
use fixed-size types).

Port of ``repro.core.migratable``, byte for byte on the wire.  Where the
reference accepts a ``jax.Array`` as an array leaf, the port accepts a
``torch.Tensor`` (:func:`as_numpy`): a CPU tensor travels as its numpy view
(the same ``_T_NDARRAY`` leaf, dtype string, shape and bytes), a CUDA tensor
is staged through pinned host memory first, and decoding yields an ndarray,
as in the reference.  The module never imports torch: it recognises a
tensor only once ``torch`` is loaded, so wire-only processes stay light.
"""

from __future__ import annotations

import dataclasses
import struct
import sys
from typing import Any, Callable

import numpy as np

from repro_torch.core.errors import (
    MigratableError,
    NotBitwiseMigratableError,
    SpecMismatchError,
)

# --------------------------------------------------------------------------
# Argument specs (the "Pars..." of the closure template)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """Fixed-shape, fixed-dtype array leaf — bitwise migratable."""

    shape: tuple
    dtype: str  # canonical numpy dtype string, e.g. "float32"

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n * np.dtype(self.dtype).itemsize

    def canonical(self) -> str:
        return f"array[{self.dtype};{','.join(str(int(d)) for d in self.shape)}]"


@dataclasses.dataclass(frozen=True)
class ScalarSpec:
    """Fixed-width scalar leaf.  kind in {'i8','f8','b1'} (int64/float64/bool)."""

    kind: str

    _SIZES = {"i8": 8, "f8": 8, "b1": 1}

    @property
    def nbytes(self) -> int:
        return self._SIZES[self.kind]

    def canonical(self) -> str:
        return f"scalar[{self.kind}]"


@dataclasses.dataclass(frozen=True)
class OpaqueSpec:
    """Custom registered type with a fixed-size wire format."""

    type_name: str
    nbytes_fixed: int

    @property
    def nbytes(self) -> int:
        return self.nbytes_fixed

    def canonical(self) -> str:
        return f"opaque[{self.type_name};{self.nbytes_fixed}]"


Spec = Any  # ArraySpec | ScalarSpec | OpaqueSpec


def canonical_spec_string(specs) -> str:
    """Canonical textual form of an argument spec tuple.

    Feeds the registry's stable-name digest — the analogue of the signature
    part of the C++ mangled name, so two handlers with the same qualname but
    different argument specs get different identities.
    """
    return "(" + ",".join(s.canonical() for s in specs) + ")"


# --------------------------------------------------------------------------
# Custom codec registry (migratable<T> specialisations)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Codec:
    type_name: str
    py_type: type
    encode: Callable[[Any], bytes]          # converting constructor
    decode: Callable[[bytes], Any]          # conversion operator
    nbytes_fixed: int | None                # None => dynamic size only
    locality: Callable[[Any], int | None] | None = None  # owning node hint
    #: bytes the value stands for AT its owning node (a buffer_ptr's remote
    #: buffer size) — weights locality votes; None => weight 1
    locality_nbytes: Callable[[Any], int] | None = None


_CODECS_BY_TYPE: dict[type, _Codec] = {}
_CODECS_BY_NAME: dict[str, _Codec] = {}


def register_migratable(
    py_type: type,
    encode: Callable[[Any], bytes],
    decode: Callable[[bytes], Any],
    *,
    type_name: str | None = None,
    nbytes_fixed: int | None = None,
    locality: Callable[[Any], int | None] | None = None,
    locality_nbytes: Callable[[Any], int] | None = None,
) -> None:
    """Register a ``migratable`` specialisation for ``py_type``.

    ``nbytes_fixed`` enables use in *static* handler specs (fixed wire size);
    without it the type is only usable on the dynamic path.

    ``encode`` must be deterministic (same value -> same bytes, in particular
    the same length): the dynamic pack path measures frames with one encode
    call and packs with another, so a length that varies between calls would
    corrupt the frame.

    ``locality`` optionally maps a value to the node that *owns* it (e.g. a
    ``buffer_ptr``'s address space).  Locality-aware schedulers use it to
    route a call to the data instead of moving the data to the call — the
    data-centric dispatch of Active Access.  ``locality_nbytes`` sizes that
    vote: the bytes the value stands for at its owner (a buffer_ptr's
    remote buffer size), so a node holding 100 MB outweighs one holding
    three 8-byte scalars regardless of pointer count.
    """
    name = type_name or f"{py_type.__module__}:{py_type.__qualname__}"
    codec = _Codec(name, py_type, encode, decode, nbytes_fixed, locality,
                   locality_nbytes)
    _CODECS_BY_TYPE[py_type] = codec
    _CODECS_BY_NAME[name] = codec


def codec_for(value: Any) -> _Codec | None:
    return _CODECS_BY_TYPE.get(type(value))


def locality_of(value: Any) -> int | None:
    """Owning node of ``value`` per its codec's locality hook, else None."""
    codec = _CODECS_BY_TYPE.get(type(value))
    if codec is None or codec.locality is None:
        return None
    return codec.locality(value)


#: container-nesting bound shared by every submit-path argument walk
#: (``scan_locality`` here, ``BufferDirectory.resolve_args`` in the
#: dataplane).  The two walks MUST agree: a pointer deep enough to vote
#: must also be deep enough to be rewritten, or locality routing could
#: ship a frame whose stale hint fails the holder's own-address-space
#: dereference check.
MAX_SCAN_DEPTH = 32


def scan_locality(values, max_items: int = 64, resolver=None) -> dict[int, int]:
    """Byte-weighted locality votes across a shallow pytree of arguments.

    Returns ``{node: weight}`` over every leaf with a registered locality
    hook, walking at most ``max_items`` leaves (schedulers run this per
    submit — it must stay O(small)).  Containers are descended one level at
    a time, at most ``MAX_SCAN_DEPTH`` levels deep (the same bound the
    directory's ``resolve_args`` rewrite walk applies, so a vote always
    implies a rewritable pointer); everything else is a leaf.

    A leaf's vote weighs its ``locality_nbytes`` (the data it stands for at
    its owner — a buffer_ptr's remote buffer size), clamped to >= 1 so a
    value of unknown size still counts.  Routing to the most-bytes node is
    what makes "move the compute, not the data" true when buffer sizes are
    skewed: under the old count-per-pointer scheme a node owning one 8-byte
    scalar could outvote a node owning a 100 MB tensor.

    ``resolver`` widens a leaf's vote beyond the codec's single-node hint:
    called per leaf, it may return ``{node: weight}`` (used as-is) or None
    (fall through to the codec).  A cluster's ``BufferDirectory`` supplies
    one so a replicated buffer votes for EVERY live holder — any copy can
    serve a read, which is what makes locality routing survive the primary.
    """
    votes: dict[int, int] = {}
    top = list(values) if isinstance(values, (list, tuple)) else [values]
    stack = [(v, 0) for v in top]
    seen = 0
    while stack and seen < max_items:
        v, depth = stack.pop()
        seen += 1
        if isinstance(v, (list, tuple)):
            if depth < MAX_SCAN_DEPTH:
                stack.extend((i, depth + 1) for i in v)
            continue
        if isinstance(v, dict):
            if depth < MAX_SCAN_DEPTH:
                stack.extend((i, depth + 1) for i in v.values())
            continue
        if resolver is not None:
            resolved = resolver(v)
            if resolved is not None:
                for node, weight in resolved.items():
                    votes[node] = votes.get(node, 0) + max(1, int(weight))
                continue
        codec = _CODECS_BY_TYPE.get(type(v))
        if codec is None or codec.locality is None:
            continue
        node = codec.locality(v)
        if node is None:
            continue
        weight = 1
        if codec.locality_nbytes is not None:
            weight = max(1, int(codec.locality_nbytes(v)))
        votes[node] = votes.get(node, 0) + weight
    return votes


def _torch_tensor_type():
    """``torch.Tensor`` once torch is loaded, else None (never imports it)."""
    torch = sys.modules.get("torch")
    return None if torch is None else torch.Tensor


def as_numpy(value: Any) -> np.ndarray:
    """``np.asarray`` for an array leaf, with a ``torch.Tensor`` taken to
    the host: a CPU tensor as its numpy view, a CUDA tensor copied into
    pinned host memory first (a synchronous copy, as ``np.asarray`` pulls a
    device array to the host).  bfloat16 has no numpy dtype here and raises
    :class:`MigratableError`."""
    tensor_type = _torch_tensor_type()
    if tensor_type is None or not isinstance(value, tensor_type):
        return np.asarray(value)
    torch = sys.modules["torch"]
    if value.dtype == torch.bfloat16:
        raise MigratableError(
            "a bfloat16 tensor has no numpy dtype to travel as; cast it first"
        )
    t = value.detach()
    if t.device.type != "cpu":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        t = host
    return t.resolve_conj().resolve_neg().numpy()


def is_bitwise_migratable(value: Any) -> bool:
    """True if a value needs no codec: fixed-size array/scalar leaves."""
    if isinstance(value, (bool, int, float, np.bool_, np.integer, np.floating)):
        return True
    if isinstance(value, np.ndarray):
        return value.dtype.kind in "biufc"
    # torch.Tensor quacks like ndarray for our purposes (as_numpy)
    if hasattr(value, "__array__") and hasattr(value, "dtype") and hasattr(value, "shape"):
        return True
    return False


# --------------------------------------------------------------------------
# spec_of: value -> Spec
# --------------------------------------------------------------------------


def spec_of(value: Any) -> Spec:
    if isinstance(value, (bool, np.bool_)):
        return ScalarSpec("b1")
    if isinstance(value, (int, np.integer)):
        return ScalarSpec("i8")
    if isinstance(value, (float, np.floating)):
        return ScalarSpec("f8")
    codec = codec_for(value)
    if codec is not None:
        if codec.nbytes_fixed is None:
            raise MigratableError(
                f"type {codec.type_name} has a dynamic-size codec and cannot "
                "appear in a static handler spec"
            )
        return OpaqueSpec(codec.type_name, codec.nbytes_fixed)
    if hasattr(value, "shape") and hasattr(value, "dtype"):
        arr = as_numpy(value)
        if arr.dtype.kind not in "biufc":
            raise NotBitwiseMigratableError(
                f"array dtype {arr.dtype} is not bitwise migratable"
            )
        return ArraySpec(tuple(int(d) for d in arr.shape), str(arr.dtype))
    raise NotBitwiseMigratableError(
        f"type {type(value).__qualname__} is neither bitwise migratable nor "
        "has a registered migratable codec; register one with "
        "register_migratable() (the migratable<T> specialisation)"
    )


def check_against_spec(value: Any, spec: Spec) -> None:
    got = spec_of(value)
    if got != spec:
        raise SpecMismatchError(f"argument spec mismatch: expected {spec}, got {got}")


# --------------------------------------------------------------------------
# STATIC pack/unpack: raw leaf concatenation, spec known to both sides
# --------------------------------------------------------------------------


# precompiled per-kind structs: (Struct, python-side coercion).  struct's
# internal format cache makes repeated struct.pack("<q", ...) merely cheap;
# hoisting the compiled objects makes the per-leaf cost one method call.
_SCALAR_STRUCTS = {
    "i8": (struct.Struct("<q"), int),
    "f8": (struct.Struct("<d"), float),
    "b1": (struct.Struct("<?"), bool),
}


def _scalar_to_bytes(value: Any, kind: str) -> bytes:
    try:
        st, conv = _SCALAR_STRUCTS[kind]
    except KeyError:
        raise MigratableError(f"unknown scalar kind {kind}") from None
    return st.pack(conv(value))


def _scalar_from_bytes(buf: memoryview, kind: str) -> Any:
    try:
        st, _ = _SCALAR_STRUCTS[kind]
    except KeyError:
        raise MigratableError(f"unknown scalar kind {kind}") from None
    return st.unpack(buf[: st.size])[0]


def static_payload_nbytes(specs) -> int:
    return sum(s.nbytes for s in specs)


def pack_static(args, specs, out=None):
    """Pack ``args`` against ``specs`` into a contiguous buffer.

    This is the paper's bitwise-copy fast path: no tags, no shapes, no dtype
    strings on the wire — the receiver reconstructs purely from the handler's
    registered spec.  ``out`` may be a presized bytearray or writable
    memoryview (frames pack payloads in place).
    """
    if len(args) != len(specs):
        raise SpecMismatchError(f"expected {len(specs)} args, got {len(args)}")
    buf = out if out is not None else bytearray(static_payload_nbytes(specs))
    off = 0
    for value, spec in zip(args, specs):
        if isinstance(spec, ScalarSpec):
            b = _scalar_to_bytes(value, spec.kind)
            buf[off : off + len(b)] = b
            off += spec.nbytes
        elif isinstance(spec, ArraySpec):
            arr = as_numpy(value)
            if tuple(arr.shape) != spec.shape or str(arr.dtype) != spec.dtype:
                raise SpecMismatchError(
                    f"array arg mismatch: expected {spec}, got "
                    f"shape={tuple(arr.shape)} dtype={arr.dtype}"
                )
            # single copy straight into the wire buffer (bitwise fast path)
            dst = np.frombuffer(buf, np.uint8, count=spec.nbytes, offset=off)
            np.copyto(dst, np.ascontiguousarray(arr).view(np.uint8).reshape(-1))
            off += spec.nbytes
        elif isinstance(spec, OpaqueSpec):
            codec = _CODECS_BY_NAME[spec.type_name]
            raw = codec.encode(value)
            if len(raw) != spec.nbytes_fixed:
                raise SpecMismatchError(
                    f"codec {spec.type_name} produced {len(raw)} bytes, "
                    f"spec says {spec.nbytes_fixed}"
                )
            buf[off : off + len(raw)] = raw
            off += spec.nbytes
        else:
            raise MigratableError(f"unknown spec {spec!r}")
    return buf  # bytearray: transports accept buffer-protocol objects


def unpack_static(payload: bytes | memoryview, specs) -> tuple:
    """Inverse of :func:`pack_static`.  Array leaves are zero-copy views."""
    view = memoryview(payload)
    args = []
    off = 0
    for spec in specs:
        if isinstance(spec, ScalarSpec):
            args.append(_scalar_from_bytes(view[off:], spec.kind))
        elif isinstance(spec, ArraySpec):
            arr = np.frombuffer(
                view[off : off + spec.nbytes], dtype=np.dtype(spec.dtype)
            ).reshape(spec.shape)
            args.append(arr)
        elif isinstance(spec, OpaqueSpec):
            codec = _CODECS_BY_NAME.get(spec.type_name)
            if codec is None:
                raise MigratableError(
                    f"no codec registered locally for {spec.type_name}; "
                    "heterogeneous processes must register the same migratable "
                    "specialisations (same-source assumption)"
                )
            args.append(codec.decode(bytes(view[off : off + spec.nbytes])))
        else:
            raise MigratableError(f"unknown spec {spec!r}")
        off += spec.nbytes
    return tuple(args)


# --------------------------------------------------------------------------
# DYNAMIC pack/unpack: self-describing pytree TLV
# --------------------------------------------------------------------------

_T_NONE = 0
_T_BOOL = 1
_T_INT = 2
_T_FLOAT = 3
_T_BYTES = 4
_T_STR = 5
_T_NDARRAY = 6
_T_LIST = 7
_T_TUPLE = 8
_T_DICT = 9
_T_CUSTOM = 10


def _as_flat_view(value) -> memoryview:
    """1-D uint8 memoryview of any bytes-like, without copying when possible."""
    mv = value if isinstance(value, memoryview) else memoryview(value)
    if mv.format != "B" or mv.ndim != 1:
        try:
            mv = mv.cast("B")
        except TypeError:  # non-contiguous exotic view: flatten via a copy
            mv = memoryview(bytes(mv))
    return mv


def dynamic_nbytes(value: Any) -> int:
    """Exact packed size of ``value`` under the dynamic encoding.

    A cheap measuring pre-pass mirroring :func:`pack_dynamic_into`'s dispatch
    order, so frames can be allocated at their final size up front — no
    bytearray growth reallocs (which cost an extra full copy or two on
    multi-megabyte put/get payloads).
    """
    if value is None:
        return 1
    if isinstance(value, (bool, np.bool_)):
        return 2
    if isinstance(value, (int, np.integer)):
        return 9
    if isinstance(value, (float, np.floating)):
        return 9
    if isinstance(value, (bytes, bytearray, memoryview)):
        return 9 + _as_flat_view(value).nbytes
    if isinstance(value, str):
        return 9 + len(value.encode("utf-8"))
    codec = codec_for(value)
    if codec is not None:
        name = codec.type_name.encode("utf-8")
        return 11 + len(name) + len(codec.encode(value))
    if hasattr(value, "shape") and hasattr(value, "dtype"):
        arr = as_numpy(value)
        return (
            3
            + len(arr.dtype.str)
            + 8 * arr.ndim
            + arr.size * arr.dtype.itemsize
        )
    if isinstance(value, (list, tuple)):
        return 9 + sum(dynamic_nbytes(v) for v in value)
    if isinstance(value, dict):
        n = 9
        for k, v in value.items():
            if not isinstance(k, str):
                raise MigratableError("dynamic dict keys must be str")
            n += dynamic_nbytes(k) + dynamic_nbytes(v)
        return n
    raise NotBitwiseMigratableError(
        f"type {type(value).__qualname__} has no migratable codec"
    )


def pack_dynamic_into(buf: bytearray, off: int, value: Any) -> int:
    """Pack ``value`` into presized ``buf`` at ``off``; returns the end offset.

    ``buf`` must have at least :func:`dynamic_nbytes` bytes of room after
    ``off`` — callers allocate the frame once (header + payload) and pack in
    place, which is the zero-intermediate-copy fast path the transports
    build on.
    """
    if value is None:
        buf[off] = _T_NONE
        return off + 1
    if isinstance(value, (bool, np.bool_)):
        buf[off] = _T_BOOL
        buf[off + 1] = 1 if value else 0
        return off + 2
    if isinstance(value, (int, np.integer)):
        buf[off] = _T_INT
        struct.pack_into("<q", buf, off + 1, int(value))
        return off + 9
    if isinstance(value, (float, np.floating)):
        buf[off] = _T_FLOAT
        struct.pack_into("<d", buf, off + 1, float(value))
        return off + 9
    if isinstance(value, (bytes, bytearray, memoryview)):
        mv = _as_flat_view(value)
        n = mv.nbytes
        buf[off] = _T_BYTES
        struct.pack_into("<Q", buf, off + 1, n)
        off += 9
        buf[off : off + n] = mv
        return off + n
    if isinstance(value, str):
        raw = value.encode("utf-8")
        buf[off] = _T_STR
        struct.pack_into("<Q", buf, off + 1, len(raw))
        off += 9
        buf[off : off + len(raw)] = raw
        return off + len(raw)
    codec = codec_for(value)
    if codec is not None:
        name = codec.type_name.encode("utf-8")
        raw = codec.encode(value)
        buf[off] = _T_CUSTOM
        struct.pack_into("<H", buf, off + 1, len(name))
        off += 3
        buf[off : off + len(name)] = name
        off += len(name)
        struct.pack_into("<Q", buf, off, len(raw))
        off += 8
        buf[off : off + len(raw)] = raw
        return off + len(raw)
    if hasattr(value, "shape") and hasattr(value, "dtype"):
        arr = as_numpy(value)
        if arr.dtype.kind not in "biufcV":
            raise NotBitwiseMigratableError(f"cannot migrate dtype {arr.dtype}")
        dt = arr.dtype.str.encode("ascii")  # includes endianness, e.g. '<f4'
        buf[off] = _T_NDARRAY
        buf[off + 1] = len(dt)
        off += 2
        buf[off : off + len(dt)] = dt
        off += len(dt)
        buf[off] = arr.ndim
        off += 1
        for d in arr.shape:
            struct.pack_into("<Q", buf, off, d)
            off += 8
        nb = arr.size * arr.dtype.itemsize
        if nb:
            # bulk leaf: single copy straight into the frame (no tobytes temp)
            dst = np.frombuffer(buf, np.uint8, count=nb, offset=off)
            np.copyto(dst, np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
        return off + nb
    if isinstance(value, (list, tuple)):
        buf[off] = _T_LIST if isinstance(value, list) else _T_TUPLE
        struct.pack_into("<Q", buf, off + 1, len(value))
        off += 9
        for item in value:
            off = pack_dynamic_into(buf, off, item)
        return off
    if isinstance(value, dict):
        buf[off] = _T_DICT
        struct.pack_into("<Q", buf, off + 1, len(value))
        off += 9
        for k, v in value.items():
            if not isinstance(k, str):
                raise MigratableError("dynamic dict keys must be str")
            off = pack_dynamic_into(buf, off, k)
            off = pack_dynamic_into(buf, off, v)
        return off
    raise NotBitwiseMigratableError(
        f"type {type(value).__qualname__} has no migratable codec"
    )


def pack_dynamic(value: Any) -> bytes:
    """Self-describing encoding of a pytree of migratable leaves."""
    out = bytearray(dynamic_nbytes(value))
    pack_dynamic_into(out, 0, value)
    return bytes(out)


def _unpack_from(view: memoryview, off: int):
    tag = view[off]
    off += 1
    if tag == _T_NONE:
        return None, off
    if tag == _T_BOOL:
        return bool(view[off]), off + 1
    if tag == _T_INT:
        return struct.unpack_from("<q", view, off)[0], off + 8
    if tag == _T_FLOAT:
        return struct.unpack_from("<d", view, off)[0], off + 8
    if tag == _T_BYTES:
        (n,) = struct.unpack_from("<Q", view, off)
        off += 8
        return bytes(view[off : off + n]), off + n
    if tag == _T_STR:
        (n,) = struct.unpack_from("<Q", view, off)
        off += 8
        return bytes(view[off : off + n]).decode("utf-8"), off + n
    if tag == _T_CUSTOM:
        (nlen,) = struct.unpack_from("<H", view, off)
        off += 2
        name = bytes(view[off : off + nlen]).decode("utf-8")
        off += nlen
        (n,) = struct.unpack_from("<Q", view, off)
        off += 8
        codec = _CODECS_BY_NAME.get(name)
        if codec is None:
            raise MigratableError(f"no codec registered locally for {name}")
        return codec.decode(bytes(view[off : off + n])), off + n
    if tag == _T_NDARRAY:
        dtlen = view[off]
        off += 1
        dt = np.dtype(bytes(view[off : off + dtlen]).decode("ascii"))
        off += dtlen
        ndim = view[off]
        off += 1
        shape = []
        for _ in range(ndim):
            (d,) = struct.unpack_from("<Q", view, off)
            shape.append(d)
            off += 8
        nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize if shape else dt.itemsize
        if not shape:
            nbytes = dt.itemsize
        arr = np.frombuffer(view[off : off + nbytes], dtype=dt).reshape(shape)
        return arr, off + nbytes
    if tag in (_T_LIST, _T_TUPLE):
        (n,) = struct.unpack_from("<Q", view, off)
        off += 8
        items = []
        for _ in range(n):
            item, off = _unpack_from(view, off)
            items.append(item)
        return (items if tag == _T_LIST else tuple(items)), off
    if tag == _T_DICT:
        (n,) = struct.unpack_from("<Q", view, off)
        off += 8
        d = {}
        for _ in range(n):
            k, off = _unpack_from(view, off)
            v, off = _unpack_from(view, off)
            d[k] = v
        return d, off
    raise MigratableError(f"unknown dynamic tag {tag}")


def unpack_dynamic(payload: bytes | memoryview) -> Any:
    value, off = _unpack_from(memoryview(payload), 0)
    if off != len(payload):
        raise MigratableError(
            f"trailing bytes in dynamic payload: consumed {off} of {len(payload)}"
        )
    return value
