"""Active-message framing.

Paper mapping (§4.3): ``active_msg_base`` — "its only data member is the
globally valid handler key" — becomes a fixed 32-byte little-endian header in
front of the payload.  A received frame is first interpreted as a header (the
cast to ``active_msg_base``); the key then selects the local handler, which
reinterprets the payload according to its registered argument spec (the
upcast into the concrete ``offload_msg<...>`` type).

Header layout (32 bytes, little-endian):

    u32  magic        0x48414D58  ("HAMX")
    u16  version      wire protocol version
    u16  flags        bit0 REPLY, bit1 ERROR, bit2 DYNAMIC payload,
                      bit3 STATIC (plan-packed) payload, bit4 FUSED frame,
                      bit5 RETRYABLE (sender may retransmit; receiver must
                      dedup via its replay cache — docs/failure-model.md)
    u32  key          global handler key (sorted-registry index)
    u32  src_node     sender node id (for replies / reverse offload)
    u64  msg_id       correlates replies with futures
    u64  payload_len  bytes following the header

Payload-format bits (STATIC / DYNAMIC)
--------------------------------------

``FLAG_DYNAMIC`` marks a self-describing TLV payload; ``FLAG_STATIC`` marks
a plan-packed payload whose layout both sides derive from the handler's
registered spec (see ``repro_torch.core.wireplan``).  The bits are *advisory* on
requests — a request with neither bit (a pre-plan peer) dispatches through
the receiver's compiled plan when the handler is static, because the plan
layout is byte-identical to the legacy ``pack_static`` concatenation.  On
**replies** the bit is load-bearing: a reply with ``FLAG_STATIC`` decodes
through the handler's result plan (the key field names the handler), any
other non-error reply decodes as dynamic TLV.  Error replies
(``REPLY|ERROR``) are always dynamic (message + traceback dict).

Fused-frame segment layout (``FLAG_FUSED``)
-------------------------------------------

Small-call fusion packs many sub-threshold calls (or replies) into ONE
frame, amortising the 32-byte header, the per-frame transport publication
and the per-frame dispatch.  The outer header carries ``FLAG_FUSED``,
``key=0``, ``msg_id=0`` and the true ``src_node``; the payload is a count
word followed by back-to-back segments::

    u32 count
    count * ( u32 key | u16 flags | u64 msg_id | u32 payload_len | payload )

Each segment is one complete logical message: its ``flags`` carry the
usual REPLY/ERROR/STATIC/DYNAMIC bits and its payload is exactly what the
equivalent standalone frame would carry after the header.  Segments
default to sharing the outer frame's ``src_node``; a segment whose true
origin differs (a relayed ``_ham/forward`` inner frame folded into the
forwarder's egress batch) instead carries ``FLAG_SEG_SRC`` and prefixes
its payload with a ``u32`` true source node id (see ``docs/transport.md``
— the relayed-fused layout).  The receiver strips the prefix and
dispatches/replies against the embedded source, preserving the forward
contract that the final target answers the *origin* directly.  Segment
order is preserved; a receiver executes request segments in order in a
single dispatch/executor pass, and an error in one segment errors only
that segment's ``msg_id``.

Shape-keyed dynamic payloads (``FLAG_SHAPED``)
----------------------------------------------

``FLAG_SHAPED`` marks a dynamic payload packed through a shape-keyed
cached ``WirePlan`` instead of TLV: the payload is ``u16 sig_len`` +
signature bytes + the plan-packed leaves.  The signature (grammar in
``repro_torch.core.wireplan.spec_signature``) fully determines the plan, so the
receiver compiles-or-looks-up the same plan and unpacks without any
per-leaf TLV interpretation.  Semantically equivalent to FLAG_DYNAMIC —
senders fall back to TLV for shapes the spec grammar cannot express.

Batched-frame segment layout (the coalesced hot path)
-----------------------------------------------------

Transports move frames either one at a time (``send``/``recv``) or
coalesced (``send_many``/``recv_many``).  On the wire a coalesced batch is
simply the concatenation of the per-frame transport encodings — for the shm
ring and the socket stream that is::

    u64 len_0 || frame_0 || u64 len_1 || frame_1 || ... || u64 len_{n-1} || frame_{n-1}

i.e. exactly what ``n`` individual sends would produce, so batching is a
pure *publication* optimisation (one ring-counter store / one syscall per
batch instead of per frame) and the receiver cannot tell — and need not
care — how the sender grouped frames.  ``decode_fast`` is called once per
frame on a zero-copy view into the receive window; ``payload_len`` is
validated against the view so a short/corrupt segment cannot silently
alias a neighbouring frame's bytes.

Zero-copy lifetime rule: payload views returned by :func:`decode_fast` /
:func:`split_frame` alias the frame.  When the frame itself is a leased
transport view (see ``repro_torch.comm.shm``), the view is only valid until the
lease is released — anything that outlives dispatch (futures, retained
arrays) must copy first.
"""

from __future__ import annotations

import dataclasses
import struct

from repro_torch.core.errors import MessageFormatError

# Flag bits live in the centralized wire-constant registry (one table,
# import-time collision assertions, read by the static analyzer) and are
# re-exported here so existing ``from repro_torch.core.message import FLAG_*``
# imports keep working.  Semantics:
#   FLAG_RETRYABLE — request may be retransmitted by the sender (scheduler
#     deadline/retry path): the receiver must dedup on (src_node, msg_id)
#     through its replay cache and resend the cached reply instead of
#     re-executing (docs/failure-model.md).  Meaningless on replies.
#   FLAG_SHAPED — dynamic payload packed via a shape-keyed cached WirePlan:
#     u16 sig_len | signature | plan-packed leaves (repro_torch.core.wireplan).
#   FLAG_SEG_SRC — fused-SEGMENT-only bit: the segment's true origin differs
#     from the outer frame's src_node; payload starts with u32 true src.
from repro_torch.core.flags import (  # noqa: F401  (re-exported wire constants)
    FLAG_DYNAMIC,
    FLAG_ERROR,
    FLAG_FUSED,
    FLAG_REPLY,
    FLAG_RETRYABLE,
    FLAG_SEG_SRC,
    FLAG_SHAPED,
    FLAG_STATIC,
)

MAGIC = 0x48414D58
VERSION = 1
HEADER_STRUCT = struct.Struct("<IHHIIQQ")
HEADER_NBYTES = HEADER_STRUCT.size  # 32

#: fused-frame segment header: key, flags, msg_id, payload_len
SEG_STRUCT = struct.Struct("<IHQI")
SEG_NBYTES = SEG_STRUCT.size  # 18
#: u32 true-source prefix of a FLAG_SEG_SRC segment payload
SEG_SRC_STRUCT = struct.Struct("<I")
SEG_SRC_NBYTES = SEG_SRC_STRUCT.size  # 4
FUSED_COUNT_STRUCT = struct.Struct("<I")


@dataclasses.dataclass(frozen=True)
class Header:
    key: int
    src_node: int
    msg_id: int
    payload_len: int
    flags: int = 0
    version: int = VERSION

    @property
    def is_reply(self) -> bool:
        return bool(self.flags & FLAG_REPLY)

    @property
    def is_error(self) -> bool:
        return bool(self.flags & FLAG_ERROR)

    @property
    def is_dynamic(self) -> bool:
        return bool(self.flags & FLAG_DYNAMIC)

    @property
    def is_static(self) -> bool:
        return bool(self.flags & FLAG_STATIC)

    @property
    def is_fused(self) -> bool:
        return bool(self.flags & FLAG_FUSED)


def encode_header(header: Header, out: bytearray | None = None) -> bytes | bytearray:
    buf = out if out is not None else bytearray(HEADER_NBYTES)
    HEADER_STRUCT.pack_into(
        buf,
        0,
        MAGIC,
        header.version,
        header.flags,
        header.key,
        header.src_node,
        header.msg_id,
        header.payload_len,
    )
    return buf


def decode_header(buf: bytes | bytearray | memoryview) -> Header:
    if len(buf) < HEADER_NBYTES:
        raise MessageFormatError(
            f"frame shorter than header: {len(buf)} < {HEADER_NBYTES}"
        )
    magic, version, flags, key, src_node, msg_id, payload_len = HEADER_STRUCT.unpack_from(
        buf, 0
    )
    if magic != MAGIC:
        raise MessageFormatError(f"bad magic 0x{magic:08x}")
    if version != VERSION:
        raise MessageFormatError(f"unsupported wire version {version}")
    return Header(
        key=key,
        src_node=src_node,
        msg_id=msg_id,
        payload_len=payload_len,
        flags=flags,
        version=version,
    )


def encode_frame(
    key: int,
    payload: bytes | bytearray | memoryview,
    *,
    src_node: int = 0,
    msg_id: int = 0,
    flags: int = 0,
) -> bytearray:
    """One-allocation frame assembly: header || payload."""
    frame = bytearray(HEADER_NBYTES + len(payload))
    HEADER_STRUCT.pack_into(
        frame, 0, MAGIC, VERSION, flags, key, src_node, msg_id, len(payload)
    )
    frame[HEADER_NBYTES:] = payload
    return frame


def decode_fast(frame):
    """Hot-path decode: (key, flags, src_node, msg_id, payload_view) tuple,
    no dataclass allocation.  Validation reduced to the magic check plus a
    payload-length bounds check (a truncated frame must fail loudly here —
    a silently short memoryview would surface as a corrupt argument deep
    inside a handler)."""
    try:
        magic, _version, flags, key, src_node, msg_id, payload_len = (
            HEADER_STRUCT.unpack_from(frame, 0)
        )
    except struct.error as e:
        raise MessageFormatError(f"frame shorter than header: {e}") from None
    if magic != MAGIC:
        raise MessageFormatError(f"bad magic 0x{magic:08x}")
    view = memoryview(frame)
    if view.nbytes - HEADER_NBYTES < payload_len:
        raise MessageFormatError(
            f"truncated frame: header says {payload_len} payload bytes, "
            f"frame carries {view.nbytes - HEADER_NBYTES}"
        )
    return key, flags, src_node, msg_id, view[
        HEADER_NBYTES : HEADER_NBYTES + payload_len
    ]


def iter_fused(payload):
    """Yield ``(key, flags, msg_id, payload_view)`` per fused segment.

    ``payload`` is a fused frame's payload (after the outer header).  Every
    extent is bounds-checked against the enclosing payload — a truncated or
    corrupt segment must fail loudly here, not surface as a garbled argument
    inside a handler.  Segment views alias ``payload`` (zero-copy): the
    caller owns the lifetime rule.
    """
    view = payload if isinstance(payload, memoryview) else memoryview(payload)
    total = view.nbytes
    if total < 4:
        raise MessageFormatError(f"fused payload shorter than count word: {total}")
    (count,) = FUSED_COUNT_STRUCT.unpack_from(view, 0)
    off = 4
    unpack = SEG_STRUCT.unpack_from
    for _ in range(count):
        if off + SEG_NBYTES > total:
            raise MessageFormatError(
                f"truncated fused segment header at offset {off} of {total}"
            )
        key, flags, msg_id, plen = unpack(view, off)
        off += SEG_NBYTES
        if off + plen > total:
            raise MessageFormatError(
                f"truncated fused segment payload: {plen} bytes claimed, "
                f"{total - off} remain"
            )
        yield key, flags, msg_id, view[off : off + plen]
        off += plen
    if off != total:
        raise MessageFormatError(
            f"trailing bytes in fused payload: consumed {off} of {total}"
        )


def split_frame(frame: bytes | bytearray | memoryview) -> tuple[Header, memoryview]:
    """Decode header and return a zero-copy view of the payload."""
    header = decode_header(frame)
    view = memoryview(frame)[HEADER_NBYTES : HEADER_NBYTES + header.payload_len]
    if len(view) != header.payload_len:
        raise MessageFormatError(
            f"truncated payload: header says {header.payload_len}, got {len(view)}"
        )
    return header, view
