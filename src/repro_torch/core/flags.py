"""Centralized wire-constant registry: every flag bit, sentinel, and width.

The port's copy of ``repro.core.flags`` (the port imports nothing of the
reference package, so it keeps its own table; its tests hold every value
equal to the reference's).  The reserved msg_id sentinels are derived from
one bit-position table, :data:`MSG_ID_BITS`, as the flag bits are from
:data:`FLAG_BITS`, so no wire constant is a literal outside that table.

Single source of truth for the HAM wire protocol's small-integer namespace.
``core/message.py`` re-exports the ``FLAG_*`` values (callers keep their
existing imports), ``offload/runtime.py`` re-imports the replay-cache
sentinel, and the reference's static analyzer (``repro.analysis``) reads
the reference's tables — so a new flag that collides with an existing bit, or a sentinel
that drifts into live msg_id space, fails at *import time* here and again
in ``hamlint``'s wire-constant rule, not at 3am in a cross-version fleet.

Three namespaces are declared:

* **Header flag bits** (``FLAG_BITS``): bit positions inside the u16
  ``flags`` header field.  Must be pairwise distinct and < 16.
* **Reserved msg_id sentinels** (``MSG_ID_SENTINELS``): values carved out
  of the u64 msg_id space for control meanings (today: the replay-cache
  FLUSH marker).  Live msg_ids are allocated counting up from 1, so every
  sentinel must sit at or above ``MSG_ID_RESERVED_FLOOR`` — unreachable
  by any realistic allocation (2**56 messages at 10M msg/s is ~228 years).
* **Header field widths** (``HEADER_FIELD_WIDTHS``): the bit width of each
  header field, from which the 32-byte ``<IHHIIQQ`` layout follows.
"""

from __future__ import annotations

# -- header flag bits (positions inside the u16 flags field) ---------------

FLAG_BITS: dict[str, int] = {
    "FLAG_REPLY": 0,      # frame is a reply
    "FLAG_ERROR": 1,      # reply carries an error payload
    "FLAG_DYNAMIC": 2,    # self-describing TLV payload
    "FLAG_STATIC": 3,     # plan-packed payload (repro_torch.core.wireplan)
    "FLAG_FUSED": 4,      # multi-call frame: count word + segments
    "FLAG_RETRYABLE": 5,  # sender may retransmit; receiver must dedup
    "FLAG_SHAPED": 6,     # shape-keyed cached-WirePlan dynamic payload
    "FLAG_SEG_SRC": 7,    # fused segment carries its own u32 src prefix
}

FLAG_REPLY = 1 << FLAG_BITS["FLAG_REPLY"]
FLAG_ERROR = 1 << FLAG_BITS["FLAG_ERROR"]
FLAG_DYNAMIC = 1 << FLAG_BITS["FLAG_DYNAMIC"]
FLAG_STATIC = 1 << FLAG_BITS["FLAG_STATIC"]
FLAG_FUSED = 1 << FLAG_BITS["FLAG_FUSED"]
FLAG_RETRYABLE = 1 << FLAG_BITS["FLAG_RETRYABLE"]
FLAG_SHAPED = 1 << FLAG_BITS["FLAG_SHAPED"]
FLAG_SEG_SRC = 1 << FLAG_BITS["FLAG_SEG_SRC"]

# -- header field widths (bits); layout <IHHIIQQ little-endian -------------

HEADER_FIELD_WIDTHS: dict[str, int] = {
    "magic": 32,
    "version": 16,
    "flags": 16,
    "key": 32,
    "src_node": 32,
    "msg_id": 64,
    "payload_len": 64,
}

FLAGS_FIELD_WIDTH = HEADER_FIELD_WIDTHS["flags"]
MSG_ID_FIELD_WIDTH = HEADER_FIELD_WIDTHS["msg_id"]

# -- reserved msg_id sentinels ---------------------------------------------

#: bit positions of the reserved msg_id values inside the u64 msg_id field
MSG_ID_BITS: dict[str, int] = {
    "MSG_ID_RESERVED_FLOOR": 56,
    "MSG_ID_FLUSH": 61,
}

#: live msg_ids count up from 1; everything at/above this floor is reserved
#: for control sentinels and can never collide with an allocated id
MSG_ID_RESERVED_FLOOR = 1 << MSG_ID_BITS["MSG_ID_RESERVED_FLOOR"]

#: replay-cache msg-id-space reset marker (ReplayCache.FLUSH): a retryable
#: frame carrying this id tells the receiver the sender restarted its id
#: counter and the dedup window must be dropped (docs/failure-model.md)
MSG_ID_FLUSH = 1 << MSG_ID_BITS["MSG_ID_FLUSH"]

MSG_ID_SENTINELS: dict[str, int] = {
    "MSG_ID_FLUSH": MSG_ID_FLUSH,
}

# -- serve/stream status words ---------------------------------------------

#: status word carried by every ``_serve/stream`` token oneway (the
#: worker-driven serving path, docs/serving.md).  A tiny shared namespace
#: like the flag bits: host and workers must agree on these across
#: versions, so they live here, not in the serving modules.  ``TOKEN`` and
#: ``DONE`` messages carry a real token; ``CANCELLED``/``EXPIRED`` are
#: end-of-stream markers whose token field is a placeholder (-1).
SERVE_STREAM_STATUS: dict[str, int] = {
    "STREAM_TOKEN": 0,      # one decoded token, request still running
    "STREAM_DONE": 1,       # final token: the request reached its budget
    "STREAM_CANCELLED": 2,  # request cancelled; slot freed, no token
    "STREAM_EXPIRED": 3,    # request deadline passed; slot freed, no token
}

STREAM_TOKEN = SERVE_STREAM_STATUS["STREAM_TOKEN"]
STREAM_DONE = SERVE_STREAM_STATUS["STREAM_DONE"]
STREAM_CANCELLED = SERVE_STREAM_STATUS["STREAM_CANCELLED"]
STREAM_EXPIRED = SERVE_STREAM_STATUS["STREAM_EXPIRED"]


def _validate() -> None:
    """Import-time collision assertions — the module refuses to load with
    a colliding bit or an out-of-range sentinel."""
    bits = list(FLAG_BITS.values())
    if len(set(bits)) != len(bits):
        dupes = sorted(b for b in set(bits) if bits.count(b) > 1)
        raise AssertionError(f"colliding FLAG_* bit positions: {dupes}")
    for name, bit in FLAG_BITS.items():
        if not 0 <= bit < FLAGS_FIELD_WIDTH:
            raise AssertionError(
                f"{name} bit {bit} outside the u{FLAGS_FIELD_WIDTH} flags field"
            )
    sentinels = list(MSG_ID_SENTINELS.values())
    if len(set(sentinels)) != len(sentinels):
        raise AssertionError("colliding msg_id sentinel values")
    for name, value in MSG_ID_SENTINELS.items():
        if not MSG_ID_RESERVED_FLOOR <= value < (1 << MSG_ID_FIELD_WIDTH):
            raise AssertionError(
                f"{name} = {value:#x} outside the reserved msg_id range "
                f"[{MSG_ID_RESERVED_FLOOR:#x}, 2**{MSG_ID_FIELD_WIDTH})"
            )
    header_bits = sum(HEADER_FIELD_WIDTHS.values())
    if header_bits != 256:
        raise AssertionError(
            f"header field widths sum to {header_bits} bits, expected 256 "
            "(the fixed 32-byte header)"
        )
    statuses = list(SERVE_STREAM_STATUS.values())
    if len(set(statuses)) != len(statuses):
        raise AssertionError("colliding serve-stream status words")


_validate()
