"""The port's counterpart of tests/test_message.py.

Frame/header codec invariants."""

import pytest
from _hypothesis_compat import given, settings, st

from repro_torch.core import errors as ham
from repro_torch.core import message as msg


@settings(max_examples=100, deadline=None)
@given(
    key=st.integers(min_value=0, max_value=2**32 - 1),
    src=st.integers(min_value=0, max_value=2**32 - 1),
    msg_id=st.integers(min_value=0, max_value=2**64 - 1),
    flags=st.integers(min_value=0, max_value=7),
    payload=st.binary(max_size=256),
)
def test_frame_roundtrip(key, src, msg_id, flags, payload):
    frame = msg.encode_frame(key, payload, src_node=src, msg_id=msg_id,
                             flags=flags)
    header, view = msg.split_frame(frame)
    assert header.key == key
    assert header.src_node == src
    assert header.msg_id == msg_id
    assert header.flags == flags
    assert bytes(view) == payload


def test_bad_magic_rejected():
    frame = bytearray(msg.encode_frame(1, b"xy"))
    frame[0] ^= 0xFF
    with pytest.raises(ham.MessageFormatError):
        msg.decode_header(frame)


def test_truncated_frame_rejected():
    frame = msg.encode_frame(1, b"hello world")
    with pytest.raises(ham.MessageFormatError):
        msg.split_frame(frame[: msg.HEADER_NBYTES + 3])
    with pytest.raises(ham.MessageFormatError):
        msg.decode_header(frame[:10])


def test_decode_fast_rejects_truncated_payload():
    """Regression: decode_fast must bounds-check payload_len — a truncated
    frame used to yield a silently short memoryview."""
    frame = msg.encode_frame(1, b"hello world", msg_id=7)
    # intact frame decodes fine
    key, flags, src, msg_id, payload = msg.decode_fast(frame)
    assert (key, msg_id, bytes(payload)) == (1, 7, b"hello world")
    # frame cut mid-payload: must raise, not return a short view
    with pytest.raises(ham.MessageFormatError):
        msg.decode_fast(frame[: msg.HEADER_NBYTES + 4])
    with pytest.raises(ham.MessageFormatError):
        msg.decode_fast(bytes(frame)[: msg.HEADER_NBYTES + 4])
    # frame cut mid-header: must also raise cleanly
    with pytest.raises(ham.MessageFormatError):
        msg.decode_fast(frame[:10])


def test_flags_semantics():
    h = msg.Header(key=0, src_node=0, msg_id=1, payload_len=0,
                   flags=msg.FLAG_REPLY | msg.FLAG_ERROR)
    assert h.is_reply and h.is_error and not h.is_dynamic
