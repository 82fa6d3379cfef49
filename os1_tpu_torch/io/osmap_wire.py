"""Protocol-buffers (proto3) wire format of the Osmap files, by hand.

The schema is ``osmap.proto`` beside this module (the os1 reference's
``osmap.proto``); nothing compiles it. A message is a plain ``dict`` from
field name to value: an int or float for a singular scalar, a list for a
repeated scalar, a dict for a sub-message and a list of dicts for a repeated
sub-message. A key that is absent is a field that is not set.

The encoder gives the bytes that protobuf's own serializer gives for the same
message:

  * fields in field-number order;
  * repeated scalars packed (proto3's default), empty ones left out;
  * implicit presence: a singular scalar whose bits are all zero is left out
    (``0``, ``+0.0``); ``-0.0`` is written, since its sign bit is set;
  * a sub-message key that is present is written, even when empty (a
    zero-length field);
  * ``float`` fields are rounded to float32 as a C cast (numpy's ``astype``)
    rounds them, then tested for zero.

The decoder reads what any proto3 writer may produce: fields in any order,
repeated scalars packed or not, repeated sub-messages one field each,
a singular sub-message given twice merged into one, a scalar given twice
taking the last value, and unknown fields (wire types 0, 1, 2, 5 and groups)
skipped. It drops scalars whose bits are zero, so a decoded message equals
the one the encoder was given once its zero scalars are removed. Malformed
input raises :class:`DecodeError` where protobuf's parser rejects it.
"""
from __future__ import annotations

import numpy as np

UINT32, FIXED32, FLOAT, DOUBLE = "uint32", "fixed32", "float", "double"
_WIRE = {UINT32: 0, FIXED32: 5, FLOAT: 5, DOUBLE: 1}
_WIDTH = {FIXED32: ("<u4", 4), FLOAT: ("<f4", 4), DOUBLE: ("<f8", 8)}

# message -> {field number: (name, scalar kind or message name, repeated)}
SCHEMA = {
    "SerializedDescriptor": {1: ("block", FIXED32, True)},
    "SerializedPose": {1: ("element", FLOAT, True)},
    "SerializedPosition": {1: ("x", FLOAT, False), 2: ("y", FLOAT, False),
                           3: ("z", FLOAT, False)},
    "SerializedKeypoint": {1: ("ptx", FLOAT, False), 2: ("pty", FLOAT, False),
                           3: ("angle", FLOAT, False), 4: ("octave", FLOAT, False)},
    "SerializedK": {1: ("fx", FLOAT, False), 2: ("fy", FLOAT, False), 3: ("cx", FLOAT, False),
                    4: ("cy", FLOAT, False)},
    "SerializedMappoint": {1: ("id", UINT32, False), 2: ("position", "SerializedPosition", False),
                           3: ("visible", FLOAT, False), 4: ("found", FLOAT, False),
                           5: ("briefdescriptor", "SerializedDescriptor", False)},
    "SerializedMappointArray": {1: ("mappoint", "SerializedMappoint", True)},
    "SerializedKeyframe": {1: ("id", UINT32, False), 2: ("pose", "SerializedPose", False),
                           3: ("kmatrix", "SerializedK", False), 4: ("kindex", UINT32, False),
                           5: ("loopedgesids", UINT32, True), 6: ("timestamp", DOUBLE, False)},
    "SerializedKeyframeArray": {1: ("keyframe", "SerializedKeyframe", True)},
    "SerializedFeature": {2: ("mappoint_id", UINT32, False),
                          3: ("keypoint", "SerializedKeypoint", False),
                          4: ("briefdescriptor", "SerializedDescriptor", False)},
    "SerializedKeyframeFeatures": {1: ("keyframe_id", UINT32, False),
                                   2: ("feature", "SerializedFeature", True)},
    "SerializedKeyframeFeaturesArray": {1: ("feature", "SerializedKeyframeFeatures", True)},
}
_ORDER = {name: sorted(fields.items()) for name, fields in SCHEMA.items()}


class DecodeError(ValueError):
    """The bytes are not a valid encoding of the message."""


# --------------------------------------------------------------------- #
# encoding
# --------------------------------------------------------------------- #
def varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _fixed(kind: str, values) -> bytes:
    dtype = _WIDTH[kind][0]
    with np.errstate(over="ignore"):  # a double beyond float32's range rounds to inf
        return np.asarray(values, np.float64 if kind != FIXED32 else np.int64).astype(
            dtype).tobytes()


def _scalar(kind: str, value) -> bytes:
    """The value's bytes, or b"" when its bits are zero (left out)."""
    if kind == UINT32:
        return varint(int(value)) if value else b""
    raw = _fixed(kind, [value])
    return raw if raw.strip(b"\0") else b""


def encode(message: str, msg: dict) -> bytes:
    """Serialize ``msg`` as a ``message``, byte for byte as protobuf does."""
    out = bytearray()
    for num, (name, kind, repeated) in _ORDER[message]:
        value = msg.get(name)
        if value is None:
            continue
        if kind in SCHEMA:
            for sub in (value if repeated else (value,)):
                body = encode(kind, sub)
                out += varint(num << 3 | 2) + varint(len(body)) + body
        elif repeated:
            if len(value) == 0:
                continue
            body = (b"".join(varint(int(v)) for v in value) if kind == UINT32
                    else _fixed(kind, value))
            out += varint(num << 3 | 2) + varint(len(body)) + body
        else:
            raw = _scalar(kind, value)
            if raw:
                out += varint(num << 3 | _WIRE[kind]) + raw
    return bytes(out)


# --------------------------------------------------------------------- #
# decoding
# --------------------------------------------------------------------- #
def read_varint(data: bytes, pos: int, end: int | None = None) -> tuple[int, int]:
    """(value, next position) of the varint at ``pos``; at most 10 bytes."""
    end = len(data) if end is None else end
    out = shift = 0
    for _ in range(10):
        if pos >= end:
            raise DecodeError("truncated varint")
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out & 0xFFFFFFFFFFFFFFFF, pos
        shift += 7
    raise DecodeError("varint longer than 10 bytes")


def _length(data: bytes, pos: int, end: int) -> tuple[int, int]:
    n, pos = read_varint(data, pos, end)
    if n > end - pos:
        raise DecodeError("length past the end")
    return pos + n, pos


def _skip(data: bytes, pos: int, end: int, num: int, wt: int) -> int:
    """Position after an unknown field's value."""
    if wt == 0:
        return read_varint(data, pos, end)[1]
    if wt in (1, 5):
        pos += 8 if wt == 1 else 4
        if pos > end:
            raise DecodeError("truncated fixed-width field")
        return pos
    if wt == 2:
        return _length(data, pos, end)[0]
    if wt == 3:  # a group: fields up to the matching end-group tag
        while True:
            tag, pos = read_varint(data, pos, end)
            if tag >> 3 == 0:
                raise DecodeError("field number 0")
            if tag & 7 == 4:
                if tag >> 3 != num:
                    raise DecodeError("mismatched end-group tag")
                return pos
            pos = _skip(data, pos, end, tag >> 3, tag & 7)
    raise DecodeError(f"unexpected wire type {wt}")


def _values(kind: str, data: bytes, pos: int, end: int) -> list:
    """The scalars of a packed run data[pos:end]."""
    if kind == UINT32:
        out = []
        while pos < end:
            v, pos = read_varint(data, pos, end)
            out.append(v & 0xFFFFFFFF)
        return out
    dtype, width = _WIDTH[kind]
    if (end - pos) % width:
        raise DecodeError("packed run not a whole number of values")
    return np.frombuffer(data, dtype, (end - pos) // width, pos).tolist()


def _set(msg: dict, name: str, kind: str, value) -> None:
    """Implicit presence: a zero scalar is the field not set."""
    if _scalar(kind, value):
        msg[name] = value
    else:
        msg.pop(name, None)


def _decode_into(message: str, msg: dict, data: bytes, pos: int, end: int) -> dict:
    fields = SCHEMA[message]
    while pos < end:
        tag, pos = read_varint(data, pos, end)
        num, wt = tag >> 3, tag & 7
        if num == 0 or tag > 0xFFFFFFFF:
            raise DecodeError("invalid tag")
        field = fields.get(num)
        if field is not None:
            name, kind, repeated = field
            if kind in SCHEMA and wt == 2:
                stop, pos = _length(data, pos, end)
                if repeated:
                    msg.setdefault(name, []).append(_decode_into(kind, {}, data, pos, stop))
                else:  # a second occurrence merges into the first
                    msg[name] = _decode_into(kind, msg.get(name, {}), data, pos, stop)
                pos = stop
                continue
            if kind not in SCHEMA and wt == _WIRE[kind]:
                if kind == UINT32:
                    value, pos = read_varint(data, pos, end)
                    value &= 0xFFFFFFFF
                else:
                    dtype, width = _WIDTH[kind]
                    if pos + width > end:
                        raise DecodeError("truncated fixed-width field")
                    value = np.frombuffer(data, dtype, 1, pos).item()
                    pos += width
                if repeated:
                    msg.setdefault(name, []).append(value)
                else:
                    _set(msg, name, kind, value)
                continue
            if kind not in SCHEMA and repeated and wt == 2:
                stop, pos = _length(data, pos, end)
                values = _values(kind, data, pos, stop)
                if values:  # an empty packed run sets nothing
                    msg.setdefault(name, []).extend(values)
                pos = stop
                continue
        # Unknown field, or a known one with another wire type: skipped.
        pos = _skip(data, pos, end, num, wt)
    return msg


def decode(message: str, data: bytes) -> dict:
    """Parse ``data`` as a ``message``."""
    return _decode_into(message, {}, data, 0, len(data))
