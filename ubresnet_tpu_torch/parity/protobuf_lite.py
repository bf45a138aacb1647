"""Minimal protobuf wire-format reader/writer, no protoc dependency
(counterpart of ubresnet_tpu/parity/protobuf_lite.py; the same bytes
written, the same values read).

Just enough of the encoding to walk Caffe NetParameter/.caffemodel
binaries (the reference's oracle weights, caffe/run_caffe_precropped.py
:26-30) and to synthesize test fixtures: varints, 64/32-bit scalars,
length-delimited fields, packed repeated floats. Packed floats decode
with one ``np.frombuffer`` per field: a caffemodel of the flagship graph
holds 18 M of them.
"""
from __future__ import annotations

from typing import Iterator, Tuple, Union

import numpy as np

WIRE_VARINT = 0
WIRE_64BIT = 1
WIRE_BYTES = 2
WIRE_32BIT = 5


def read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def iter_fields(buf: memoryview) -> Iterator[Tuple[int, int, Union[int, memoryview]]]:
    """Yields (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == WIRE_VARINT:
            val, pos = read_varint(buf, pos)
        elif wire == WIRE_64BIT:
            val = bytes(buf[pos : pos + 8])
            pos += 8
        elif wire == WIRE_BYTES:
            ln, pos = read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == WIRE_32BIT:
            val = bytes(buf[pos : pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def parse_packed_floats(val, wire) -> np.ndarray:
    """A repeated float field, packed bytes or a single 32-bit value, as
    a read-only little-endian float32 view of ``val``."""
    if wire != WIRE_32BIT and len(val) % 4:
        raise ValueError(f"packed floats of {len(val)} bytes")
    return np.frombuffer(val, "<f4")


# ------------------------------------------------------------- writing


def write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def tag(field: int, wire: int) -> bytes:
    return write_varint((field << 3) | wire)


def field_varint(field: int, value: int) -> bytes:
    return tag(field, WIRE_VARINT) + write_varint(value)


def field_bytes(field: int, value: bytes) -> bytes:
    return tag(field, WIRE_BYTES) + write_varint(len(value)) + value


def field_string(field: int, value: str) -> bytes:
    return field_bytes(field, value.encode())


def field_packed_floats(field: int, values) -> bytes:
    payload = np.asarray(values, "<f4").tobytes()
    return field_bytes(field, payload)
