"""Minimal BSON codec (encode/decode), dependency-free.

The reference stores model checkpoints as BSON via nlohmann-json
(`save_params_to_json`, core/network.cu:827-877: `json::to_bson`). To read
and write that container format without pymongo, this implements the BSON
subset nlohmann emits: documents, arrays, strings, bool, int32/int64, double,
null, and generic binary (subtype 0).

nlohmann maps JSON arrays to BSON arrays with stringified integer keys, and
emits int32/int64 depending on magnitude; both are honored here.
"""
from __future__ import annotations

import struct
from typing import Any

_F_DOUBLE = 0x01
_F_STRING = 0x02
_F_DOC = 0x03
_F_ARRAY = 0x04
_F_BINARY = 0x05
_F_BOOL = 0x08
_F_NULL = 0x0A
_F_INT32 = 0x10
_F_INT64 = 0x12


class Binary(bytes):
    """Marker type for BSON binary fields (subtype 0)."""


def _encode_value(key: str, value: Any) -> bytes:
    kb = key.encode() + b"\x00"
    if isinstance(value, bool):
        return bytes([_F_BOOL]) + kb + (b"\x01" if value else b"\x00")
    if isinstance(value, Binary) or isinstance(value, (bytes, bytearray)):
        b = bytes(value)
        return bytes([_F_BINARY]) + kb + struct.pack("<i", len(b)) + b"\x00" + b
    if isinstance(value, int):
        if -(2**31) <= value < 2**31:
            return bytes([_F_INT32]) + kb + struct.pack("<i", value)
        return bytes([_F_INT64]) + kb + struct.pack("<q", value)
    if isinstance(value, float):
        return bytes([_F_DOUBLE]) + kb + struct.pack("<d", value)
    if isinstance(value, str):
        sb = value.encode() + b"\x00"
        return bytes([_F_STRING]) + kb + struct.pack("<i", len(sb)) + sb
    if value is None:
        return bytes([_F_NULL]) + kb
    if isinstance(value, dict):
        return bytes([_F_DOC]) + kb + encode(value)
    if isinstance(value, (list, tuple)):
        doc = {str(i): v for i, v in enumerate(value)}
        return bytes([_F_ARRAY]) + kb + encode(doc)
    raise TypeError(f"unsupported BSON value type: {type(value)} for key {key}")


def encode(doc: dict) -> bytes:
    body = b"".join(_encode_value(k, v) for k, v in doc.items())
    return struct.pack("<i", len(body) + 5) + body + b"\x00"


def _decode_cstring(buf: bytes, pos: int) -> tuple[str, int]:
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode(), end + 1


def _decode_doc(buf: bytes, pos: int) -> tuple[dict, int]:
    (length,) = struct.unpack_from("<i", buf, pos)
    end = pos + length
    pos += 4
    out: dict = {}
    while pos < end - 1:
        tag = buf[pos]
        pos += 1
        key, pos = _decode_cstring(buf, pos)
        if tag == _F_DOUBLE:
            (out[key],) = struct.unpack_from("<d", buf, pos)
            pos += 8
        elif tag == _F_STRING:
            (slen,) = struct.unpack_from("<i", buf, pos)
            pos += 4
            out[key] = buf[pos : pos + slen - 1].decode()
            pos += slen
        elif tag in (_F_DOC, _F_ARRAY):
            sub, pos = _decode_doc(buf, pos)
            if tag == _F_ARRAY:
                out[key] = [sub[str(i)] for i in range(len(sub))]
            else:
                out[key] = sub
        elif tag == _F_BINARY:
            (blen,) = struct.unpack_from("<i", buf, pos)
            pos += 5  # length + subtype byte
            out[key] = Binary(buf[pos : pos + blen])
            pos += blen
        elif tag == _F_BOOL:
            out[key] = buf[pos] != 0
            pos += 1
        elif tag == _F_NULL:
            out[key] = None
        elif tag == _F_INT32:
            (out[key],) = struct.unpack_from("<i", buf, pos)
            pos += 4
        elif tag == _F_INT64:
            (out[key],) = struct.unpack_from("<q", buf, pos)
            pos += 8
        else:
            raise ValueError(f"unsupported BSON tag 0x{tag:02x} at {pos}")
    return out, end


def decode(buf: bytes) -> dict:
    doc, _ = _decode_doc(buf, 0)
    return doc
