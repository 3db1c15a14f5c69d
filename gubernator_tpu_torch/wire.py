"""Columnar wire path: native protobuf parse/build for the serving edge.

The port of `gubernator_tpu/wire.py`. It loads the port's own copy of
the wire code (`csrc/wirepath.cc`, built with g++ by `ops/_build.py` at
first use) and exposes:

- parse_requests(data) -> RequestColumns | None: one pass over a
  GetRateLimitsReq's bytes into numpy columns + concatenated
  `name + "_" + unique_key` key bytes. None means the payload is
  malformed.
- build_responses(status, limit, remaining, reset_time) -> bytes: a
  GetRateLimitsResp built straight from response columns.
- encode_responses(resps): the same message from RateLimitResp objects
  (the object path's answers, which carry `error` strings), in plain
  Python. The JAX package serializes those with protobuf, which the
  card's machine does not have; the bytes are the same (proto3: zero
  fields omitted, fields in number order).
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np

from gubernator_tpu_torch.api.types import RateLimitReq
from gubernator_tpu_torch.ops import _build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """The wire library, built first if needed (raises if it cannot be
    built)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = _build.load("wirepath")
        lib.guber_count_requests.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ]
        lib.guber_count_requests.restype = ctypes.c_int
        lib.guber_parse_requests.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int64),   # hits
            np.ctypeslib.ndpointer(np.int64),   # limit
            np.ctypeslib.ndpointer(np.int64),   # duration
            np.ctypeslib.ndpointer(np.int32),   # algo
            np.ctypeslib.ndpointer(np.int64),   # behavior
            np.ctypeslib.ndpointer(np.int64),   # burst
            np.ctypeslib.ndpointer(np.int64),   # created_at
            np.ctypeslib.ndpointer(np.uint8),   # has_created
            np.ctypeslib.ndpointer(np.uint8),   # slow
            np.ctypeslib.ndpointer(np.int64),   # name_lens
            np.ctypeslib.ndpointer(np.uint8),   # key_data
            np.ctypeslib.ndpointer(np.int64),   # key_offsets
        ]
        lib.guber_parse_requests.restype = ctypes.c_int
        lib.guber_build_responses.argtypes = [
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.int8),
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.uint8),
        ]
        lib.guber_build_responses.restype = ctypes.c_int64
        lib.guber_responses_size.argtypes = [ctypes.c_int]
        lib.guber_responses_size.restype = ctypes.c_int64
        _lib = lib
        return lib


def available() -> bool:
    """Whether the wire library builds and loads here."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


@dataclasses.dataclass
class RequestColumns:
    """Columnar view of a GetRateLimitsReq."""

    n: int
    hits: np.ndarray  # int64
    limit: np.ndarray  # int64
    duration: np.ndarray  # int64
    algo: np.ndarray  # int32
    behavior: np.ndarray  # int64
    burst: np.ndarray  # int64
    created_at: np.ndarray  # int64
    has_created: np.ndarray  # uint8
    slow: np.ndarray  # uint8 (metadata present, or a name/key not UTF-8)
    name_lens: np.ndarray  # int64 (for vectorized validation)
    key_data: np.ndarray  # uint8, concatenated hash keys
    key_offsets: np.ndarray  # int64, n+1

    def key_string(self, i: int) -> str:
        lo, hi = int(self.key_offsets[i]), int(self.key_offsets[i + 1])
        return bytes(self.key_data[lo:hi]).decode("utf-8", errors="replace")

    def key_strings_all(self) -> list:
        """All key strings in one pass (one bytes materialization, then
        plain bytes slicing)."""
        raw = self.key_data.tobytes()
        offs = self.key_offsets.tolist()
        return [
            raw[offs[i]: offs[i + 1]].decode("utf-8", errors="replace")
            for i in range(self.n)
        ]

    def name_key_parts(self, i: int, errors: str = "replace") -> tuple:
        """(name, unique_key) for item i, split at the BYTE level.

        name_lens counts BYTES (wirepath.cc); slicing the decoded string
        by it would mis-split multi-byte UTF-8 names, so split the raw
        bytes first, then decode each part (`errors="strict"` raises
        UnicodeDecodeError on bytes a protobuf parser refuses)."""
        lo, hi = int(self.key_offsets[i]), int(self.key_offsets[i + 1])
        raw = bytes(self.key_data[lo:hi])
        nl = int(self.name_lens[i])
        return (
            raw[:nl].decode("utf-8", errors=errors),
            raw[nl + 1:].decode("utf-8", errors=errors),
        )


def req_from_columns(cols: RequestColumns, i: int) -> RateLimitReq:
    """RateLimitReq object for one lane: the one builder for every
    consumer that needs objects from wire columns. Field semantics match
    the protobuf object path (the item's metadata map is not parsed)."""
    name, unique_key = cols.name_key_parts(i)
    created = int(cols.created_at[i])
    return RateLimitReq(
        name=name,
        unique_key=unique_key,
        algorithm=int(cols.algo[i]),
        behavior=int(cols.behavior[i]),
        hits=int(cols.hits[i]),
        limit=int(cols.limit[i]),
        duration=int(cols.duration[i]),
        burst=int(cols.burst[i]),
        created_at=created if cols.has_created[i] and created != 0 else None,
    )


def parse_requests(data: bytes) -> Optional[RequestColumns]:
    lib = load()
    kb = ctypes.c_int64()
    n = lib.guber_count_requests(data, len(data), ctypes.byref(kb))
    if n < 0:
        return None
    if n == 0:
        z64 = np.empty(0, dtype=np.int64)
        return RequestColumns(
            0, z64, z64, z64, np.empty(0, np.int32), z64, z64, z64,
            np.empty(0, np.uint8), np.empty(0, np.uint8), z64,
            np.empty(0, np.uint8), np.zeros(1, np.int64),
        )
    hits = np.empty(n, np.int64)
    limit = np.empty(n, np.int64)
    duration = np.empty(n, np.int64)
    algo = np.empty(n, np.int32)
    behavior = np.empty(n, np.int64)
    burst = np.empty(n, np.int64)
    created = np.empty(n, np.int64)
    has_created = np.empty(n, np.uint8)
    slow = np.empty(n, np.uint8)
    name_lens = np.empty(n, np.int64)
    key_data = np.empty(max(int(kb.value), 1), np.uint8)
    key_offsets = np.empty(n + 1, np.int64)
    got = lib.guber_parse_requests(
        data, len(data), hits, limit, duration, algo, behavior, burst,
        created, has_created, slow, name_lens, key_data, key_offsets,
    )
    if got != n:
        return None
    return RequestColumns(
        n, hits, limit, duration, algo, behavior, burst, created,
        has_created, slow, name_lens, key_data, key_offsets,
    )


class _Walk:
    """Reads protobuf wire fields the way protobuf's decoder does, for
    `metadata_ok`: a varint of at most ten bytes, tags with field
    numbers in 1..2^29-1, lengths and fixed widths inside the buffer.
    Every fault raises ValueError."""

    __slots__ = ("buf", "p", "end")

    def __init__(self, buf: bytes, p: int, end: int):
        self.buf, self.p, self.end = buf, p, end

    def varint(self) -> int:
        v = shift = 0
        while self.p < self.end and shift < 64:
            b = self.buf[self.p]
            self.p += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
        raise ValueError("truncated or overlong varint")

    def tag(self):
        t = self.varint()
        field, wt = t >> 3, t & 7
        if field == 0 or field > 536870911:
            raise ValueError("field number out of range")
        return field, wt

    def take(self, n: int) -> int:
        """Skip n bytes; returns where they start."""
        if n > self.end - self.p:
            raise ValueError("field runs past its message")
        start = self.p
        self.p += n
        return start

    def skip(self, field: int, wt: int) -> None:
        """Skip one unknown field's value (a group up to its end tag)."""
        if wt == 0:
            self.varint()
        elif wt == 1:
            self.take(8)
        elif wt == 2:
            self.take(self.varint())
        elif wt == 5:
            self.take(4)
        elif wt == 3:
            while True:
                f, w = self.tag()
                if w == 4:
                    if f != field:
                        raise ValueError("mismatched end group")
                    return
                self.skip(f, w)
        else:
            raise ValueError(f"wire type {wt}")


def _check_map_entry(buf: bytes, p: int, end: int) -> None:
    """One map<string, string> entry (a message: key = 1, value = 2),
    decoded as protobuf decodes it: string fields must be UTF-8, other
    fields and wire types are skipped as unknown fields."""
    m = _Walk(buf, p, end)
    while m.p < m.end:
        field, wt = m.tag()
        if field in (1, 2) and wt == 2:
            n = m.varint()
            start = m.take(n)
            buf[start:start + n].decode("utf-8")  # UnicodeDecodeError is a ValueError
        elif wt == 4:
            raise ValueError("end group outside a group")
        else:
            m.skip(field, wt)


def metadata_ok(data: bytes) -> bool:
    """Whether protobuf would decode every item's `metadata` (field 9, a
    map<string, string>) of a GetRateLimitsReq that `parse_requests`
    accepted: each length-delimited field 9 must hold a well-formed map
    entry with UTF-8 key and value. The native parse skips field 9 (it
    only flags the item `slow`), so the object path calls this, in plain
    Python, on calls that have a `slow` item."""
    try:
        r = _Walk(data, 0, len(data))
        while r.p < r.end:
            field, wt = r.tag()
            if field != 1 or wt != 2:
                r.skip(field, wt)
                continue
            n = r.varint()
            item = _Walk(data, r.take(n), r.p)
            while item.p < item.end:
                f, w = item.tag()
                if f == 9 and w == 2:
                    ln = item.varint()
                    _check_map_entry(data, item.take(ln), item.p)
                else:
                    item.skip(f, w)
    except ValueError:
        return False
    return True


def build_responses(status, limit, remaining, reset_time) -> bytes:
    lib = load()
    n = len(status)
    out = np.empty(int(lib.guber_responses_size(n)), np.uint8)
    written = lib.guber_build_responses(
        n,
        np.ascontiguousarray(status, dtype=np.int8),
        np.ascontiguousarray(limit, dtype=np.int64),
        np.ascontiguousarray(remaining, dtype=np.int64),
        np.ascontiguousarray(reset_time, dtype=np.int64),
        out,
    )
    return out[:written].tobytes()


# ---- the object path's answers, without protobuf -------------------------


def varint(v: int) -> bytes:
    """Protobuf varint of an int64 field's value (negative values as
    their 64-bit two's complement, ten bytes)."""
    v &= (1 << 64) - 1
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _len_field(tag: int, payload: bytes) -> bytes:
    return bytes([tag]) + varint(len(payload)) + payload


def response_body(r) -> bytes:
    """One RateLimitResp message (status 1, limit 2, remaining 3,
    reset_time 4, error 5, metadata 6), proto3 zero values omitted, as
    protobuf's SerializeToString gives it. Metadata (the answers of
    `stage_metadata`) is a map<string, string>: one entry (key 1,
    value 2) per item, in sorted key order, which is protobuf's
    deterministic order (its default order is its hash table's, so
    bytes with metadata equal protobuf's decoded, not byte for byte). A
    key or value that is not a str is refused, as protobuf refuses it."""
    out = bytearray()
    for tag, v in ((0x08, int(r.status)), (0x10, int(r.limit)),
                   (0x18, int(r.remaining)), (0x20, int(r.reset_time))):
        if v:
            out.append(tag)
            out += varint(v)
    if r.error:
        out += _len_field(0x2A, r.error.encode("utf-8"))
    for k in sorted(r.metadata or ()):
        v = r.metadata[k]
        if not isinstance(k, str) or not isinstance(v, str):
            raise ValueError(f"response metadata must map str to str: {k!r}: {v!r}")
        out += _len_field(0x32, _len_field(0x0A, k.encode("utf-8"))
                          + _len_field(0x12, v.encode("utf-8")))
    return bytes(out)


def framed_response(r) -> bytes:
    """One `responses` entry of a GetRateLimitsResp (field 1, length-
    delimited): entries frame independently, so native-built runs and
    these concatenate into one valid message."""
    body = response_body(r)
    return b"\x0a" + varint(len(body)) + body


def encode_responses(resps: Sequence) -> bytes:
    """A GetRateLimitsResp of RateLimitResp objects."""
    return b"".join(framed_response(r) for r in resps)
